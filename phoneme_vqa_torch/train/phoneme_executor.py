"""The phoneme-decoding executors (counterpart of
``phoneme_vqa_tpu/train/phoneme_executor.py``).

* PhonemeLaTr / PhonemePreSTU: structured (onset, rhyme, tone) triple
  streams through :class:`~phoneme_vqa_torch.tokenizers.phoneme_structured.StructuredPhonemeTokenizer`,
  whose vocabulary is loaded from ``vocab_path`` or built from
  ``annotation_paths``. Answers are encoded as (T, 3) triples with a mask of
  onset != pad; the loss sums three cross-entropies over ``labels[:, 1:,
  c]``; decoding is the multi-head greedy loop, stopped by the onset's EOS,
  or the multi-head beam search (``isgreedy: false``, ``num_beam`` > 1),
  and the (B, T, 3) rows are recomposed into Vietnamese words. The model
  config is a ``PhonemeLaTrConfig`` with a frozen ViT, built from the
  YAML's ``MODEL_MOD_CONFIG_CLASS`` backbone. Encoder-freeze epochs and the
  LinearLR warmup are the customized executors'.
* PhonemeSaL: the CustomizedSaL executor with the closed-vocabulary flat
  :class:`~phoneme_vqa_torch.tokenizers.phoneme_flat.PhonemeTokenizer`.
  Answers go through ``preprocess_sentence`` before they are encoded, and
  decoded rows are recomposed into Vietnamese syllables with their
  diacritics.
"""

from __future__ import annotations

from ..models.phoneme import PhonemeLaTrConfig, phoneme_decoder_from_yaml  # registers the models
from ..phonology.compose import preprocess_sentence
from ..tokenizers.phoneme_flat import PhonemeTokenizer
from ..tokenizers.phoneme_structured import StructuredPhonemeTokenizer
from ..utils.registry import EXECUTORS
from .customized_executor import CustomizedSaLExecutor, _CustomizedMixin
from .latr_executor import LaTrExecutor
from .optim import cross_entropy_loss
from .prestu_executor import PreSTUExecutor


class _PhonemeTripleExecMixin(_CustomizedMixin):
    """Structured triple-stream plumbing: tokenizer, 3-way loss, decode."""

    def _prepare_decode_tokenizer(self, train_rows=None, val_rows=None):
        self.decode_tokenizer = StructuredPhonemeTokenizer(
            vocab_path=self.config.get("vocab_path"),
            annotation_paths=list(self.config.get("annotation_paths", []) or []),
        )

    def _answer_encoder(self):
        tok = self.decode_tokenizer

        def encode(answer: str, max_length: int):
            triples = tok.encode(answer, max_length)
            return triples, [int(t[0] != tok.pad_id) for t in triples]

        return encode

    def _build_model_config(self, cfg_builder):
        tok = self.decode_tokenizer
        base = cfg_builder.build(self.config)
        return PhonemeLaTrConfig(
            t5=base.t5,
            vit=base.vit,
            max_2d_position_embeddings=base.max_2d_position_embeddings,
            freeze_vit=True,
            phoneme_decoder=phoneme_decoder_from_yaml(
                self.config, base.t5, onset_vocab=tok.onset_size, rhyme_vocab=tok.rhyme_size,
                tone_vocab=tok.tone_size, pad_id=tok.pad_id, bos_id=tok.bos_id,
                eos_id=tok.eos_id,
            ),
        )

    def _loss_from_batch(self, batch):
        """The sum of the onset, rhyme and tone cross-entropies of a device
        batch: (B, T, 3) labels, ``labels[:, :-1]`` in, ``labels[:, 1:, c]``
        scored by head c."""
        labels = batch["label_ids"]
        mask = batch["label_attention_mask"]
        heads = self.model(self._model_batch(batch), labels[:, :-1, :], mask[:, :-1])
        pad, smoothing = self.decode_tokenizer.pad_id, self._label_smoothing()
        return sum(cross_entropy_loss(logits, labels[:, 1:, c], pad, label_smoothing=smoothing)
                   for c, logits in enumerate(heads))


@EXECUTORS.register("PhonemeLaTr_Executor")
class PhonemeLaTrExecutor(_PhonemeTripleExecMixin, LaTrExecutor):
    pass


@EXECUTORS.register("PhonemePreSTU_Executor")
class PhonemePreSTUExecutor(_PhonemeTripleExecMixin, PreSTUExecutor):
    pass


@EXECUTORS.register("PhonemeSaL_Executor")
class PhonemeSaLExecutor(CustomizedSaLExecutor):
    """Flat phoneme stream over the SaL encoder."""

    def _prepare_decode_tokenizer(self, train_rows=None, val_rows=None):
        self.decode_tokenizer = PhonemeTokenizer()

    def _answer_encoder(self):
        tok = self.decode_tokenizer

        def encode(answer: str, max_length: int):
            ids = tok.encode(preprocess_sentence(answer), max_length)
            return ids, [int(i != tok.pad_idx) for i in ids]

        return encode
