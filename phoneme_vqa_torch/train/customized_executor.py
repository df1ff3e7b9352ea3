"""The Customized{LaTr, PreSTU, SaL} executors (counterpart of
``phoneme_vqa_tpu/train/customized_executor.py``): a pluggable answer
tokenizer, the custom decoder head, a LinearLR warmup and encoder-freeze
epochs.

* ``DecodeTokenizer`` names the answer tokenizer (``TOKENIZERS``); a BPE
  tokenizer is trained on the train + val answers and saved to
  ``vocab_save_path`` (loaded from there when the file exists);
* answers are encoded by it, the loss ignores its pad id, and decoded rows
  are detokenized by it;
* the LR ramps linearly from LR/3 to LR over ``warmup_step`` steps;
* ``NUM_FREEZE_EPOCH``: in the first N epochs the ``t5`` subtree's
  gradients are multiplied by 0, as the JAX executor does. It is a gradient
  scale, not a mask: the optimizer still counts the step, decays the
  moments and applies decoupled weight decay to those parameters, so the
  optimizer state follows optax's;
* decode: greedy, or beam search with ``isgreedy: false`` and ``num_beam``
  > 1 (over triples for the phoneme triple decoder). As in the JAX package
  these executors decode by that choice alone: ``SAMPLE`` and
  ``SPEC_DECODE`` do not reach them.
"""

from __future__ import annotations

from typing import List

from .. import tokenizers  # noqa: F401  (registers the answer tokenizers)
from ..models import customized  # noqa: F401  (registers the model and its config)
from ..models.generate import build_generate_fn
from ..serving.engine import decode_answer_rows
from ..utils.logger import get_logger
from ..utils.registry import EXECUTORS, TOKENIZERS
from .latr_executor import LaTrExecutor
from .optim import linear_warmup_schedule
from .prestu_executor import PreSTUExecutor
from .sal_executor import SaLExecutor

log = get_logger(__name__)


class _CustomizedMixin:
    """Answer-tokenizer plumbing and freeze-aware training."""

    FREEZE_SUBTREES = ("t5",)
    _encoder_grad_scale = 1.0

    # -- answer tokenizer --------------------------------------------------------

    def _prepare_decode_tokenizer(self, train_rows, val_rows):
        name = self.config.DecodeTokenizer
        cls = TOKENIZERS.get(name)
        if "BPE" in name:
            corpus = [str(r["answer"]) for r in train_rows] + [str(r["answer"]) for r in val_rows]
            self.decode_tokenizer = cls(
                data=corpus,
                step=self.config.get("bpe_step", 1000),
                save_path=self.config.get("vocab_save_path", "bpevocab.json"),
                max_vocab_size=self.config.get("max_vocab_size", 5000),
            )
        else:
            self.decode_tokenizer = cls()

    def _answer_encoder(self):
        tok = self.decode_tokenizer

        def encode(answer: str, max_length: int):
            ids = list(tok(answer, max_length=max_length, padding=True))[:max_length]
            ids = ids + [tok.pad_id] * (max_length - len(ids))
            return ids, [int(i != tok.pad_id) for i in ids]

        return encode

    def _loss_pad_id(self) -> int:
        return self.decode_tokenizer.pad_id

    def _build_generate_fn(self, max_length: int, with_scores: bool = False):
        """Greedy with ``isgreedy`` (default) or ``num_beam`` <= 1, else beam
        search with ``num_beam`` hypotheses."""
        c = self.config
        greedy = c.get("isgreedy", True) or int(c.get("num_beam", 1) or 1) <= 1
        return build_generate_fn(self.model, max_length, with_scores,
                                 num_beams=1 if greedy else int(c.num_beam))

    def _decoder_ids(self) -> dict:
        """The answer vocabulary's size and ids, as the config builders take
        them."""
        tok = self.decode_tokenizer
        return dict(tgt_vocab_size=len(tok), pad_id=tok.pad_id, bos_id=tok.bos_id,
                    eos_id=tok.eos_id)

    def _build_model_config(self, cfg_builder):
        return cfg_builder.build(self.config, **self._decoder_ids())

    def _decode_rows(self, rows) -> List[str]:
        return decode_answer_rows(self.decode_tokenizer, rows)

    # -- training: warmup schedule and encoder freeze --------------------------------

    def _default_schedule(self, steps_per_epoch: int):
        return linear_warmup_schedule(self.config.LR, self.config.get("warmup_step", 1000))

    def _train_epoch(self, epoch: int) -> float:
        frozen = epoch <= self.config.get("NUM_FREEZE_EPOCH", 0)
        self._encoder_grad_scale = 0.0 if frozen else 1.0
        if frozen:
            log.info(f"Epoch {epoch}: encoder frozen")
        try:
            return super()._train_epoch(epoch)
        finally:
            self._encoder_grad_scale = 1.0

    def apply_gradients(self) -> None:
        scale = self._encoder_grad_scale
        if scale != 1.0:
            for name, p in self.model.named_parameters():
                if p.grad is not None and name.split(".", 1)[0] in self.FREEZE_SUBTREES:
                    p.grad.mul_(scale)
        super().apply_gradients()


@EXECUTORS.register("CustomizedLaTr_Executor")
class CustomizedLaTrExecutor(_CustomizedMixin, LaTrExecutor):
    pass


@EXECUTORS.register("CustomizedPreSTU_Executor")
class CustomizedPreSTUExecutor(_CustomizedMixin, PreSTUExecutor):
    pass


@EXECUTORS.register("CustomizedSaL_Executor")
class CustomizedSaLExecutor(_CustomizedMixin, SaLExecutor):
    def _build_model_config(self, cfg_builder):
        """The SaL builder also takes the backbone tokenizer's length (the
        ``<c>`` context token added)."""
        return cfg_builder.build(self.config, **self._decoder_ids(),
                                 new_token_embedding_size=self._new_vocab_size())
