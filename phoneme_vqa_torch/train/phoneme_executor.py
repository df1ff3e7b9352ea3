"""The PhonemeSaL executor (counterpart of
``phoneme_vqa_tpu/train/phoneme_executor.py: PhonemeSaLExecutor``; the
triple-stream PhonemeLaTr / PhonemePreSTU executors are not ported yet): the
CustomizedSaL executor with the closed-vocabulary flat
:class:`~phoneme_vqa_torch.tokenizers.phoneme_flat.PhonemeTokenizer`.
Answers go through ``preprocess_sentence`` before they are encoded, and
decoded rows are recomposed into Vietnamese syllables with their
diacritics.
"""

from __future__ import annotations

from ..models import phoneme  # noqa: F401  (registers the model)
from ..phonology.compose import preprocess_sentence
from ..tokenizers.phoneme_flat import PhonemeTokenizer
from ..utils.registry import EXECUTORS
from .customized_executor import CustomizedSaLExecutor


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
