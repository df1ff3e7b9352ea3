"""SaL executor (counterpart of ``phoneme_vqa_tpu/train/sal_executor.py``):
question + OCR-with-features + object-with-features streams, the ``<c>``
context token added to the backbone tokenizer when it can take one, and the
2D position bias model. The OCR and object stores are adapted from the
feature directories with scale 1 (boxes stay in [0, 1]).
"""

from __future__ import annotations

from ..data.adapters import textlayout_obj_adapt, textlayout_ocr_adapt
from ..data.sal import SaLDataset
from ..tokenizers.backbone import load_backbone_tokenizer
from ..utils.registry import EXECUTORS
from .base_executor import BaseExecutor
from .latr_executor import LaTrExecutor


@EXECUTORS.register("SaL_Executor")
class SaLExecutor(LaTrExecutor):
    REQUIRED_TRAIN_KEYS = BaseExecutor.REQUIRED_TRAIN_KEYS + (
        "base_ocr_feature_path", "base_obj_feature_path", "context_token",
        "max_ocr_element", "max_ocr_length", "max_obj_element",
        "max_obj_length", "backbone_name",
    )

    def _create_tokenizers(self):
        self.tokenizer = load_backbone_tokenizer(
            self.config.backbone_name, vocab_size=self.config.get("t5_vocab_size", 36096))
        if hasattr(self.tokenizer, "add_tokens"):  # the offline tokenizer has none
            self.tokenizer.add_tokens([self.config.context_token])

    def _new_vocab_size(self) -> int:
        return len(self.tokenizer)

    def _build_model_config(self, cfg_builder):
        return cfg_builder.build(self.config, self._new_vocab_size())

    def _make_dataset(self, qa_rows, ocr_store, obj_store):
        c = self.config
        return SaLDataset(
            qa_rows, ocr_store, obj_store, self.tokenizer, c.base_ocr_feature_path,
            c.base_obj_feature_path, ocr_hidden=c.ocr_hidden, obj_hidden=c.obj_hidden,
            max_ocr_element=c.max_ocr_element, max_ocr_length=c.max_ocr_length,
            max_obj_element=c.max_obj_element, max_obj_length=c.max_obj_length,
            max_input_length=c.max_q_length, max_output_length=c.max_a_length,
            context_token=c.context_token, answer_encoder=self._answer_encoder(),
            **self._feature_cache_args(),
        ).dataset

    def _adapt_frames(self):
        cache_dir = self.config.get("FEATURE_CACHE") or None
        return (textlayout_ocr_adapt(self.config.base_ocr_feature_path, 1, 1, cache_dir),
                textlayout_obj_adapt(self.config.base_obj_feature_path, 1, 1, cache_dir))
