"""PreSTU executor (counterpart of ``phoneme_vqa_tpu/train/prestu_executor.py``):
the LaTr executor over a PreSTU-family model, whose class names its inputs
(no coordinate or OCR tensors) and its dataset (the question and OCR fused
into one token stream, ``data/prestu.py``). The PreSTU model's ViT trains
(``PreSTU_config``), so ``BaseExecutor._freeze_predicate`` gives every ViT
parameter optimizer state; the customized and phoneme PreSTU executors
freeze it.
"""

from __future__ import annotations

from ..models import prestu  # noqa: F401  (registers PreSTU and PreSTU_config)
from ..utils.registry import EXECUTORS
from .latr_executor import LaTrExecutor


@EXECUTORS.register("PreSTU_Executor")
class PreSTUExecutor(LaTrExecutor):
    pass
