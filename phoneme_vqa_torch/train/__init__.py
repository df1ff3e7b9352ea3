"""Training: loss, optimizer, train state and checkpoints, the executors
(``EXECUTORS``, registered on import)."""

from .customized_executor import (
    CustomizedLaTrExecutor,
    CustomizedPreSTUExecutor,
    CustomizedSaLExecutor,
)
from .latr_executor import LaTrExecutor
from .phoneme_executor import PhonemeLaTrExecutor, PhonemePreSTUExecutor, PhonemeSaLExecutor
from .prestu_executor import PreSTUExecutor
from .sal_executor import SaLExecutor

__all__ = [
    "CustomizedLaTrExecutor", "CustomizedPreSTUExecutor", "CustomizedSaLExecutor",
    "LaTrExecutor", "PhonemeLaTrExecutor", "PhonemePreSTUExecutor", "PhonemeSaLExecutor",
    "PreSTUExecutor", "SaLExecutor",
]
