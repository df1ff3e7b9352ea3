"""Training: loss, optimizer, train state and checkpoints, the executors
(``EXECUTORS``, registered on import)."""

from .customized_executor import CustomizedSaLExecutor
from .latr_executor import LaTrExecutor
from .phoneme_executor import PhonemeSaLExecutor
from .sal_executor import SaLExecutor

__all__ = ["CustomizedSaLExecutor", "LaTrExecutor", "PhonemeSaLExecutor", "SaLExecutor"]
