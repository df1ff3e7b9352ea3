"""Training: loss, optimizer, train state and checkpoints, the executors
(``EXECUTORS``, registered on import)."""

from .latr_executor import LaTrExecutor

__all__ = ["LaTrExecutor"]
