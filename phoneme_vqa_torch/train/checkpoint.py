"""Checkpoint manager: last/best checkpoints with auto-resume (counterpart of
``phoneme_vqa_tpu/train/checkpoint.py``, the same contract):

* ``{SAVE_PATH}/last_ckp`` saved every epoch, ``best_ckp`` on metric
  improvement;
* contents ``{params (the f32 masters), opt_state, step, epoch,
  step_in_epoch, best_score}`` (+ ``ema_params``, ``lora_scale``);
* train auto-resumes from ``last_ckp`` (then ``best_ckp``) if present;
* eval/predict load ``{evaltype|predicttype}_ckp`` with a ``./models``
  fallback and a hard error otherwise.

A checkpoint is one ``torch.save`` file, written to a temporary path and
renamed into place, so a reader never sees a partial one. A LoRA run's
``params`` is ``{"base", "lora"}`` with ``lora_scale``; an EMA run adds
``ema_params``; a ``SAVE_EVERY_STEPS`` save tags its ``step_in_epoch``. The
JAX package's orbax directories are refused: reading one needs
tensorstore, which the card machine lacks.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..utils.logger import get_logger

log = get_logger(__name__)


class CheckpointManager:
    def __init__(self, save_path: Optional[str]):
        self.save_path = os.path.abspath(save_path or "./models")
        os.makedirs(self.save_path, exist_ok=True)

    def _path(self, name: str, root: Optional[str] = None) -> str:
        return os.path.join(root or self.save_path, f"{name}_ckp")

    def save(self, name: str, tree: dict) -> None:
        path = self._path(name)
        tmp = path + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path)
        log.info(f"!---------Saved {name}_ckp----------!")

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    def mtime(self, name: str) -> Optional[float]:
        """The modification time of ``name``'s checkpoint in ``SAVE_PATH``,
        or None (``serve.py --reload-every`` polls it)."""
        path = self._path(name)
        return os.path.getmtime(path) if os.path.exists(path) else None

    def restore(self, name: str, device=None) -> dict:
        """The saved dict, tensors on ``device``; from ``SAVE_PATH`` or else
        ``./models``. FileNotFoundError when neither holds one."""
        for root in (self.save_path, "./models"):
            path = self._path(name, root)
            if os.path.isdir(path):
                raise ValueError(f"{path} is a directory (an orbax checkpoint of the JAX "
                                 f"package?): reading one needs tensorstore, which the card "
                                 f"machine lacks, so it is refused (ROADMAP C); convert a "
                                 f"reference .pth with python -m "
                                 f"phoneme_vqa_torch.import_reference_ckpt")
            if os.path.isfile(path):
                restored = torch.load(path, map_location=device, weights_only=True)
                log.info(f"###Loaded {name}_ckp from {path}")
                return restored
        raise FileNotFoundError(f"(!) {name}_ckp is required (!)")
