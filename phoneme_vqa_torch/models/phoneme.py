"""Phoneme decoding models (counterpart of ``phoneme_vqa_tpu/models/phoneme.py``).

* PhonemeSaL — a FLAT phoneme stream over the SaL encoder: the
  CustomizedSaL model with the closed flat phoneme vocabulary
  (``tokenizers/phoneme_flat.py``, 253 ids), whose ids the executor puts in
  its config. Like the JAX package it keeps the custom decoder's scaled
  token embedding.

The triple-stream PhonemeLaTr / PhonemePreSTU (``PhonemeTripleDecoder``)
are not ported yet.
"""

from __future__ import annotations

from ..utils.registry import MODELS
from .customized import CustomizedSaL


@MODELS.register("PhonemeSaL")
class PhonemeSaL(CustomizedSaL):
    """Flat phoneme stream over the SaL encoder; config
    ``CustomizedSaL_config``."""
