"""phoneme_vqa_torch — the PyTorch / CUDA port of ``phoneme_vqa_tpu`` for NVIDIA Hopper.

It keeps the JAX package's module layout and names and imports nothing from
it (nor JAX). Its attention kernel is hand-written CUDA C++ for ``sm_90a``
(``csrc/flash_attention.cu``), built with ``nvcc`` at first use.
"""

__version__ = "0.1.0"
