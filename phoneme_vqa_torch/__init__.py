"""phoneme_vqa_torch — the PyTorch / CUDA port of ``phoneme_vqa_tpu`` for NVIDIA Hopper.

It keeps the JAX package's module layout and names and imports nothing from
it (nor JAX). Its kernels are hand-written CUDA C++ for ``sm_90a``
(``csrc/flash_attention.cu``, ``csrc/sal_fused_attention.cu``), built with
``nvcc`` at first use (``ops/_build.py``). Serving is ``serving/``;
training, evaluation and prediction are the executors of ``train/`` and the
CLI ``python -m phoneme_vqa_torch.run``.
"""

__version__ = "0.1.0"
