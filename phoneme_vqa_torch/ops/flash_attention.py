"""Fused attention forward: a hand-written CUDA kernel for Hopper.

Replaces ``phoneme_vqa_tpu/ops/flash_attention.py: fused_attention`` (the
Pallas kernel). The source, with its bound and design, is
``csrc/flash_attention.cu``; it is compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface at first use (``ops/_build.py``,
keyed by a hash of the source), and bound with ``ctypes``.

:func:`fused_attention` launches the kernel for CUDA tensors and raises on
anything it does not take; for CPU tensors it computes the plain version,
``ops.attention.reference_attention``. q, k and v are read in place by
strides (``ops/layout.py``) and the output is written as (B, L, H, D)
storage, returned as its (B, H, L, D) view. ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .attention import reference_attention
from .layout import empty_output, kernel_operand

NAME = "flash_attention"
SOURCE = _build.source(NAME)

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build.build(NAME)[0])
        fn = lib.flash_attention_fwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # bias, mask, out
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H Lq Lk D
            ctypes.POINTER(ctypes.c_longlong),  # strides: q, k, v, out, bias, each (b, h, l)
            ctypes.c_int,  # bias batch
            ctypes.c_int, ctypes.c_float, ctypes.c_int,  # causal, scale, is_bf16
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q, k, v, bias, key_mask, any_layout):
    """Raises ValueError on what the kernel does not take; returns (tensor,
    outer strides) of q, k and v, each a copy where ``any_layout`` lets one
    be made of a layout the kernel does not take."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("fused_attention: q, k, v must lie on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"fused_attention: q, k, v must share f32 or bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("fused_attention: q (B,H,Lq,D), k and v (B,H,Lk,D) expected")
    b, h, lq, d = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f"fused_attention: q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if d % 8 != 0 or d > 128:
        raise ValueError(f"fused_attention: head dim {d} must be a multiple of 8, at most 128")
    qkv = [kernel_operand(t, None if any_layout else f"fused_attention: {name}")
           for name, t in (("q", q), ("k", k), ("v", v))]
    lk = k.shape[2]
    if bias is not None:
        if (bias.device != q.device or bias.dtype != torch.float32
                or bias.dim() != 4 or bias.shape[0] not in (1, b)
                or tuple(bias.shape[1:]) != (h, lq, lk)):
            raise ValueError(f"fused_attention: bias must be f32 (1|{b}, {h}, {lq}, "
                             f"{lk}) on {q.device}, got {bias.dtype} {tuple(bias.shape)}")
    if key_mask is not None:
        if (key_mask.device != q.device or key_mask.dtype != torch.int32
                or not key_mask.is_contiguous() or tuple(key_mask.shape) != (b, lk)):
            raise ValueError(f"fused_attention: key_mask must be contiguous int32 ({b}, {lk})")
    return qkv


def fused_attention(
    q: torch.Tensor,  # (B, H, Lq, D)
    k: torch.Tensor,  # (B, H, Lk, D)
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,  # (B|1, H, Lq, Lk) f32
    key_mask: Optional[torch.Tensor] = None,  # (B, Lk) int32, nonzero = attend
    causal: bool = False,
    scale: Optional[float] = None,  # None = no scaling
    any_layout: bool = False,
) -> torch.Tensor:
    """softmax(scale·q·kᵀ + bias, masked) · v, output in q's dtype.

    On the card q, k and v are (B, H, L, D) views the kernel takes in place
    (``ops.layout.kernel_operand``); it raises on others, or with
    ``any_layout`` copies them into a layout it takes. A bias whose rows are
    not 16-byte aligned is copied into padded rows first."""
    global LAUNCHES
    if q.device.type == "cpu":
        return reference_attention(q, k, v, bias, key_mask, causal, scale)
    (q, q_st), (k, k_st), (v, v_st) = _check(q, k, v, bias, key_mask, any_layout)
    fn = _load().flash_attention_fwd
    b, h, lq, d = q.shape
    lk = k.shape[2]
    out, out_st = empty_output(q)
    bias_st = (0, 0, 0)
    if bias is not None:
        bias, bias_st = kernel_operand(bias)
    strides = (ctypes.c_longlong * 15)(*q_st, *k_st, *v_st, *out_st, *bias_st)
    err = _build.call(
        fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if key_mask is None else key_mask.data_ptr(),
        out.data_ptr(), b, h, lq, lk, d, strides,
        1 if bias is None else bias.shape[0], int(causal),
        1.0 if scale is None else float(scale), int(q.dtype == torch.bfloat16),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: {_build.describe(err)}")
    LAUNCHES += 1
    return out
