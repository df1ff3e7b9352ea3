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

:func:`attention_backward` launches the backward of the same source
(``csrc/attention_bwd.cuh``: two kernels, dq, then dk and dv) for bf16 CUDA
tensors, and recomputes the plain version for any other:
``FusedAttentionFn.backward`` calls it. ``BACKWARD_LAUNCHES`` counts its
calls on the kernels, ``RECOMPUTE_FALLBACKS`` those that took the plain
recompute (CPU or f32 tensors).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .attention import backward_kernel_takes, reference_attention, reference_attention_backward
from .layout import empty_output, kernel_operand

NAME = "flash_attention"
SOURCE = _build.source(NAME)

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)
BACKWARD_LAUNCHES = 0  # attention_backward calls on the card (two kernel launches each)
RECOMPUTE_FALLBACKS = 0  # attention_backward calls that took the plain recompute
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
        bwd = lib.flash_attention_bwd
        bwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
            ctypes.c_void_p, ctypes.c_void_p,  # out, g
            ctypes.c_void_p, ctypes.c_void_p,  # bias, mask
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dq, dk, dv
            ctypes.c_void_p, ctypes.c_void_p,  # stats, ds
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H Lq Lk D
            ctypes.POINTER(ctypes.c_longlong),  # strides: q k v out g dq dk dv bias, each (b, h, l)
            ctypes.c_int,  # bias batch
            ctypes.c_int, ctypes.c_float,  # causal, scale
            ctypes.c_void_p,  # stream
        ]
        bwd.restype = ctypes.c_int
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


def attention_backward(
    q: torch.Tensor,  # (B, H, Lq, D)
    k: torch.Tensor,  # (B, H, Lk, D)
    v: torch.Tensor,
    out: torch.Tensor,  # the forward's output
    g: torch.Tensor,  # the gradient of out
    bias: Optional[torch.Tensor] = None,  # (B|1, H, Lq, Lk) f32
    key_mask: Optional[torch.Tensor] = None,  # (B, Lk) int32, nonzero = attend
    causal: bool = False,
    scale: Optional[float] = None,
    want_ds: bool = False,
):
    """(dq, dk, dv, dS) of :func:`fused_attention`'s call: dq, dk, dv in q's
    dtype as (B, H, L, D) views of (B, L, H, D) storage, and with
    ``want_ds`` the gradient of the logits (B, H, Lq, Lk) f32, zero where a
    key is masked or causal (else None), which a bias's gradient sums.

    For bf16 tensors on the card it launches the backward kernels, reading
    every operand in place where its layout allows (else a copy, as the
    forward's ``any_layout``); any other call (CPU or f32 tensors) computes
    the plain version, :func:`ops.attention.reference_attention_backward`,
    counted in ``RECOMPUTE_FALLBACKS``."""
    global BACKWARD_LAUNCHES, RECOMPUTE_FALLBACKS
    if out.shape != q.shape or g.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"attention_backward: out ({out.dtype} {tuple(out.shape)}) and g "
                         f"({tuple(g.shape)}) must have q's shape and out q's dtype")
    if not backward_kernel_takes(q):
        RECOMPUTE_FALLBACKS += 1
        return reference_attention_backward(q, k, v, g, bias, key_mask, causal, scale, want_ds)
    (q, q_st), (k, k_st), (v, v_st) = _check(q, k, v, bias, key_mask, True)
    (out, o_st), (g, g_st) = kernel_operand(out), kernel_operand(g.to(q.dtype))
    fn = _load().flash_attention_bwd
    b, h, lq, d = q.shape
    lk = k.shape[2]
    (dq, dq_st), (dk, dk_st), (dv, dv_st) = empty_output(q), empty_output(k), empty_output(v)
    stats = torch.empty(b, h, lq, 4, dtype=torch.float32, device=q.device)
    ds = torch.empty(b, h, lq, lk, dtype=torch.float32, device=q.device) if want_ds else None
    bias_st = (0, 0, 0)
    if bias is not None:
        bias, bias_st = kernel_operand(bias)
    strides = (ctypes.c_longlong * 27)(*q_st, *k_st, *v_st, *o_st, *g_st, *dq_st, *dk_st,
                                       *dv_st, *bias_st)
    err = _build.call(
        fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if key_mask is None else key_mask.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        None if ds is None else ds.data_ptr(), b, h, lq, lk, d, strides,
        1 if bias is None else bias.shape[0], int(causal), 1.0 if scale is None else float(scale),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: {_build.describe(err)}")
    BACKWARD_LAUNCHES += 1
    return dq, dk, dv, ds
