"""SaL encoder attention with the 2D position bias fused in: a hand-written
CUDA kernel for Hopper.

Counterpart of ``phoneme_vqa_tpu/ops/sal_fused_attention.py``. The SaL
encoder injects ``bias = rel1d[buckets_1d] + scp[buckets_scp]`` into every
layer's attention. Materialized it is a ``(B, H, L, L)`` f32 tensor (173 MB
at SaL-base, B=32) that all 12 encoder layers read. The model carries it in
factored form instead (:class:`FusedSalBias`):

* ``bias1d`` (H, L, L): the batch-independent 1D sequence bias;
* ``cell_bias`` (H, C, C): the SCP bias between the 121 grid cells, with a
  zero sentinel row and column (C = 122);
* ``cell`` (B, L) int32: each token's grid cell, ``SENTINEL`` outside the
  OCR block.

:func:`sal_fused_attention` launches ``csrc/sal_fused_attention.cu`` (built
with ``nvcc`` at first use, ``ops/_build.py``; bound with ``ctypes``), which
rebuilds the bias inside its tiles, for CUDA tensors and raises on anything
it does not take; for CPU tensors it computes the plain version,
:func:`sal_reference_attention`. q, k and v are read in place by strides
(``ops/layout.py``) and the output is written as (B, L, H, D) storage,
returned as its (B, H, L, D) view. ``LAUNCHES`` counts kernel launches.
:class:`SalAttentionFn` puts the kernel under autograd with a backward that
recomputes the plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build
from .attention import recompute_grads, reference_attention
from .layout import empty_output, kernel_operand

NAME = "sal_fused_attention"
SOURCE = _build.source(NAME)

GRID_CELLS = 121  # 11 x 11
SENTINEL = GRID_CELLS  # the cell id of a token outside the OCR block
MAX_CELLS = 128  # the widest cell table the kernel takes

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)
_lib = None


class _CellPairGather(torch.autograd.Function):
    """``cell_bias[:, cell_q, cell_k]`` as (B, H, L, L) f32, differentiable
    in ``cell_bias`` by one-hot products: dcell_bias[h] = sum over the batch
    of onehot(cell)ᵀ · g[b, h] · onehot(cell), the same sums as the
    gather's own backward in another order. That backward is an
    accumulating scatter of B·H·L·L values into H·C·C slots, most of them
    into the one sentinel pair: on an H100 it took 68 ms a SaL-base encoder
    layer at B=16 (PERF.md), the product a fraction of a millisecond."""

    @staticmethod
    def forward(ctx, cell_bias, cell):  # cell: int64 in [0, C)
        ctx.save_for_backward(cell)
        ctx.table = (cell_bias.shape[-1], cell_bias.dtype)
        return cell_bias[:, cell[:, :, None], cell[:, None, :]].transpose(0, 1).float()

    @staticmethod
    def backward(ctx, g):
        (cell,) = ctx.saved_tensors
        c, dtype = ctx.table
        onehot = torch.nn.functional.one_hot(cell, c).to(g.dtype)[:, None]  # (B, 1, L, C)
        per_item = torch.matmul(torch.matmul(onehot.transpose(-1, -2), g), onehot)
        return per_item.sum(0).to(dtype), None


def materialize_sal_bias(bias1d, cell_bias, cell) -> torch.Tensor:
    """(B, H, L, L) f32 = bias1d + cell_bias[:, cell_q, cell_k]; cell ids
    above C - 1 read the sentinel row and column."""
    cell = cell.long().clamp(max=cell_bias.shape[-1] - 1)
    return bias1d.float()[None] + _CellPairGather.apply(cell_bias, cell).contiguous()


class FusedSalBias(NamedTuple):
    """The SaL 2D position bias in factored form: the kernel's input
    contract. ``ops.attention.dot_product_attention`` hands it to the kernel
    on the card and materializes it everywhere else."""

    bias1d: torch.Tensor  # (H, L, L) batch-independent 1D sequence bias
    cell_bias: torch.Tensor  # (H, C, C) SCP bias in grid-cell space
    cell: torch.Tensor  # (B, L) int32 grid cell per token; SENTINEL = none

    def materialize(self) -> torch.Tensor:
        return materialize_sal_bias(self.bias1d, self.cell_bias, self.cell)


def sal_reference_attention(q, k, v, bias1d, cell_bias, cell, key_mask) -> torch.Tensor:
    """The kernel's plain version: materialize the bias, then
    ``reference_attention``."""
    bias = materialize_sal_bias(bias1d, cell_bias, cell)
    return reference_attention(q, k, v, bias=bias, key_mask=key_mask)


class SalAttentionFn(torch.autograd.Function):
    """The SaL kernel's forward, a plain recompute backward: ``backward``
    recomputes :func:`sal_reference_attention` (the bias materialized) on
    detached copies and returns dq, dk, dv, dbias1d and dcell_bias, None for
    the cells and the mask. Counterpart of
    ``phoneme_vqa_tpu/ops/sal_fused_attention.py: sal_attention`` / ``_fwd`` /
    ``_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, bias1d, cell_bias, cell, key_mask):
        ctx.save_for_backward(q, k, v, bias1d, cell_bias, cell, key_mask)
        return sal_fused_attention(q, k, v, bias1d, cell_bias, cell, key_mask, any_layout=True)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias1d, cell_bias, cell, key_mask = ctx.saved_tensors
        grads = recompute_grads(
            lambda q_, k_, v_, b_, cb_: sal_reference_attention(q_, k_, v_, b_, cb_, cell,
                                                                key_mask),
            (q, k, v, bias1d, cell_bias), ctx.needs_input_grad[:5], g,
        )
        return (*grads, None, None)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build.build(NAME)[0])
        fn = lib.sal_fused_attention_fwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # bias1d, cell_bias, cell
            ctypes.c_void_p, ctypes.c_void_p,  # mask, out
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H L D C
            ctypes.POINTER(ctypes.c_longlong),  # strides: q, k, v, out (b, h, l), bias1d (h, l)
            ctypes.c_int, ctypes.c_int,  # is_bf16, table_is_bf16
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q, k, v, bias1d, cell_bias, cell, key_mask, any_layout):
    """Raises ValueError on what the kernel does not take; returns (tensor,
    outer strides) of q, k and v, each a copy where ``any_layout`` lets one
    be made of a layout the kernel does not take."""
    def fail(msg):
        raise ValueError(f"sal_fused_attention: {msg}")

    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        fail("q, k, v must lie on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        fail(f"q, k, v must share f32 or bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        fail(f"q, k, v must share one shape (B, H, L, D), got {tuple(q.shape)}, "
             f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, l, d = q.shape
    if d % 8 != 0 or d > 128:
        fail(f"head dim {d} must be a multiple of 8, at most 128")
    qkv = [kernel_operand(t, None if any_layout else f"sal_fused_attention: {name}")
           for name, t in (("q", q), ("k", k), ("v", v))]
    for name, t in (("bias1d", bias1d), ("cell_bias", cell_bias)):
        if t.device != q.device or t.dtype not in (torch.float32, torch.bfloat16):
            fail(f"{name} must be f32 or bf16 on {q.device}, got {t.dtype}")
    if not cell_bias.is_contiguous():
        fail("cell_bias must be contiguous")
    if cell_bias.dtype != bias1d.dtype:
        fail(f"bias1d ({bias1d.dtype}) and cell_bias ({cell_bias.dtype}) must share a type")
    if tuple(bias1d.shape) != (h, l, l):
        fail(f"bias1d must be ({h}, {l}, {l}), got {tuple(bias1d.shape)}")
    c = cell_bias.shape[-1]
    if cell_bias.dim() != 3 or tuple(cell_bias.shape) != (h, c, c) or not 0 < c <= MAX_CELLS:
        fail(f"cell_bias must be ({h}, C, C) with C <= {MAX_CELLS}, got {tuple(cell_bias.shape)}")
    for name, t in (("cell", cell), ("key_mask", key_mask)):
        if t is not None and (t.device != q.device or t.dtype != torch.int32
                              or not t.is_contiguous() or tuple(t.shape) != (b, l)):
            fail(f"{name} must be contiguous int32 ({b}, {l}) on {q.device}")
    return qkv


def sal_fused_attention(
    q: torch.Tensor,  # (B, H, L, D)
    k: torch.Tensor,  # (B, H, L, D)
    v: torch.Tensor,  # (B, H, L, D)
    bias1d: torch.Tensor,  # (H, L, L) f32 or bf16
    cell_bias: torch.Tensor,  # (H, C, C), C <= 128, bias1d's type
    cell: torch.Tensor,  # (B, L) int32 in [0, C); larger ids read the sentinel
    key_mask: Optional[torch.Tensor],  # (B, L) int32, nonzero = attend; None = all
    any_layout: bool = False,
) -> torch.Tensor:
    """softmax(q·kᵀ + bias1d[h] + cell_bias[h][cell_q, cell_k], masked) · v,
    output in q's dtype.

    On the card q, k and v are (B, H, L, D) views the kernel takes in place
    (``ops.layout.kernel_operand``); it raises on others, or with
    ``any_layout`` copies them into a layout it takes. A bias1d whose rows
    are not 16-byte aligned is copied into padded rows first."""
    global LAUNCHES
    if q.device.type == "cpu":
        return sal_reference_attention(q, k, v, bias1d, cell_bias, cell, key_mask)
    (q, q_st), (k, k_st), (v, v_st) = _check(q, k, v, bias1d, cell_bias, cell, key_mask,
                                             any_layout)
    fn = _load().sal_fused_attention_fwd
    b, h, l, d = q.shape
    out, out_st = empty_output(q)
    bias1d, bias1d_st = kernel_operand(bias1d)
    strides = (ctypes.c_longlong * 14)(*q_st, *k_st, *v_st, *out_st, *bias1d_st)
    err = _build.call(
        fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias1d.data_ptr(),
        cell_bias.data_ptr(), cell.data_ptr(), None if key_mask is None else key_mask.data_ptr(),
        out.data_ptr(), b, h, l, d, cell_bias.shape[-1], strides,
        int(q.dtype == torch.bfloat16), int(bias1d.dtype == torch.bfloat16),
    )
    if err != 0:
        raise RuntimeError(f"sal_fused_attention kernel launch failed: {_build.describe(err)}")
    LAUNCHES += 1
    return out
