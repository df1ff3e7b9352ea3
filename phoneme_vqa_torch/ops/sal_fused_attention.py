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
:class:`SalAttentionFn` puts the kernel under autograd; its backward calls
:func:`sal_attention_backward`, which gives dq, dk, dv and the logits'
gradient that the tables' gradients sum: for bf16 q, k, v on the card from
the same source's backward kernels (``csrc/attention_bwd.cuh``, counted in
``BACKWARD_LAUNCHES``), for other calls by the plain recompute
(``RECOMPUTE_FALLBACKS``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build
from .attention import backward_kernel_takes, reference_attention, reference_attention_backward
from .layout import empty_output, kernel_operand

NAME = "sal_fused_attention"
SOURCE = _build.source(NAME)

GRID_CELLS = 121  # 11 x 11
SENTINEL = GRID_CELLS  # the cell id of a token outside the OCR block
MAX_CELLS = 128  # the widest cell table the kernel takes

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)
BACKWARD_LAUNCHES = 0  # sal_attention_backward calls on the card (two kernel launches each)
RECOMPUTE_FALLBACKS = 0  # sal_attention_backward calls that took the plain recompute
_lib = None


def cell_pair_sums(g: torch.Tensor, cell: torch.Tensor, c: int) -> torch.Tensor:
    """(H, C, C) f32: the (B, H, L, L) ``g`` summed into each head's (cell_q,
    cell_k) pairs, cell ids above C - 1 read as the sentinel C - 1:
    onehot(cell)ᵀ · g[b, h] · onehot(cell) summed over the batch, the
    gradient of ``cell_bias[:, cell_q, cell_k]``."""
    onehot = torch.nn.functional.one_hot(cell.long().clamp(max=c - 1), c).to(g.dtype)[:, None]
    return torch.matmul(torch.matmul(onehot.transpose(-1, -2), g), onehot).sum(0)


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
        return cell_pair_sums(g, cell, c).to(dtype), None


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


def sal_reference_attention_backward(q, k, v, g, bias1d, cell_bias, cell, key_mask,
                                     want_ds=False):
    """The SaL backward kernels' plain version: (dq, dk, dv, dS) of
    :func:`sal_reference_attention` by autograd, dS the gradient of the
    logits (B, H, L, L) f32 when ``want_ds`` (else None)."""
    bias = materialize_sal_bias(bias1d.detach(), cell_bias.detach(), cell)
    return reference_attention_backward(q, k, v, g, bias, key_mask, want_ds=want_ds)


class SalAttentionFn(torch.autograd.Function):
    """The SaL kernel under autograd: ``backward`` calls
    :func:`sal_attention_backward` (the backward kernels for bf16 q, k, v on
    the card, else the plain recompute) and returns dq, dk, dv and the
    tables' gradients from the logits' gradient dS (dbias1d: dS summed over
    the batch; dcell_bias: dS summed into its cell pairs,
    :func:`cell_pair_sums`), each only where it is needed, and None for the
    cells and the mask. Counterpart of
    ``phoneme_vqa_tpu/ops/sal_fused_attention.py: sal_attention`` / ``_fwd`` /
    ``_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, bias1d, cell_bias, cell, key_mask):
        out = sal_fused_attention(q, k, v, bias1d, cell_bias, cell, key_mask, any_layout=True)
        ctx.save_for_backward(q, k, v, bias1d, cell_bias, cell, key_mask, out)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias1d, cell_bias, cell, key_mask, out = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        dq, dk, dv, ds = sal_attention_backward(q, k, v, out, g, bias1d, cell_bias, cell,
                                                key_mask, want_ds=needs[3] or needs[4])
        dbias1d = ds.sum(0).to(bias1d.dtype) if needs[3] else None
        dcell = (cell_pair_sums(ds, cell, cell_bias.shape[-1]).to(cell_bias.dtype)
                 if needs[4] else None)
        return (*(x if n else None for x, n in zip((dq, dk, dv), needs)), dbias1d, dcell,
                None, None)


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
        bwd = lib.sal_fused_attention_bwd
        bwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
            ctypes.c_void_p, ctypes.c_void_p,  # out, g
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # bias1d, cell_bias, cell
            ctypes.c_void_p,  # mask
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dq, dk, dv
            ctypes.c_void_p, ctypes.c_void_p,  # stats, ds
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H L D C
            ctypes.POINTER(ctypes.c_longlong),  # strides: q k v out g dq dk dv (b, h, l), bias1d (h, l)
            ctypes.c_int,  # table_is_bf16
            ctypes.c_void_p,  # stream
        ]
        bwd.restype = ctypes.c_int
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


def sal_attention_backward(
    q: torch.Tensor,  # (B, H, L, D)
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,  # the forward's output
    g: torch.Tensor,  # the gradient of out
    bias1d: torch.Tensor,  # (H, L, L) f32 or bf16
    cell_bias: torch.Tensor,  # (H, C, C), bias1d's type
    cell: torch.Tensor,  # (B, L) int32
    key_mask: Optional[torch.Tensor],  # (B, L) int32 or None
    want_ds: bool = False,
):
    """(dq, dk, dv, dS) of :func:`sal_fused_attention`'s call: dq, dk, dv in
    q's dtype as (B, H, L, D) views of (B, L, H, D) storage, and with
    ``want_ds`` the gradient of the logits (B, H, L, L) f32, zero where a key
    is masked (else None), from which the tables' gradients are summed.

    For bf16 q, k, v on the card it launches the backward kernels, reading
    every operand in place where its layout allows (else a copy); any other
    call (CPU or f32 tensors) computes the plain version,
    :func:`sal_reference_attention_backward`, counted in
    ``RECOMPUTE_FALLBACKS``."""
    global BACKWARD_LAUNCHES, RECOMPUTE_FALLBACKS
    if out.shape != q.shape or g.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"sal_attention_backward: out ({out.dtype} {tuple(out.shape)}) and g "
                         f"({tuple(g.shape)}) must have q's shape and out q's dtype")
    if not backward_kernel_takes(q):
        RECOMPUTE_FALLBACKS += 1
        return sal_reference_attention_backward(q, k, v, g, bias1d, cell_bias, cell, key_mask,
                                                want_ds)
    (q, q_st), (k, k_st), (v, v_st) = _check(q, k, v, bias1d, cell_bias, cell, key_mask, True)
    (out, o_st), (g, g_st) = kernel_operand(out), kernel_operand(g.to(q.dtype))
    fn = _load().sal_fused_attention_bwd
    b, h, l, d = q.shape
    (dq, dq_st), (dk, dk_st), (dv, dv_st) = empty_output(q), empty_output(k), empty_output(v)
    stats = torch.empty(b, h, l, 4, dtype=torch.float32, device=q.device)
    ds = torch.empty(b, h, l, l, dtype=torch.float32, device=q.device) if want_ds else None
    bias1d, bias1d_st = kernel_operand(bias1d)
    strides = (ctypes.c_longlong * 26)(*q_st, *k_st, *v_st, *o_st, *g_st, *dq_st, *dk_st,
                                       *dv_st, *bias1d_st)
    err = _build.call(
        fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
        bias1d.data_ptr(), cell_bias.data_ptr(), cell.data_ptr(),
        None if key_mask is None else key_mask.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        None if ds is None else ds.data_ptr(), b, h, l, d, cell_bias.shape[-1], strides,
        int(bias1d.dtype == torch.bfloat16),
    )
    if err != 0:
        raise RuntimeError(f"sal_fused_attention backward launch failed: {_build.describe(err)}")
    BACKWARD_LAUNCHES += 1
    return dq, dk, dv, ds
