"""The kernels' layout contract, on the CPU.

The card's kernels read q, k, v in place by strides, so the models hand them
(B, H, L, D) views of (B, L, H, D) storage without a copy. Here: the plain
path gives the same for such views as for contiguous copies over every
option, and ``ops.layout`` takes or refuses the layouts the kernels do.
"""

import itertools

import numpy as np
import pytest
import torch

from phoneme_vqa_torch.ops import layout
from phoneme_vqa_torch.ops import sal_fused_attention as sfa
from phoneme_vqa_torch.ops.attention import dot_product_attention

ATOL = RTOL = 1e-6  # f32 on the CPU; a view only changes the order of reads


def _model_views(*xs):
    """(B, H, L, D) views of (B, L, H, D) storage, as ``T5Attention._split``
    and the ViT ``split`` give them."""
    return tuple(x.transpose(1, 2).contiguous().transpose(1, 2) for x in xs)


def _inputs(b, h, lq, lk, d, seed=0):
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    q, k, v, bias = t(b, h, lq, d), t(b, h, lk, d), t(b, h, lk, d), t(b, h, lq, lk)
    mask = torch.from_numpy(rng.rand(b, lk) > 0.3)
    mask[0, 0] = True
    mask[-1] = False  # a row that attends nowhere
    return q, k, v, bias, mask


OPTIONS = list(itertools.product(("none", "one", "batch"), (False, True), (False, True),
                                 (None, 0.5)))


@pytest.mark.parametrize("bias_kind,use_mask,causal,scale", OPTIONS)
def test_attention_on_model_views_equals_contiguous(bias_kind, use_mask, causal, scale):
    q, k, v, bias, mask = _inputs(2, 3, 17, 17, 16)
    bias = {"none": None, "one": bias[:1], "batch": bias}[bias_kind]
    mask = mask if use_mask else None
    views = _model_views(q, k, v)
    assert not views[0].is_contiguous()
    want = dot_product_attention(q, k, v, bias, mask, causal, scale)
    got = dot_product_attention(*views, bias, mask, causal, scale)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_sal_attention_on_model_views_equals_contiguous(use_mask, table_dtype):
    rng = np.random.RandomState(1)
    q, k, v, _, mask = _inputs(2, 3, 21, 21, 16, seed=1)
    bias1d = torch.from_numpy(rng.randn(3, 21, 21).astype(np.float32)).to(table_dtype)
    cb = torch.from_numpy(rng.randn(3, 122, 122).astype(np.float32)).to(table_dtype)
    cell = torch.from_numpy(rng.randint(0, 125, (2, 21)).astype(np.int32))
    mask = mask.to(torch.int32) if use_mask else None
    views = _model_views(q, k, v)
    want = sfa.sal_fused_attention(q, k, v, bias1d, cb, cell, mask)
    got = sfa.sal_fused_attention(*views, bias1d, cb, cell, mask)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    fused = sfa.FusedSalBias(bias1d, cb, cell)
    key_mask = None if mask is None else mask.bool()
    torch.testing.assert_close(dot_product_attention(*views, fused, key_mask), want,
                               atol=ATOL, rtol=RTOL)


def _storage(n, dtype=torch.bfloat16):
    return torch.zeros(n, dtype=dtype)


@pytest.mark.parametrize("name,make", [
    ("contiguous", lambda: torch.zeros(2, 12, 37, 64, dtype=torch.bfloat16)),
    ("model view", lambda: torch.zeros(2, 37, 12, 64, dtype=torch.bfloat16).transpose(1, 2)),
    ("head dim 8", lambda: torch.zeros(2, 3, 5, 8, dtype=torch.bfloat16)),
    ("f32 head dim 4", lambda: torch.zeros(2, 3, 5, 4)),
    ("padded rows", lambda: torch.zeros(2, 3, 5, 72, dtype=torch.bfloat16)[..., :64]),
    ("odd stride, extent 1", lambda: _storage(3 * 5 * 64 + 8)[8:].view(1, 3, 5, 64)),
])
def test_layout_taken(name, make):
    t = make()
    got, strides = layout.kernel_operand(t, "kernel: x")  # does not raise
    assert got is t, name
    assert layout.kernel_operand(t) == (t, strides)
    assert len(strides) == t.dim() - 1
    assert all(s == (0 if n == 1 else st)
               for s, n, st in zip(strides, t.shape, t.stride()))


@pytest.mark.parametrize("name,make", [
    ("start 2 bytes past 16", lambda: _storage(2 * 3 * 5 * 64 + 1)[1:].view(2, 3, 5, 64)),
    ("row of 60 bf16", lambda: torch.zeros(2, 3, 5, 60, dtype=torch.bfloat16)),
    ("f32 rows of 327", lambda: torch.zeros(1, 2, 327, 327)),
    ("stride 2 along D", lambda: torch.zeros(2, 3, 5, 128, dtype=torch.bfloat16)[..., ::2]),
    ("broadcast heads", lambda: torch.zeros(2, 1, 5, 64, dtype=torch.bfloat16).expand(2, 3, 5, 64)),
])
def test_layout_refused_and_aligned_copy_taken(name, make):
    t = make()
    with pytest.raises(ValueError, match="kernel: x"):
        layout.kernel_operand(t, "kernel: x")
    copy, strides = layout.kernel_operand(t)
    assert copy is not t, name
    assert layout.kernel_operand(copy, "kernel: x") == (copy, strides)
    assert copy.shape == t.shape and torch.equal(copy, t)


@pytest.mark.parametrize("length", [8, 37, 327])
def test_t5_relative_bias_is_taken_in_place(length):
    """The T5 stacks' relative bias (1, H, L, L) f32 is built with 16-byte
    rows, so no layer copies it (at L = 327 a packed row is 1308 bytes)."""
    from phoneme_vqa_torch.models.t5 import RelativeBias, T5Config
    from phoneme_vqa_torch.ops.rel_bias import relative_position_bucket

    rel = RelativeBias(T5Config(num_heads=3), bidirectional=True)
    with torch.no_grad():
        bias = rel(length, length)
        pos = torch.arange(length)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None], True, 32, 128)
        want = rel.rel_embedding(buckets).permute(2, 0, 1)[None].contiguous()
    assert bias.shape == want.shape and bias.dtype == torch.float32
    assert layout.kernel_operand(bias, "bias")[0] is bias
    torch.testing.assert_close(bias, want, atol=0, rtol=0)


def test_output_is_model_layout_storage():
    q = torch.zeros(2, 12, 37, 64, dtype=torch.bfloat16)
    out, strides = layout.empty_output(q)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.transpose(1, 2).is_contiguous()  # the models' merge reshapes it for free
    assert layout.kernel_operand(out, "out") == (out, strides)
    assert layout.empty_output(q[:1, :, :1])[1] == (0, 64, 0)  # extent 1: never stepped
