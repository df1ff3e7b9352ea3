"""The CUDA SaL-bias attention kernel against its plain PyTorch version, on
the card.

Every test here needs a CUDA card; each skips inside the ``cuda`` fixture
when there is none. The card machine has no JAX, so run these without the
repo's conftest (which imports JAX):

    python -m pytest tests/test_torch_sal_fused_attention_gpu.py --noconftest -q
"""

import itertools

import numpy as np
import pytest
import torch

from phoneme_vqa_torch.ops import flash_attention as fa
from phoneme_vqa_torch.ops import sal_fused_attention as sfa
from phoneme_vqa_torch.ops.attention import dot_product_attention

pytestmark = pytest.mark.gpu

# f32: the kernel sums q·k and P·v in another order than cuBLAS; rounding is
# ~1e-6 relative and the softmax's exp scales it by the logit size. bf16: the
# kernel's output is rounded to bf16 (2^-8 relative), compared with the f32
# plain result on the same inputs.
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, h, l, d, dtype, table_dtype, device, seed=0, all_sentinel=False):
    """q, k, v, bias1d, cell_bias, cell, key mask. The cells hold a question
    block and a tail of sentinels, cells 0 and 120, and one id past the
    sentinel; the mask a masked tail (row 1) and a fully masked row (last)."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    q, k, v = (t(rng.randn(b, h, l, d)).to(dtype) for _ in range(3))
    bias1d = t(rng.randn(h, l, l) * 0.5).to(table_dtype)
    cb = np.zeros((h, 122, 122), np.float32)
    cb[:, :121, :121] = rng.randn(h, 121, 121) * 0.3
    cell = rng.randint(0, 121, (b, l)).astype(np.int32)
    n_q = min(5, l // 3)
    cell[:, :n_q] = sfa.SENTINEL
    cell[:, l - max(1, l // 8):] = sfa.SENTINEL
    cell[0, n_q], cell[0, n_q + 1] = 0, 120
    if b > 1:
        cell[1, n_q] = 300  # read as the sentinel
    if all_sentinel:
        cell[:] = sfa.SENTINEL
    mask = np.ones((b, l), np.int32)
    if b > 1:
        mask[1, (3 * l) // 4:] = 0
    mask[-1] = 0
    to = lambda a: torch.from_numpy(a).to(device)
    return q, k, v, bias1d, t(cb).to(table_dtype), to(cell), to(mask)


def _compare(q, k, v, bias1d, cb, cell, mask):
    got = sfa.sal_fused_attention(q, k, v, bias1d, cb, cell, mask)
    torch.cuda.synchronize()
    want = sfa.sal_reference_attention(q.float(), k.float(), v.float(), bias1d, cb, cell, mask)
    tol = TOL[q.dtype]
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
    return float((got.float() - want).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [8, 16, 37, 131, 197, 327, 336, 512])
@pytest.mark.parametrize("d", [64, 32, 128])
def test_kernel_matches_plain_over_options(cuda, dtype, length, d):
    for table_dtype, use_mask, all_sentinel in itertools.product(
        (torch.float32, torch.bfloat16), (True, False), (False, True)
    ):
        q, k, v, bias1d, cb, cell, mask = _inputs(3, 3, length, d, dtype, table_dtype, cuda,
                                                  all_sentinel=all_sentinel)
        _compare(q, k, v, bias1d, cb, cell, mask if use_mask else None)


def test_kernel_at_the_serving_shape(cuda):
    args = _inputs(32, 12, 336, 64, torch.bfloat16, torch.bfloat16, cuda, seed=1)
    _compare(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_strided_views_equal_contiguous_bit_for_bit(cuda, dtype, table_dtype, d):
    q, k, v, bias1d, cb, cell, mask = _inputs(2, 3, 131, d, dtype, table_dtype, cuda, seed=3)
    want = sfa.sal_fused_attention(q, k, v, bias1d, cb, cell, mask)
    qv, kv, vv = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    assert not qv.is_contiguous()
    got = sfa.sal_fused_attention(qv, kv, vv, bias1d, cb, cell, mask)
    torch.cuda.synchronize()
    assert got.stride() == want.stride()  # (B, L, H, D) storage either way
    assert torch.equal(got, want)
    # through the dispatch, as the model calls it
    fused = sfa.FusedSalBias(bias1d, cb, cell)
    assert torch.equal(dot_product_attention(qv, kv, vv, fused, key_mask=mask.bool()), want)


def test_dispatch_launches_the_sal_kernel_for_a_fused_bias(cuda):
    q, k, v, bias1d, cb, cell, mask = _inputs(2, 2, 40, 64, torch.float32, torch.float32, cuda)
    fused = sfa.FusedSalBias(bias1d, cb, cell)
    before = (sfa.LAUNCHES, fa.LAUNCHES)
    got = dot_product_attention(q, k, v, fused, key_mask=mask.bool())
    assert (sfa.LAUNCHES, fa.LAUNCHES) == (before[0] + 1, before[1])
    want = sfa.sal_reference_attention(q, k, v, bias1d, cb, cell, mask)
    torch.testing.assert_close(got, want, atol=TOL[q.dtype], rtol=TOL[q.dtype])
    dot_product_attention(q, k, v, fused)  # no key mask: all ones
    assert sfa.LAUNCHES == before[0] + 2
    # a causal call materializes the bias and takes the fused kernel instead
    dot_product_attention(q, k, v, fused, key_mask=mask.bool(), causal=True)
    assert (sfa.LAUNCHES, fa.LAUNCHES) == (before[0] + 2, before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_under_grad_runs_the_sal_function_with_a_recompute_backward(cuda, dtype):
    """With grad on, a fused bias goes through ``SalAttentionFn``: one
    kernel launch, and dq, dk, dv, dbias1d and dcell_bias equal to the
    plain path's (the backward is that recompute)."""
    q, k, v, bias1d, cb, cell, mask = _inputs(2, 3, 131, 64, dtype, dtype, cuda, seed=4)
    mask[-1] = 1
    leaves = [t.detach().requires_grad_() for t in (q, k, v, bias1d, cb)]
    w = torch.randn(2, 3, 131, 64, device=cuda)
    before = sfa.LAUNCHES
    out = dot_product_attention(*leaves[:3], sfa.FusedSalBias(leaves[3], leaves[4], cell),
                                key_mask=mask.bool())
    assert sfa.LAUNCHES == before + 1
    assert type(out.grad_fn).__name__ == "SalAttentionFnBackward"
    got = torch.autograd.grad((out.float() * w).sum(), leaves)
    want_out = sfa.sal_reference_attention(*leaves, cell, mask)
    want = torch.autograd.grad((want_out.float() * w).sum(), leaves)
    torch.testing.assert_close(out.float(), want_out.float(), atol=TOL[dtype], rtol=TOL[dtype])
    for g, ref in zip(got, want):
        assert g.abs().max() > 0
        torch.testing.assert_close(g, ref, atol=0, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v, bias1d, cb, cell, mask = _inputs(1, 2, 32, 64, torch.float32, torch.float32, cuda)
    run = lambda **kw: sfa.sal_fused_attention(
        *(kw.get(n, x) for n, x in zip(
            ("q", "k", "v", "bias1d", "cb", "cell", "mask"), (q, k, v, bias1d, cb, cell, mask))))
    for bad in (
        dict(q=q.half(), k=k.half(), v=v.half()),
        dict(k=k[:, :, :31].contiguous()),  # Lq != Lk
        dict(bias1d=bias1d[:, :31, :31].contiguous()),
        dict(cb=cb.to(torch.bfloat16)),  # the two tables in two types
        dict(cb=torch.zeros(2, 130, 130, device=cuda)),  # C > 128
        dict(cell=cell.long()),
        dict(mask=mask.bool()),
        dict(q=q[..., :60].contiguous(), k=k[..., :60].contiguous(), v=v[..., :60].contiguous()),
    ):
        with pytest.raises(ValueError):
            run(**bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sal_function_at_the_training_shape(cuda, dtype):
    """The SaL encoder of a SaL-family train step (B=16, H=12, L=336, D=64,
    tables in the compute type) through ``SalAttentionFn``: gradients equal
    to the plain path's."""
    q, k, v, bias1d, cb, cell, mask = _inputs(16, 12, 336, 64, dtype, dtype, cuda, seed=5)
    mask[-1] = 1
    leaves = [t.detach().requires_grad_() for t in (q, k, v, bias1d, cb)]
    w = torch.randn(16, 12, 336, 64, device=cuda)
    before = sfa.LAUNCHES
    out = sfa.SalAttentionFn.apply(*leaves, cell, mask)
    assert sfa.LAUNCHES == before + 1
    got = torch.autograd.grad((out.float() * w).sum(), leaves)
    want_out = sfa.sal_reference_attention(*leaves, cell, mask)
    want = torch.autograd.grad((want_out.float() * w).sum(), leaves)
    torch.testing.assert_close(out.float(), want_out.float(), atol=TOL[dtype], rtol=TOL[dtype])
    for g, ref in zip(got, want):
        assert g.abs().max() > 0
        torch.testing.assert_close(g, ref, atol=0, rtol=0)


def test_sal_fused_off_materializes_for_the_attention_kernel(cuda):
    """With ``SAL_FUSED`` off a fused bias is materialized and the attention
    kernel takes it; the result is the SaL kernel's within tolerance."""
    from phoneme_vqa_torch.ops import attention as attn

    q, k, v, bias1d, cb, cell, mask = _inputs(2, 3, 131, 64, torch.float32, torch.float32, cuda)
    fused = sfa.FusedSalBias(bias1d, cb, cell)
    want = dot_product_attention(q, k, v, fused, key_mask=mask.bool())
    saved = attn.sal_fused_enabled()
    attn.enable_sal_fused(False)
    try:
        before = (sfa.LAUNCHES, fa.LAUNCHES)
        got = dot_product_attention(q, k, v, fused, key_mask=mask.bool())
        assert (sfa.LAUNCHES, fa.LAUNCHES) == (before[0], before[1] + 1)
    finally:
        attn.enable_sal_fused(saved)
    torch.testing.assert_close(got, want, atol=TOL[q.dtype], rtol=TOL[q.dtype])
