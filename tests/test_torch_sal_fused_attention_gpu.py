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

from .test_torch_flash_attention_gpu import (
    DS_GAP,
    _grads,
    check_backward,
    ds_precision_gaps,
    live_positions,
)

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


def _through_the_dispatch(cell, mask):
    return lambda q_, k_, v_, b_, cb_: dot_product_attention(
        q_, k_, v_, sfa.FusedSalBias(b_, cb_, cell), key_mask=mask.bool())


def _plain(cell, mask):
    return lambda *a: sfa.sal_reference_attention(*a, cell, mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_under_grad_runs_the_sal_function_and_its_backward(cuda, dtype):
    """With grad on, a fused bias goes through ``SalAttentionFn``: one
    kernel launch. In bf16 its backward launches the backward kernels once
    (dq, dk, dv, dbias1d and dcell_bias within ``check_backward``'s bounds);
    in f32 it recomputes the plain version, counted as a fallback, and every
    gradient equals the plain path's."""
    q, k, v, bias1d, cb, cell, mask = _inputs(2, 3, 131, 64, dtype, dtype, cuda, seed=4)
    mask[-1] = 1
    tensors = [q, k, v, bias1d, cb]
    w = torch.randn(2, 3, 131, 64, device=cuda)
    before = (sfa.LAUNCHES, sfa.BACKWARD_LAUNCHES, sfa.RECOMPUTE_FALLBACKS)
    out, got = _grads(_through_the_dispatch(cell, mask), tensors, [True] * 5, w)
    bf16 = dtype == torch.bfloat16
    assert (sfa.LAUNCHES, sfa.BACKWARD_LAUNCHES, sfa.RECOMPUTE_FALLBACKS) == (
        before[0] + 1, before[1] + bf16, before[2] + (not bf16))
    assert type(out.grad_fn).__name__ == "SalAttentionFnBackward"
    want_out, want = _grads(_plain(cell, mask), tensors, [True] * 5, w)
    torch.testing.assert_close(out.float(), want_out.float(), atol=TOL[dtype], rtol=TOL[dtype])
    if bf16:
        check_backward(_through_the_dispatch(cell, mask), _plain(cell, mask), tensors,
                       [True] * 5, w)
        return
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
    tables in the compute type) through ``SalAttentionFn``: in f32 gradients
    equal to the plain path's (the recompute); in bf16 the backward kernels'
    within ``check_backward``'s bounds, the same bits twice."""
    q, k, v, bias1d, cb, cell, mask = _inputs(16, 12, 336, 64, dtype, dtype, cuda, seed=5)
    mask[-1] = 1
    tensors = [q, k, v, bias1d, cb]
    w = torch.randn(16, 12, 336, 64, device=cuda)
    fn = lambda *a: sfa.SalAttentionFn.apply(*a, cell, mask)
    before = sfa.LAUNCHES
    out, got = _grads(fn, tensors, [True] * 5, w)
    assert sfa.LAUNCHES == before + 1
    want_out, want = _grads(_plain(cell, mask), tensors, [True] * 5, w)
    torch.testing.assert_close(out.float(), want_out.float(), atol=TOL[dtype], rtol=TOL[dtype])
    if dtype == torch.bfloat16:
        check_backward(fn, _plain(cell, mask), tensors, [True] * 5, w)
        return
    for g, ref in zip(got, want):
        assert g.abs().max() > 0
        torch.testing.assert_close(g, ref, atol=0, rtol=0)


@pytest.mark.parametrize("d", [64, 48])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [12, 6, 3])
def test_sal_backward_kernels_on_model_views(cuda, d, table_dtype, heads):
    """The SaL encoder's backward in bf16 on (B, H, L, D) views of (B, L, 12,
    D) storage (the first ``heads``: a tensor-parallel rank's slice, with
    the tables' head slices): one backward call, no fallback, gradients
    within ``check_backward``'s bounds; sentinel cells, an id past the
    sentinel, a masked tail and a fully masked row (the last) included."""
    q, k, v, bias1d, cb, cell, mask = _inputs(4, 12, 336, d, torch.bfloat16, table_dtype, cuda,
                                              seed=9)
    q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)[:, :heads] for x in (q, k, v))
    tensors = [q, k, v, bias1d[:heads], cb[:heads].contiguous()]
    w = torch.randn(4, heads, 336, d, device=cuda)
    before = (sfa.BACKWARD_LAUNCHES, sfa.RECOMPUTE_FALLBACKS)
    got, _ = check_backward(_through_the_dispatch(cell, mask), _plain(cell, mask), tensors,
                            [True] * 5, w)
    assert (sfa.BACKWARD_LAUNCHES, sfa.RECOMPUTE_FALLBACKS) == (before[0] + 2, before[1])
    assert got[3].dtype == table_dtype and got[4].shape == (heads, 122, 122)
    assert got[4][:, -1].abs().max() > 0  # the sentinel row gathers every non-OCR token


def test_sal_backward_computes_only_the_gradients_asked_for(cuda):
    """Tables that need no gradient: no dS is written, dq, dk, dv are the
    same bits; only bias1d, or only cell_bias, asked for also agree."""
    q, k, v, bias1d, cb, cell, mask = _inputs(2, 12, 336, 64, torch.bfloat16, torch.bfloat16,
                                              cuda, seed=10)
    tensors = [q, k, v, bias1d, cb]
    w = torch.randn(2, 12, 336, 64, device=cuda)
    fn = _through_the_dispatch(cell, mask)
    _, full = _grads(fn, tensors, [True] * 5, w)
    _, qkv = _grads(fn, tensors, [True, True, True, False, False], w)
    for g, ref in zip(qkv, full):
        assert torch.equal(g, ref)
    _, (d1,) = _grads(fn, tensors, [False, False, False, True, False], w)
    _, (dc,) = _grads(fn, tensors, [False, False, False, False, True], w)
    assert torch.equal(d1, full[3]) and torch.equal(dc, full[4])


def test_sal_backward_under_remat(cuda):
    """REMAT recomputes the layer inside the backward: the gradients are the
    same bits as without it."""
    from torch.utils.checkpoint import checkpoint

    q, k, v, bias1d, cb, cell, mask = _inputs(2, 12, 336, 64, torch.bfloat16, torch.bfloat16,
                                              cuda, seed=11)
    tensors = [q, k, v, bias1d, cb]
    w = torch.randn(2, 12, 336, 64, device=cuda)
    fn = _through_the_dispatch(cell, mask)
    _, want = _grads(fn, tensors, [True] * 5, w)
    before = (sfa.LAUNCHES, sfa.BACKWARD_LAUNCHES)
    _, got = _grads(lambda *a: checkpoint(fn, *a, use_reentrant=False), tensors, [True] * 5, w)
    assert (sfa.LAUNCHES, sfa.BACKWARD_LAUNCHES) == (before[0] + 2, before[1] + 1)
    for g, ref in zip(got, want):
        assert torch.equal(g, ref)


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_sal_backward_products_keep_ds_at_f32_precision(cuda, table_dtype):
    """The SaL backward kernels' dq and dk at the encoder's training shape
    (B 4) lie within DS_GAP in norm of the f64 plain backward (on the
    materialized bias) rounded to bf16; dS rounded once to TF32 before the
    products would not."""
    q, k, v, bias1d, cb, cell, mask = _inputs(4, 12, 336, 64, torch.bfloat16, table_dtype, cuda,
                                              seed=12)
    out = sfa.sal_fused_attention(q, k, v, bias1d, cb, cell, mask)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(5),
                    device=cuda).bfloat16()
    dq, dk, _, _ = sfa.sal_attention_backward(q, k, v, out, g, bias1d, cb, cell, mask)
    live = live_positions(mask, 336, 336, False, cuda)
    got, tf32_cut, bf16_cut = ds_precision_gaps(
        (dq, dk), q, k, v, out, g, sfa.materialize_sal_bias(bias1d, cb, cell), live, 1.0)
    assert got <= DS_GAP < tf32_cut < bf16_cut, (got, tf32_cut, bf16_cut)


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


def test_one_phonemesal_base_step_runs_every_backward_on_the_kernels(cuda):
    """A PhonemeSaL-base train step's forward and backward (vit5-base
    encoder over 80 + 128 + 128 positions, the 4-layer phoneme decoder over
    39, B=2: the counts do not depend on the batch): 12 SaL and 8 attention
    kernel launches, and as many backward calls on the backward kernels
    (12 SaL, 8 attention: 20), none on the plain recompute."""
    from phoneme_vqa_torch.models.customized import CustomizedSaL_config
    from phoneme_vqa_torch.models.phoneme import PhonemeSaL
    from phoneme_vqa_torch.models.sal import build_sal

    cfg = CustomizedSaL_config().build({}, tgt_vocab_size=253)
    model = build_sal({}, device=cuda, model_cls=PhonemeSaL, cfg=cfg).train()
    b, vocab = 2, cfg.t5.vocab_size
    g = torch.Generator(device=cuda).manual_seed(0)
    ids = lambda hi, *shape: torch.randint(0, hi, shape, generator=g, device=cuda)
    ones = lambda n: torch.ones(b, n, dtype=torch.int32, device=cuda)
    rand = lambda *shape: torch.rand(*shape, generator=g, device=cuda)
    batch = {"input_ids": ids(vocab, b, 80), "src_attention_mask": ones(80),
             "tokenized_ocr": ids(vocab, b, 128), "ocr_attention_mask": ones(128),
             "ocr_coordinates": rand(b, 128, 4), "ocr_features": rand(b, 128, 512),
             "tokenized_obj": ids(vocab, b, 128), "obj_attention_mask": ones(128),
             "obj_coordinates": rand(b, 128, 4), "obj_features": rand(b, 128, 2048)}
    counts = lambda: (sfa.LAUNCHES, sfa.BACKWARD_LAUNCHES, sfa.RECOMPUTE_FALLBACKS,
                      fa.LAUNCHES, fa.BACKWARD_LAUNCHES, fa.RECOMPUTE_FALLBACKS)
    before = counts()
    model(batch, ids(253, b, 39), ones(39)).float().mean().backward()
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(counts(), before)] == [12, 12, 0, 8, 8, 0]
