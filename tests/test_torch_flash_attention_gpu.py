"""The CUDA fused-attention kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA card; each skips inside the ``cuda`` fixture
when there is none. The card machine has no JAX, so run these without the
repo's conftest (which imports JAX):

    python -m pytest tests/test_torch_flash_attention_gpu.py --noconftest -q
"""

import itertools

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from phoneme_vqa_torch.ops import flash_attention as fa
from phoneme_vqa_torch.ops.attention import (
    dot_product_attention,
    reference_attention,
    reference_attention_backward,
)

pytestmark = pytest.mark.gpu

# f32: the kernel sums q·k and P·v in another order than cuBLAS; rounding is
# ~1e-6 relative and the softmax's exp scales it by the logit size (|s| ~ 30
# with no scale at D=128). bf16: the kernel's output is rounded to bf16
# (2^-8 relative), compared with the f32 plain result on the same inputs.
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, h, lq, lk, d, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(device)
    q, k, v = t(b, h, lq, d).to(dtype), t(b, h, lk, d).to(dtype), t(b, h, lk, d).to(dtype)
    bias = t(b, h, lq, lk)
    mask = torch.from_numpy((rng.rand(b, lk) > 0.3).astype(np.int32)).to(device)
    mask[0, 0] = 1
    mask[-1] = 0  # the last row attends nowhere: v averaged over the Lk real keys
    return q, k, v, bias, mask


def _compare(q, k, v, bias, mask, causal, scale):
    got = fa.fused_attention(q, k, v, bias, mask, causal, scale)
    torch.cuda.synchronize()
    want = reference_attention(q.float(), k.float(), v.float(), bias, mask, causal, scale)
    tol = TOL[q.dtype]
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
    return float((got.float() - want).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [16, 37, 131, 197, 327, 336, 512])
@pytest.mark.parametrize("d", [64, 32, 128])
def test_kernel_matches_plain_over_options(cuda, dtype, length, d):
    b, h = 2, 3
    q, k, v, bias_full, mask = _inputs(b, h, length, length, d, dtype, cuda)
    for bias_kind, use_mask, causal, scale in itertools.product(
        ("none", "one", "batch"), (False, True), (False, True), (None, d**-0.5)
    ):
        bias = {"none": None, "one": bias_full[:1].contiguous(), "batch": bias_full}[bias_kind]
        _compare(q, k, v, bias, mask if use_mask else None, causal, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_cross_attention_lengths(cuda, dtype, causal):
    q, k, v, bias, mask = _inputs(2, 4, 20, 327, 64, dtype, cuda, seed=1)
    _compare(q, k, v, None, mask, causal, None)
    _compare(q, k, v, bias[:1].contiguous(), mask, causal, None)


def _as_model_views(*xs):
    """(B, H, L, D) views of (B, L, H, D) storage, as the models hand them over."""
    return tuple(x.transpose(1, 2).contiguous().transpose(1, 2) for x in xs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("lq,lk", [(37, 37), (197, 197), (20, 327)])
def test_strided_views_equal_contiguous_bit_for_bit(cuda, dtype, d, lq, lk):
    q, k, v, bias, mask = _inputs(2, 3, lq, lk, d, dtype, cuda, seed=2)
    qv, kv, vv = _as_model_views(q, k, v)
    assert not qv.is_contiguous()
    for b, causal, scale in ((None, False, d**-0.5), (bias[:1].contiguous(), True, None),
                             (bias, False, None)):
        want = fa.fused_attention(q, k, v, b, mask, causal, scale)
        got = fa.fused_attention(qv, kv, vv, b, mask, causal, scale)
        torch.cuda.synchronize()
        assert got.stride() == want.stride()  # (B, L, H, D) storage either way
        assert torch.equal(got, want)
        # a bias view with padded rows is read in place and gives the same
        padded = torch.zeros(*b.shape[:-1], lk + 5, device=cuda)[..., :lk] if b is not None else None
        if padded is not None:
            padded.copy_(b)
            assert torch.equal(fa.fused_attention(qv, kv, vv, padded, mask, causal, scale), want)


def test_dispatch_launches_kernel_only_from_sixteen_rows(cuda):
    q, k, v, bias, mask = _inputs(2, 2, 16, 16, 64, torch.float32, cuda)
    before = fa.LAUNCHES
    dot_product_attention(q, k, v, bias[:1].contiguous(), mask.bool())
    assert fa.LAUNCHES == before + 1
    dot_product_attention(q[:, :, :1].contiguous(), k, v, None, mask.bool())
    assert fa.LAUNCHES == before + 1


# The backward kernels' gradients against the plain backward in f32 on the
# same bf16 values: each within GRAD_TOL of it in norm (rounding a gradient
# to bf16 alone moves each element by up to 2^-9, its norm by ~1e-3) and no
# further from it than SLACK times the plain bf16 recompute that the kernels
# replace (it rounds dP, P and the output gradient to bf16), plus FLOOR for
# the bf16 outputs' own rounding where that recompute comes closer.
GRAD_TOL = 1e-2
SLACK = 1.5
FLOOR = 2e-3


def _grads(attention, tensors, needs, w):
    """(out, the gradients of sum(out * w) for the tensors whose ``needs``
    is set) of ``attention(*tensors)``, each tensor a fresh leaf."""
    leaves = [t.detach().requires_grad_(n) for t, n in zip(tensors, needs)]
    out = attention(*leaves)
    wanted = [t for t, n in zip(leaves, needs) if n]
    return out, torch.autograd.grad((out.float() * w).sum(), wanted)


def _rel_err(a, ref) -> float:
    return float((a.float() - ref.float()).norm() / ref.float().norm())


def check_backward(kernel_fn, plain_fn, tensors, needs, w):
    """``kernel_fn``'s gradients (bf16 tensors through the backward kernels)
    against ``plain_fn``'s in f32, as GRAD_TOL / SLACK / FLOOR say; the same
    bits on a second run. Returns the gradients and their errors."""
    _, got = _grads(kernel_fn, tensors, needs, w)
    _, again = _grads(kernel_fn, tensors, needs, w)
    _, plain = _grads(plain_fn, tensors, needs, w)
    _, ref = _grads(plain_fn, [t.float() for t in tensors], needs, w)
    torch.cuda.synchronize()
    errs = []
    for i, (a, b, p, r) in enumerate(zip(got, again, plain, ref)):
        assert a.dtype == p.dtype and a.shape == p.shape and a.stride() == b.stride(), i
        assert torch.equal(a, b), f"gradient {i} differs between two runs"
        assert torch.isfinite(a).all() and r.abs().max() > 0, i
        err, plain_err = _rel_err(a, r), _rel_err(p, r)
        assert err <= GRAD_TOL and err <= SLACK * plain_err + FLOOR, (i, err, plain_err)
        errs.append(err)
    return got, errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,causal", [(37, 37, True), (127, 127, True), (20, 327, False)])
def test_dispatch_under_grad_launches_the_function_and_its_backward(cuda, dtype, lq, lk, causal):
    """With grad on, the dispatch runs the kernel's forward inside
    ``FusedAttentionFn``. In bf16 its backward launches the backward kernels
    once; in f32 it recomputes the plain version (counted as a fallback) and
    every gradient equals the plain path's, the bias's summed over the
    batch."""
    q, k, v, bias, mask = _inputs(2, 3, lq, lk, 64, dtype, cuda, seed=3)
    mask[-1] = 1
    tensors = [*_as_model_views(q, k, v), bias[:1].contiguous()]
    w = torch.randn(2, 3, lq, 64, device=cuda)
    kernel = lambda q_, k_, v_, b_: dot_product_attention(q_, k_, v_, b_, mask.bool(), causal)
    plain = lambda q_, k_, v_, b_: reference_attention(q_, k_, v_, b_, mask.bool(), causal)

    before = (fa.LAUNCHES, fa.BACKWARD_LAUNCHES, fa.RECOMPUTE_FALLBACKS)
    got_out, got = _grads(kernel, tensors, [True] * 4, w)
    bf16 = dtype == torch.bfloat16
    assert type(got_out.grad_fn).__name__ == "FusedAttentionFnBackward"
    assert (fa.LAUNCHES, fa.BACKWARD_LAUNCHES, fa.RECOMPUTE_FALLBACKS) == (
        before[0] + 1, before[1] + bf16, before[2] + (not bf16))
    want_out, want = _grads(plain, tensors, [True] * 4, w)
    torch.testing.assert_close(got_out.float(), want_out.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert got[3].shape == (1, 3, lq, lk)
    if bf16:
        check_backward(kernel, plain, tensors, [True] * 4, w)
    else:
        for g, ref in zip(got, want):
            assert g.abs().max() > 0
            torch.testing.assert_close(g, ref, atol=0, rtol=0)
    leaves = [t.detach().requires_grad_() for t in tensors]
    launched = fa.LAUNCHES
    with torch.no_grad():  # serving: the wrapper, no Function, the kernel all the same
        assert dot_product_attention(*leaves, mask.bool(), causal).grad_fn is None
    assert fa.LAUNCHES == launched + 1


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v, bias, mask = _inputs(1, 2, 32, 32, 64, torch.float32, cuda)
    with pytest.raises(ValueError):
        fa.fused_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):  # rows 65 floats apart: not a multiple of 16 bytes
        fa.fused_attention(torch.zeros(1, 2, 32, 65, device=cuda)[..., :64], k, v)
    with pytest.raises(ValueError):  # a non-unit stride along D
        fa.fused_attention(torch.zeros(1, 2, 32, 128, device=cuda)[..., ::2], k, v)
    with pytest.raises(ValueError):
        fa.fused_attention(q[..., :60].contiguous(), k[..., :60].contiguous(),
                           v[..., :60].contiguous())
    with pytest.raises(ValueError):
        fa.fused_attention(q, k, v, bias.double())
    with pytest.raises(ValueError):  # contiguous but 8 bytes past a 16-byte boundary
        fa.fused_attention(q.flatten()[2 : 2 + 2 * 31 * 64].view(1, 2, 31, 64),
                           k[:, :, :31].contiguous(), v[:, :, :31].contiguous())


# the attention-kernel roles of a PhonemeSaL-base train step (B and H cut):
# the custom decoder's self-attention (39 x 39, causal, scale 1/8, key mask)
# and cross-attention (39 x 336, scale, key mask), and the SaL encoder with
# SAL_FUSED off (336 x 336, a per-row (B, H, L, L) f32 bias, key mask)
PHONEME_SAL_ROLES = {
    "custom_decoder_self": (39, 39, True, 64**-0.5, False),
    "custom_decoder_cross": (39, 336, False, 64**-0.5, False),
    "sal_encoder_materialized": (336, 336, False, None, True),
}


# the attention-kernel roles of the PhonemeLaTr / PreSTU family's train steps
# (B and H cut): the triple / custom decoder's self-attention (127 x 127,
# causal, scale 1/8, the answers' key mask) and cross-attention (127 x 327,
# scale, key mask), and the ViT under gradients (PreSTU trains it: 197 x 197,
# scale 1/8, no mask)
LATR_FAMILY_ROLES = {
    "triple_decoder_self": (127, 127, True, 64**-0.5, False, True),
    "triple_decoder_cross": (127, 327, False, 64**-0.5, False, True),
    "vit_under_gradients": (197, 197, False, 64**-0.5, False, False),
}


def _role_through_the_function(cuda, dtype, lq, lk, causal, scale, with_bias, with_mask=True):
    """A role through the dispatch under grad: one launch inside
    ``FusedAttentionFn``, the forward within the kernel's tolerance of the
    plain path; in f32 every gradient equal to the plain path's (the
    recompute), in bf16 the backward kernels' within ``check_backward``'s
    bounds."""
    q, k, v, bias, mask = _inputs(4, 12, lq, lk, 64, dtype, cuda, seed=5)
    mask[-1] = 1
    mask = mask.bool() if with_mask else None
    tensors = [*_as_model_views(q, k, v), *([bias] if with_bias else [])]
    w = torch.randn(4, 12, lq, 64, device=cuda)
    split = lambda attention: lambda q_, k_, v_, *b_: attention(
        q_, k_, v_, b_[0] if b_ else None, mask, causal, scale)

    before = fa.LAUNCHES
    got_out, got = _grads(split(dot_product_attention), tensors, [True] * len(tensors), w)
    assert fa.LAUNCHES == before + 1 and type(got_out.grad_fn).__name__ == "FusedAttentionFnBackward"
    want_out, want = _grads(split(reference_attention), tensors, [True] * len(tensors), w)
    torch.testing.assert_close(got_out.float(), want_out.float(), atol=TOL[dtype], rtol=TOL[dtype])
    if dtype == torch.bfloat16:
        check_backward(split(dot_product_attention), split(reference_attention), tensors,
                       [True] * len(tensors), w)
        return
    for g, ref in zip(got, want):
        assert g is not None and g.abs().max() > 0
        torch.testing.assert_close(g, ref, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("role", list(PHONEME_SAL_ROLES))
def test_phoneme_sal_training_roles_through_the_function(cuda, dtype, role):
    _role_through_the_function(cuda, dtype, *PHONEME_SAL_ROLES[role])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("role", list(LATR_FAMILY_ROLES))
def test_latr_family_training_roles_through_the_function(cuda, dtype, role):
    _role_through_the_function(cuda, dtype, *LATR_FAMILY_ROLES[role])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [48, 40])
@pytest.mark.parametrize("length", [16, 17, 64, 130])
def test_head_dims_below_64_at_the_phoneme_predictors_shape(cuda, dtype, d, length):
    """The standalone phoneme predictor's attention (B=1, H=8, scale d^-0.5,
    no bias, no mask; head dim 48 at its default width, 40 beside it): D
    pads to 64 in the f32 path and TMA zero-fills the columns past D in
    bf16. Through the wrapper and through the dispatch on (B, H, L, D) views
    of (B, L, H, D) storage, as the model hands them over."""
    q, k, v, _, _ = _inputs(1, 8, length, length, d, dtype, cuda, seed=6)
    _compare(q, k, v, None, None, False, d**-0.5)
    views = _as_model_views(q, k, v)
    before = fa.LAUNCHES
    got = dot_product_attention(*views, scale=d**-0.5)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    assert torch.equal(got, fa.fused_attention(q, k, v, scale=d**-0.5))
    want = reference_attention(q.float(), k.float(), v.float(), scale=d**-0.5)
    torch.testing.assert_close(got.float(), want, atol=TOL[dtype], rtol=TOL[dtype])


# Every training role of the kernel table (PERF.md) through the backward
# kernels, B cut to 4: (lq, lk, causal, scaled, bias: None / "one" (the T5
# relative bias, batch 1, rows padded to 16 bytes) / "batch" (SAL_FUSED off),
# key mask: None / "answers" (answer prefixes) / "random" (with a fully
# masked last row)).
TRAINING_ROLES = {
    "t5_encoder": (327, 327, False, False, "one", "random"),
    "t5_decoder_self": (127, 127, True, False, "one", "answers"),
    "t5_cross": (127, 327, False, False, None, "random"),
    "custom_decoder_self": (39, 39, True, True, None, "answers"),
    "custom_decoder_cross": (39, 336, False, True, None, "random"),
    "sal_encoder_materialized": (336, 336, False, False, "batch", "random"),
    "triple_decoder_self": (127, 127, True, True, None, "answers"),
    "triple_decoder_cross": (127, 327, False, True, None, "random"),
    "vit_under_gradients": (197, 197, False, True, None, None),
}


def _role_tensors(cuda, role, d, heads=12, b=4, seed=7):
    """q, k, v as (B, H, L, D) views of the models' (B, L, 12, D) storage (the
    first ``heads`` of them: a tensor-parallel rank's head slice), the bias
    (its head slice) or None, the key mask or None, causal, scale."""
    lq, lk, causal, scaled, bias_kind, mask_kind = TRAINING_ROLES[role]
    q, k, v, bias, mask = _inputs(b, 12, lq, lk, d, torch.bfloat16, cuda, seed=seed)
    q, k, v = (x[:, :heads] for x in _as_model_views(q, k, v))
    if bias_kind == "one":
        padded = torch.zeros(1, 12, lq, lk + 5, device=cuda)[..., :lk]
        padded.copy_(bias[:1])
        bias = padded[:, :heads]
    elif bias_kind == "batch":
        bias = bias[:, :heads]
    else:
        bias = None
    if mask_kind == "answers":
        lens = torch.randint(2, lk, (b,), generator=torch.Generator().manual_seed(seed))
        mask = (torch.arange(lk)[None] < lens[:, None]).to(torch.int32).to(cuda)
    elif mask_kind is None:
        mask = None
    return q, k, v, bias, mask, causal, d**-0.5 if scaled else None


@pytest.mark.parametrize("d", [64, 48])
@pytest.mark.parametrize("role", list(TRAINING_ROLES))
def test_backward_kernels_at_the_training_roles(cuda, role, d):
    """Each role's gradients through ``FusedAttentionFn`` in bf16 on the
    models' strided views: one backward call a call, no fallback, within
    ``check_backward``'s bounds of the f32 plain backward and the same bits
    twice; the bias's gradient (where there is one) keeps its batch."""
    q, k, v, bias, mask, causal, scale = _role_tensors(cuda, role, d)
    tensors = [q, k, v, *([] if bias is None else [bias])]
    needs = [True] * len(tensors)
    w = torch.randn(*q.shape[:3], d, device=cuda)
    fn = lambda q_, k_, v_, *b_: dot_product_attention(q_, k_, v_, b_[0] if b_ else None,
                                                       mask, causal, scale)
    plain = lambda q_, k_, v_, *b_: reference_attention(q_, k_, v_, b_[0] if b_ else None,
                                                        mask, causal, scale)
    before = (fa.BACKWARD_LAUNCHES, fa.RECOMPUTE_FALLBACKS)
    got, _ = check_backward(fn, plain, tensors, needs, w)
    assert (fa.BACKWARD_LAUNCHES, fa.RECOMPUTE_FALLBACKS) == (before[0] + 2, before[1])
    for x, gx in zip(tensors, got):
        assert gx.shape == x.shape
    # dq, dk, dv land in (B, L, H, D) storage: the models' own layout
    assert got[0].transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("heads", [6, 3])
@pytest.mark.parametrize("role", ["t5_encoder", "t5_decoder_self", "t5_cross"])
def test_backward_kernels_at_tensor_parallel_head_slices(cuda, role, heads):
    """A rank's head slice (H = 6 at model 2, 3 at model 4) of the full
    call: its gradients are the full call's for those heads, bit for bit,
    since each (b, h) is computed alone."""
    q, k, v, bias, mask, causal, scale = _role_tensors(cuda, role, 64)
    full = [q, k, v, *([] if bias is None else [bias])]
    part = [x[:, :heads] for x in full]
    w = torch.randn(*q.shape[:3], 64, device=cuda)
    fn = lambda q_, k_, v_, *b_: dot_product_attention(q_, k_, v_, b_[0] if b_ else None,
                                                       mask, causal, scale)
    _, want = _grads(fn, full, [True] * len(full), w)
    _, got = _grads(fn, part, [True] * len(part), w[:, :heads])
    for g, ref in zip(got[:3], want):
        assert torch.equal(g, ref[:, :heads])
    for g, ref in zip(got[3:], want[3:]):  # the bias's batch sum: torch's reduction
        torch.testing.assert_close(g, ref[:, :heads], atol=1e-6, rtol=1e-6)


def test_backward_kernels_skip_a_bias_gradient_nobody_asks_for(cuda):
    """A bias that needs no gradient is not summed (no dS is written), and
    dq, dk, dv are the same bits as with it."""
    q, k, v, bias, mask, causal, scale = _role_tensors(cuda, "t5_encoder", 64)
    w = torch.randn(*q.shape[:3], 64, device=cuda)
    fn = lambda q_, k_, v_, b_: dot_product_attention(q_, k_, v_, b_, mask, causal, scale)
    _, with_bias = _grads(fn, [q, k, v, bias], [True, True, True, True], w)
    _, without = _grads(fn, [q, k, v, bias], [True, True, True, False], w)
    assert len(without) == 3
    for g, ref in zip(without, with_bias):
        assert torch.equal(g, ref)
    # only dv asked for: still one backward call
    before = fa.BACKWARD_LAUNCHES
    _, (dv,) = _grads(fn, [q, k, v, bias], [False, False, True, False], w)
    assert fa.BACKWARD_LAUNCHES == before + 1 and torch.equal(dv, with_bias[2])


def test_fully_masked_rows_average_v_and_pass_no_gradient_to_q_k(cuda):
    """A batch row whose keys are all masked: its output is v's mean over the
    Lk keys, so dv gets g / Lk from each such row and dq, dk of that batch
    row are zero, as the plain version gives."""
    q, k, v, _, mask = _inputs(2, 3, 37, 37, 64, torch.bfloat16, cuda, seed=8)
    mask[-1] = 0
    w = torch.randn(2, 3, 37, 64, device=cuda)
    fn = lambda q_, k_, v_: dot_product_attention(q_, k_, v_, None, mask.bool(), True)
    plain = lambda q_, k_, v_: reference_attention(q_, k_, v_, None, mask.bool(), True)
    (dq, dk, dv), _ = check_backward(fn, plain, [*_as_model_views(q, k, v)], [True] * 3, w)
    assert dq[-1].abs().max() == 0 and dk[-1].abs().max() == 0
    want_dv = (w[-1].sum(1, keepdim=True) / 37).expand(3, 37, 64)
    torch.testing.assert_close(dv[-1].float(), want_dv, atol=2e-2, rtol=1e-2)


def test_backward_kernels_under_remat(cuda):
    """REMAT: the layer is recomputed inside the backward (activation
    checkpointing) and the Function runs again there; the gradients are
    the same bits as without it."""
    q, k, v, bias, mask, causal, scale = _role_tensors(cuda, "t5_decoder_self", 64)
    tensors = [q, k, v, bias]
    w = torch.randn(*q.shape[:3], 64, device=cuda)
    fn = lambda q_, k_, v_, b_: dot_product_attention(q_, k_, v_, b_, mask, causal, scale)
    _, want = _grads(fn, tensors, [True] * 4, w)
    before = (fa.LAUNCHES, fa.BACKWARD_LAUNCHES)
    _, got = _grads(lambda *a: checkpoint(fn, *a, use_reentrant=False), tensors, [True] * 4, w)
    assert (fa.LAUNCHES, fa.BACKWARD_LAUNCHES) == (before[0] + 2, before[1] + 1)
    for g, ref in zip(got, want):
        assert torch.equal(g, ref)


def test_backward_wrapper_recomputes_f32_and_rejects_mismatched_operands(cuda):
    """f32 tensors on the card take the plain version, counted as a fallback
    and equal to ``reference_attention_backward`` bit for bit; an output or
    upstream gradient of another shape, or an output of another dtype, is
    refused."""
    q, k, v, bias, mask = _inputs(1, 2, 32, 32, 64, torch.float32, cuda)
    g = torch.randn_like(q)
    before = (fa.BACKWARD_LAUNCHES, fa.RECOMPUTE_FALLBACKS)
    got = fa.attention_backward(q, k, v, q, g, bias[:1], mask, True, 0.5, want_ds=True)
    assert (fa.BACKWARD_LAUNCHES, fa.RECOMPUTE_FALLBACKS) == (before[0], before[1] + 1)
    want = reference_attention_backward(q, k, v, g, bias[:1], mask, True, 0.5, want_ds=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    with pytest.raises(ValueError):  # g of another shape
        fa.attention_backward(q, k, v, q, q[:, :, :31])
    with pytest.raises(ValueError):  # out in another dtype
        fa.attention_backward(q, k, v, q.float(), q)


# The dq and dk products take dS at f32 precision (two TF32 terms,
# csrc/attention_bwd.cuh). Held against the plain backward in f64 from the
# very operands the kernels read (bf16 q, k, v, the upstream gradient and
# the forward's bf16 output) and rounded once to bf16, the kernels' dq and
# dk differ only where the f64 value lies within the kernels' f32 rounding
# of a bf16 rounding boundary, mostly in small elements: their gap in norm
# stays under DS_GAP. Rounding dS once to TF32 (2^-11) or bf16 (2^-8)
# before the products, the cut the kernels must not make, moves larger
# elements too; each test shows on its own data that the cut's gap is
# above DS_GAP. Set from readings on the H100 (PERF.md §6): over every
# training role at D 64 and 48 and the SaL encoder, three seeds each, the
# kernels read 1.1e-5 to 1.64e-4, dS rounded once to TF32 8.89e-4 to
# 9.90e-4, rounded to bf16 2.61e-3 to 2.80e-3.
DS_GAP = 4e-4


def _tf32(x):
    """f32 ``x`` rounded to TF32's 10-bit mantissa, half away from zero."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _plain_dq_dk_f64(q, k, v, out, g, bias, live, scale, cut=None):
    """dq, dk of the plain backward in f64: P the softmax of the logits
    (scale q kᵀ + bias, -1e9 where not ``live``), dS = P (g vᵀ - rowsum(g
    out)), zero where not live; ``cut`` rounds dS (as f32) before the
    products dq = scale dS k and dk = scale dSᵀ q."""
    q, k, v, out, g = (x.double() for x in (q, k, v, out, g))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.double()
    p = torch.softmax(s.masked_fill(~live, -1e9), -1)
    ds = p * (torch.matmul(g, v.transpose(-1, -2)) - (g * out).sum(-1, keepdim=True))
    ds = ds.masked_fill(~live, 0.0)
    if cut is not None:
        ds = cut(ds.float()).double()
    return torch.matmul(ds, k) * scale, torch.matmul(ds.transpose(-1, -2), q) * scale


def ds_precision_gaps(got, q, k, v, out, g, bias, live, scale):
    """The gap in norm of ``got`` (the kernels' dq, dk) to the f64 plain
    backward rounded to bf16, over the f64 one's norm (the larger of dq's
    and dk's); then the same gap of the plain backward with dS rounded once
    to TF32, and to bf16, before the products."""
    exact = _plain_dq_dk_f64(q, k, v, out, g, bias, live, scale)
    gap = lambda xs: max(float((x.double() - e.to(torch.bfloat16).double()).norm() / e.norm())
                         for x, e in zip(xs, exact))
    cuts = [_plain_dq_dk_f64(q, k, v, out, g, bias, live, scale, cut)
            for cut in (_tf32, lambda x: x.bfloat16().float())]
    return gap(got), *(gap([x.to(torch.bfloat16) for x in c]) for c in cuts)


def live_positions(mask, lq, lk, causal, device):
    """(B|1, 1, Lq, Lk) bool: the keys each row attends to (no mask: all)."""
    live = torch.ones(1, 1, lq, lk, dtype=torch.bool, device=device)
    if causal:
        live = live.tril()
    return live if mask is None else live & mask.bool()[:, None, None, :]


@pytest.mark.parametrize("role", ["t5_encoder", "t5_decoder_self", "t5_cross",
                                  "custom_decoder_cross", "sal_encoder_materialized"])
def test_backward_products_keep_ds_at_f32_precision(cuda, role):
    """The backward kernels' dq and dk at a training role (D 64, B 4) lie
    within DS_GAP in norm of the f64 plain backward rounded to bf16; dS
    rounded once to TF32 before the products would not."""
    q, k, v, bias, mask, causal, scale = _role_tensors(cuda, role, 64)
    out = fa.fused_attention(q, k, v, bias, mask, causal, scale, any_layout=True)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(5),
                    device=cuda).bfloat16()
    dq, dk, _, _ = fa.attention_backward(q, k, v, out, g, bias, mask, causal, scale)
    live = live_positions(mask, q.shape[2], k.shape[2], causal, cuda)
    got, tf32_cut, bf16_cut = ds_precision_gaps(
        (dq, dk), q, k, v, out, g, bias, live, 1.0 if scale is None else scale)
    assert got <= DS_GAP < tf32_cut < bf16_cut, (got, tf32_cut, bf16_cut)


def test_one_latr_base_step_runs_every_backward_on_the_kernels(cuda):
    """A LaTr-base train step's forward and backward (widths and depth of
    vit5-base and ViT-base, B=2: the counts do not depend on the batch): 48
    kernel launches (12 ViT, 12 encoder, 12 decoder self, 12 cross) and 36
    backward calls on the backward kernels (the frozen ViT's take no
    gradient), none on the plain recompute."""
    from phoneme_vqa_torch.models.latr import build_latr

    model = build_latr({}, device=cuda).train()
    b, vocab = 2, model.cfg.t5.vocab_size
    g = torch.Generator(device=cuda).manual_seed(0)
    ids = lambda hi, *shape: torch.randint(0, hi, shape, generator=g, device=cuda)
    ones = lambda n: torch.ones(b, n, dtype=torch.int32, device=cuda)
    batch = {"pixel_values": torch.randn(b, 3, 224, 224, generator=g, device=cuda),
             "coordinates": ids(1000, b, 100, 6), "input_ids": ids(vocab, b, 30),
             "src_attention_mask": ones(30), "ocr_attention_mask": ones(100),
             "tokenized_ocr": ids(vocab, b, 100)}
    before = (fa.LAUNCHES, fa.BACKWARD_LAUNCHES, fa.RECOMPUTE_FALLBACKS)
    model(batch, ids(vocab, b, 127), ones(127)).float().mean().backward()
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.BACKWARD_LAUNCHES, fa.RECOMPUTE_FALLBACKS) == (
        before[0] + 48, before[1] + 36, before[2])
