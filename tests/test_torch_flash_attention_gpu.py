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

from phoneme_vqa_torch.ops import flash_attention as fa
from phoneme_vqa_torch.ops.attention import dot_product_attention, reference_attention

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,causal", [(37, 37, True), (127, 127, True), (20, 327, False)])
def test_dispatch_under_grad_launches_the_function_with_a_recompute_backward(cuda, dtype, lq, lk,
                                                                             causal):
    """With grad on, the dispatch runs the kernel's forward inside
    ``FusedAttentionFn``; every input that requires grad gets the gradient
    the plain path gives (the backward is that recompute), the bias's
    summed over the batch."""
    q, k, v, bias, mask = _inputs(2, 3, lq, lk, 64, dtype, cuda, seed=3)
    mask[-1] = 1
    leaves = [t.detach().requires_grad_() for t in _as_model_views(q, k, v)]
    bias1 = bias[:1].detach().clone().requires_grad_()
    w = torch.randn(2, 3, lq, 64, device=cuda)

    def grads(attention):
        out = attention(*leaves, bias1, mask.bool(), causal)
        return out, torch.autograd.grad((out.float() * w).sum(), [*leaves, bias1])

    before = fa.LAUNCHES
    got_out, got = grads(lambda q_, k_, v_, b_, m_, c_: dot_product_attention(
        q_, k_, v_, b_, m_, c_))
    assert fa.LAUNCHES == before + 1 and type(got_out.grad_fn).__name__ == "FusedAttentionFnBackward"
    want_out, want = grads(lambda q_, k_, v_, b_, m_, c_: reference_attention(
        q_, k_, v_, b_, m_, c_))
    torch.testing.assert_close(got_out.float(), want_out.float(), atol=TOL[dtype], rtol=TOL[dtype])
    for g, ref in zip(got, want):
        assert g is not None and g.abs().max() > 0
        torch.testing.assert_close(g, ref, atol=0, rtol=0)
    with torch.no_grad():  # serving: the wrapper, no Function
        assert dot_product_attention(*leaves, bias1, mask.bool(), causal).grad_fn is None
    assert fa.LAUNCHES == before + 2


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
    plain path and every gradient equal to its (the recompute)."""
    q, k, v, bias, mask = _inputs(4, 12, lq, lk, 64, dtype, cuda, seed=5)
    mask[-1] = 1
    mask = mask.bool() if with_mask else None
    leaves = [t.detach().requires_grad_() for t in _as_model_views(q, k, v)]
    if with_bias:
        leaves.append(bias.detach().clone().requires_grad_())
    w = torch.randn(4, 12, lq, 64, device=cuda)

    def grads(attention):
        b = leaves[3] if with_bias else None
        out = attention(*leaves[:3], b, mask, causal, scale)
        return out, torch.autograd.grad((out.float() * w).sum(), leaves)

    before = fa.LAUNCHES
    got_out, got = grads(dot_product_attention)
    assert fa.LAUNCHES == before + 1 and type(got_out.grad_fn).__name__ == "FusedAttentionFnBackward"
    want_out, want = grads(reference_attention)
    torch.testing.assert_close(got_out.float(), want_out.float(), atol=TOL[dtype], rtol=TOL[dtype])
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
