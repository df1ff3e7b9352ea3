"""The kernels' ``autograd.Function``s against ``jax.grad`` of the JAX
package's ``custom_vjp`` wrappers, on the CPU in f32.

On the CPU a wrapper computes its plain version, so the Function's forward
here is the plain forward (the launcher is replaced by a counting stand-in
to show the Function calls it); its backward is the recompute the card runs
too. The JAX side runs the Pallas kernels in interpret mode, as
``tests/test_flash_attention.py`` and ``tests/test_sal_fused_attention.py``
do. The loss is ``sum(out * w)`` with a fixed ``w``, so the upstream
gradient is the same on every side.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoneme_vqa_torch.models import t5 as t_t5
from phoneme_vqa_torch.ops import attention as t_attn
from phoneme_vqa_torch.ops import flash_attention as t_flash
from phoneme_vqa_torch.ops import sal_fused_attention as t_sfa
from phoneme_vqa_tpu.ops import attention as j_attn
from phoneme_vqa_tpu.ops import flash_attention as j_flash
from phoneme_vqa_tpu.ops import sal_fused_attention as j_sfa

TOL = 1e-5  # f32 on both sides; the sums run in another order

OPTIONS = list(itertools.product(("none", "one", "batch"), (False, True), (False, True),
                                 (None, 0.5)))


def _inputs(b, h, lq, lk, d, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for n in (lq, lk, lk))
    bias = rng.randn(b, h, lq, lk).astype(np.float32)
    mask = (rng.rand(b, lk) > 0.3).astype(np.int32)
    mask[:, 0] = 1  # every row attends somewhere: the Pallas kernel and the
    # reference part on a row that attends nowhere (ROADMAP C)
    w = rng.randn(b, h, lq, d).astype(np.float32)
    return q, k, v, bias, mask, w


class _CountingLauncher:
    """Stands in for a kernel wrapper: counts calls, returns the plain
    forward."""

    def __init__(self, plain):
        self.plain, self.calls = plain, 0

    def __call__(self, *args, any_layout=False):
        assert any_layout, "the Function hands any layout to the wrapper"
        self.calls += 1
        return self.plain(*args)


def _torch_grads(fn, tensors, w):
    leaves = [None if t is None else torch.from_numpy(t).requires_grad_() for t in tensors]
    (fn(*leaves) * torch.from_numpy(w)).sum().backward()
    return [None if t is None else t.grad.numpy() for t in leaves]


def _jax_flash_grads(q, k, v, bias, mask, causal, scale, w):
    orig = j_flash.fused_attention
    j_flash.fused_attention = lambda *a, **kw: orig(*a, **dict(kw, interpret=True))
    try:
        def loss(q, k, v, bias):
            out = j_attn._flash(q, k, v, bias, None if mask is None else jnp.asarray(mask),
                                causal, scale)
            return jnp.sum(out * w)

        argnums = (0, 1, 2) if bias is None else (0, 1, 2, 3)
        grads = jax.grad(loss, argnums=argnums)(q, k, v, None if bias is None else bias)
    finally:
        j_flash.fused_attention = orig
    return [np.asarray(g) for g in grads] + ([None] if bias is None else [])


@pytest.mark.parametrize("bias_kind,use_mask,causal,scale", OPTIONS)
def test_attention_function_grads_match_jax_flash_custom_vjp(monkeypatch, bias_kind, use_mask,
                                                            causal, scale):
    q, k, v, bias, mask, w = _inputs(2, 3, 17, 17, 8)
    bias = {"none": None, "one": bias[:1], "batch": bias}[bias_kind]
    mask = mask if use_mask else None
    t_mask = None if mask is None else torch.from_numpy(mask)
    want = _jax_flash_grads(q, k, v, bias, mask, causal, scale, w)

    plain = _torch_grads(
        lambda q_, k_, v_, b_: t_attn.reference_attention(q_, k_, v_, b_, t_mask, causal, scale),
        (q, k, v, bias), w)
    launcher = _CountingLauncher(t_attn.reference_attention)
    monkeypatch.setattr(t_flash, "fused_attention", launcher)
    through_fn = _torch_grads(
        lambda q_, k_, v_, b_: t_attn.FusedAttentionFn.apply(q_, k_, v_, b_, t_mask, causal,
                                                             scale),
        (q, k, v, bias), w)
    assert launcher.calls == 1
    for name, a, b_, jx in zip(("dq", "dk", "dv", "dbias"), plain, through_fn, want):
        if jx is None:
            assert a is None and b_ is None, name
            continue
        assert b_ is not None and np.abs(b_).max() > 0, name
        assert b_.shape == jx.shape, name  # dbias keeps the bias's batch of 1
        np.testing.assert_allclose(a, jx, atol=TOL, rtol=TOL, err_msg=name)
        np.testing.assert_array_equal(b_, a, err_msg=name)  # the same recompute


def test_attention_function_grads_at_cross_lengths(monkeypatch):
    """Decoder cross-attention in training: Lq 5 over Lk 29, key mask only."""
    q, k, v, _, mask, w = _inputs(2, 3, 5, 29, 16, seed=2)
    want = _jax_flash_grads(q, k, v, None, mask, False, None, w)
    monkeypatch.setattr(t_flash, "fused_attention", _CountingLauncher(t_attn.reference_attention))
    t_mask = torch.from_numpy(mask)
    got = _torch_grads(lambda q_, k_, v_: t_attn.FusedAttentionFn.apply(q_, k_, v_, None, t_mask,
                                                                         False, None),
                       (q, k, v), w)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a, b_, atol=TOL, rtol=TOL)


def _answer_mask(b, lk, seed):
    """A key mask of answer prefixes: row r keeps its first n_r keys."""
    lens = np.random.RandomState(seed).randint(2, lk, b)
    lens[0] = lk
    return (np.arange(lk)[None] < lens[:, None]).astype(np.int32)


# the attention roles of the PhonemeLaTr / PreSTU family's train steps, cut in
# width: (b, h, lq, lk, d, causal, scale, key mask)
NEW_ROLES = {
    # the triple / custom decoder's self-attention: causal, 1/sqrt(d), answers' mask
    "decoder_self": (2, 3, 19, 19, 8, True, 8**-0.5, _answer_mask(2, 19, 5)),
    # its cross-attention over the encoder, the encoder's mask
    "decoder_cross": (2, 3, 19, 29, 8, False, 8**-0.5, "random"),
    # the ViT under gradients (PreSTU trains it): 1/sqrt(d), no mask, no bias
    "vit": (2, 3, 17, 17, 8, False, 8**-0.5, None),
}


@pytest.mark.parametrize("role", list(NEW_ROLES))
def test_attention_function_grads_in_the_phoneme_and_prestu_roles(monkeypatch, role):
    b, h, lq, lk, d, causal, scale, mask = NEW_ROLES[role]
    q, k, v, _, random_mask, w = _inputs(b, h, lq, lk, d, seed=6)
    mask = random_mask if isinstance(mask, str) else mask
    want = _jax_flash_grads(q, k, v, None, mask, causal, scale, w)
    launcher = _CountingLauncher(t_attn.reference_attention)
    monkeypatch.setattr(t_flash, "fused_attention", launcher)
    t_mask = None if mask is None else torch.from_numpy(mask)
    got = _torch_grads(lambda q_, k_, v_: t_attn.FusedAttentionFn.apply(q_, k_, v_, None, t_mask,
                                                                         causal, scale),
                       (q, k, v), w)
    assert launcher.calls == 1
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
        assert np.abs(a).max() > 0, name
        np.testing.assert_allclose(a, b_, atol=TOL, rtol=TOL, err_msg=name)


def test_relative_bias_gradient_reaches_its_table_through_the_padded_rows(monkeypatch):
    """``RelativeBias`` hands the kernel a view of row-padded storage (a
    ``copy_`` into it); the Function's dbias must still reach
    ``rel_embedding.weight``, as it does on the plain path."""
    cfg = t_t5.T5Config(num_heads=3, relative_attention_num_buckets=8,
                        relative_attention_max_distance=16, dtype=torch.float32)
    rel = t_t5.RelativeBias(cfg, bidirectional=False)
    torch.nn.init.normal_(rel.rel_embedding.weight, generator=torch.Generator().manual_seed(0))
    q, k, v, _, mask, w = (torch.from_numpy(x) for x in _inputs(2, 3, 17, 17, 8, seed=3))

    def table_grad(attention):
        rel.zero_grad()
        bias = rel(17, 17)
        assert bias.stride(-2) == 20  # 17 floats padded to 16-byte rows
        (attention(q, k, v, bias, mask, True, None) * w).sum().backward()
        return rel.rel_embedding.weight.grad.clone()

    want = table_grad(t_attn.reference_attention)
    monkeypatch.setattr(t_flash, "fused_attention", _CountingLauncher(t_attn.reference_attention))
    got = table_grad(t_attn.FusedAttentionFn.apply)
    assert got.abs().max() > 0
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_cpu_dispatch_keeps_the_plain_path_under_grad():
    """On the CPU ``dot_product_attention`` with inputs that need gradients
    takes the plain version and launches nothing."""
    q, k, v, bias, mask, w = (torch.from_numpy(x) for x in _inputs(2, 2, 20, 20, 8, seed=4))
    q.requires_grad_()
    before = t_flash.LAUNCHES
    out = t_attn.dot_product_attention(q, k, v, bias[:1], mask.bool(), causal=True)
    assert out.grad_fn is not None and "Fused" not in type(out.grad_fn).__name__
    assert t_flash.LAUNCHES == before


def _sal_inputs(b, h, l, d, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, l, d).astype(np.float32) for _ in range(3))
    bias1d = (rng.randn(h, l, l) * 0.5).astype(np.float32)
    cb = np.zeros((h, 122, 122), np.float32)
    cb[:, :121, :121] = (rng.randn(h, 121, 121) * 0.3).astype(np.float32)
    cell = rng.randint(0, 121, (b, l)).astype(np.int32)
    cell[:, :5] = t_sfa.SENTINEL
    cell[:, l - l // 8:] = t_sfa.SENTINEL
    mask = np.ones((b, l), np.int32)
    mask[1, (3 * l) // 4:] = 0
    w = rng.randn(b, h, l, d).astype(np.float32)
    return q, k, v, bias1d, cb, cell, mask, w


@pytest.mark.parametrize("shape", [(2, 3, 37, 16), (2, 2, 24, 8)])
def test_sal_function_grads_match_jax_sal_attention(monkeypatch, shape):
    q, k, v, bias1d, cb, cell, mask, w = _sal_inputs(*shape)
    saved = j_sfa.INTERPRET
    j_sfa.set_interpret(True)
    try:
        want = jax.grad(
            lambda *a: jnp.sum(j_sfa.sal_attention(*a, jnp.asarray(cell), jnp.asarray(mask)) * w),
            argnums=(0, 1, 2, 3, 4),
        )(q, k, v, bias1d, cb)
    finally:
        j_sfa.set_interpret(saved)
    launcher = _CountingLauncher(t_sfa.sal_reference_attention)
    monkeypatch.setattr(t_sfa, "sal_fused_attention", launcher)
    t_cell, t_mask = torch.from_numpy(cell), torch.from_numpy(mask)
    got = _torch_grads(
        lambda *a: t_sfa.SalAttentionFn.apply(*a, t_cell, t_mask), (q, k, v, bias1d, cb), w)
    assert launcher.calls == 1
    for name, a, b_ in zip(("dq", "dk", "dv", "dbias1d", "dcell_bias"), got, want):
        assert np.abs(a).max() > 0, name
        np.testing.assert_allclose(a, np.asarray(b_), atol=TOL, rtol=TOL, err_msg=name)


class _BackwardStandIn:
    """Stands in for a backward-kernel wrapper (``attention_backward`` /
    ``sal_attention_backward``): counts calls and the dS requests, returns
    the plain dq, dk, dv and dS, as the kernels give them."""

    def __init__(self, plain):
        self.plain, self.calls, self.want_ds = plain, 0, []

    def __call__(self, q, k, v, out, g, *rest, want_ds=False):
        self.calls += 1
        self.want_ds.append(want_ds)
        return self.plain(q, k, v, g, *rest, want_ds=want_ds)


def _kernel_backward(monkeypatch, module, name, plain):
    """Puts a stand-in in place of the backward wrapper ``module.name``,
    which the Functions' backward calls."""
    stand_in = _BackwardStandIn(plain)
    monkeypatch.setattr(module, name, stand_in)
    return stand_in


@pytest.mark.parametrize("bias_kind,use_mask,causal,scale",
                         list(itertools.product(("one", "batch"), (False, True), (False, True),
                                                (None, 0.5))))
def test_attention_function_assembles_the_bias_gradient_from_ds(monkeypatch, bias_kind, use_mask,
                                                                causal, scale):
    """``FusedAttentionFn.backward`` from the backward wrapper's (a
    stand-in's) dq, dk, dv and dS: the JAX ``custom_vjp``'s gradients, the
    T5 bias's (batch 1) as dS summed over the batch and a batch-B bias's as
    dS itself."""
    q, k, v, bias, mask, w = _inputs(2, 3, 17, 17, 8, seed=11)
    bias = bias[:1] if bias_kind == "one" else bias
    mask = mask if use_mask else None
    t_mask = None if mask is None else torch.from_numpy(mask)
    want = _jax_flash_grads(q, k, v, bias, mask, causal, scale, w)
    monkeypatch.setattr(t_flash, "fused_attention", _CountingLauncher(t_attn.reference_attention))
    stand_in = _kernel_backward(monkeypatch, t_flash, "attention_backward",
                                t_attn.reference_attention_backward)
    before = t_flash.RECOMPUTE_FALLBACKS
    got = _torch_grads(
        lambda q_, k_, v_, b_: t_attn.FusedAttentionFn.apply(q_, k_, v_, b_, t_mask, causal,
                                                             scale),
        (q, k, v, bias), w)
    assert stand_in.calls == 1 and stand_in.want_ds == [True]
    assert t_flash.RECOMPUTE_FALLBACKS == before
    for name, a, jx in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.shape == jx.shape and np.abs(a).max() > 0, name
        np.testing.assert_allclose(a, jx, atol=TOL, rtol=TOL, err_msg=name)


def test_attention_function_asks_for_ds_only_where_a_bias_needs_a_gradient(monkeypatch):
    """A bias that needs no gradient (or none at all): the backward asks the
    wrapper for no dS and returns the JAX gradients of q, k and v."""
    q, k, v, bias, mask, w = _inputs(2, 3, 5, 29, 16, seed=12)
    bias = bias[:1]
    t_mask = torch.from_numpy(mask)
    want = _jax_flash_grads(q, k, v, bias, mask, False, None, w)
    monkeypatch.setattr(t_flash, "fused_attention", _CountingLauncher(t_attn.reference_attention))
    stand_in = _kernel_backward(monkeypatch, t_flash, "attention_backward",
                                t_attn.reference_attention_backward)
    t_bias = torch.from_numpy(bias)  # no requires_grad
    got = _torch_grads(lambda q_, k_, v_: t_attn.FusedAttentionFn.apply(
        q_, k_, v_, t_bias, t_mask, False, None), (q, k, v), w)
    got_nobias = _torch_grads(lambda q_, k_, v_: t_attn.FusedAttentionFn.apply(
        q_, k_, v_, None, t_mask, False, None), (q, k, v), w)
    want_nobias = _jax_flash_grads(q, k, v, None, mask, False, None, w)
    assert stand_in.want_ds == [False, False]
    for a, b_, c, d_ in zip(got, want, got_nobias, want_nobias):
        np.testing.assert_allclose(a, b_, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(c, d_, atol=TOL, rtol=TOL)


def _jax_sal_grads(q, k, v, bias1d, cb, cell, mask, w):
    saved = j_sfa.INTERPRET
    j_sfa.set_interpret(True)
    try:
        return jax.grad(
            lambda *a: jnp.sum(j_sfa.sal_attention(*a, jnp.asarray(cell), jnp.asarray(mask)) * w),
            argnums=(0, 1, 2, 3, 4),
        )(q, k, v, bias1d, cb)
    finally:
        j_sfa.set_interpret(saved)


@pytest.mark.parametrize("shape", [(2, 3, 37, 16), (2, 2, 24, 8)])
def test_sal_function_assembles_the_table_gradients_from_ds(monkeypatch, shape):
    """``SalAttentionFn.backward`` from the backward wrapper's (a
    stand-in's) dS: dbias1d is dS summed over the batch and dcell_bias dS
    summed into its (cell_q, cell_k) pairs, the sentinel cells (the question
    block, the tail, an id past the sentinel) into the sentinel row and
    column; both equal the JAX ``sal_attention``'s gradients."""
    q, k, v, bias1d, cb, cell, mask, w = _sal_inputs(*shape, seed=13)
    cell[1, 6] = 300  # read as the sentinel
    want = _jax_sal_grads(q, k, v, bias1d, cb, np.minimum(cell, t_sfa.SENTINEL), mask, w)
    monkeypatch.setattr(t_sfa, "sal_fused_attention",
                        _CountingLauncher(t_sfa.sal_reference_attention))
    stand_in = _kernel_backward(monkeypatch, t_sfa, "sal_attention_backward",
                                t_sfa.sal_reference_attention_backward)
    t_cell, t_mask = torch.from_numpy(cell), torch.from_numpy(mask)
    got = _torch_grads(
        lambda *a: t_sfa.SalAttentionFn.apply(*a, t_cell, t_mask), (q, k, v, bias1d, cb), w)
    assert stand_in.calls == 1 and stand_in.want_ds == [True]
    assert np.abs(got[4][:, -1]).max() > 0  # the sentinel row gathers every non-OCR token
    for name, a, b_ in zip(("dq", "dk", "dv", "dbias1d", "dcell_bias"), got, want):
        assert np.abs(a).max() > 0, name
        np.testing.assert_allclose(a, np.asarray(b_), atol=TOL, rtol=TOL, err_msg=name)


def test_sal_function_asks_for_ds_only_where_a_table_needs_a_gradient(monkeypatch):
    q, k, v, bias1d, cb, cell, mask, w = _sal_inputs(2, 2, 24, 8, seed=14)
    want = _jax_sal_grads(q, k, v, bias1d, cb, cell, mask, w)
    monkeypatch.setattr(t_sfa, "sal_fused_attention",
                        _CountingLauncher(t_sfa.sal_reference_attention))
    stand_in = _kernel_backward(monkeypatch, t_sfa, "sal_attention_backward",
                                t_sfa.sal_reference_attention_backward)
    t_cell, t_mask = torch.from_numpy(cell), torch.from_numpy(mask)
    tables = torch.from_numpy(bias1d), torch.from_numpy(cb)  # no requires_grad
    got = _torch_grads(lambda q_, k_, v_: t_sfa.SalAttentionFn.apply(q_, k_, v_, *tables, t_cell,
                                                                     t_mask), (q, k, v), w)
    only_cb = _torch_grads(lambda cb_: t_sfa.SalAttentionFn.apply(
        *(torch.from_numpy(x) for x in (q, k, v, bias1d)), cb_, t_cell, t_mask), (cb,), w)
    assert stand_in.want_ds == [False, True]
    for a, b_ in zip(got + only_cb, list(want[:3]) + [want[4]]):
        np.testing.assert_allclose(a, np.asarray(b_), atol=TOL, rtol=TOL)


def test_cpu_and_f32_calls_take_the_recompute_and_count_it(monkeypatch):
    """Where the backward kernels do not take a call (CPU tensors; f32 on
    the card) the Functions recompute the plain version: each backward
    counts one fallback and no backward launch."""
    assert not t_attn.backward_kernel_takes(torch.zeros(1, dtype=torch.float32))
    assert not t_attn.backward_kernel_takes(torch.zeros(1, dtype=torch.bfloat16))
    monkeypatch.setattr(t_flash, "fused_attention", _CountingLauncher(t_attn.reference_attention))
    monkeypatch.setattr(t_sfa, "sal_fused_attention",
                        _CountingLauncher(t_sfa.sal_reference_attention))
    q, k, v, bias, mask, w = _inputs(2, 3, 17, 17, 8, seed=15)
    counts = lambda: (t_flash.BACKWARD_LAUNCHES, t_flash.RECOMPUTE_FALLBACKS,
                      t_sfa.BACKWARD_LAUNCHES, t_sfa.RECOMPUTE_FALLBACKS)
    before = counts()
    _torch_grads(lambda q_, k_, v_, b_: t_attn.FusedAttentionFn.apply(
        q_, k_, v_, b_, torch.from_numpy(mask), True, None), (q, k, v, bias[:1]), w)
    assert counts() == (before[0], before[1] + 1, before[2], before[3])
    sq, sk, sv, bias1d, cb, cell, smask, sw = _sal_inputs(2, 2, 24, 8, seed=16)
    _torch_grads(lambda *a: t_sfa.SalAttentionFn.apply(*a, torch.from_numpy(cell),
                                                       torch.from_numpy(smask)),
                 (sq, sk, sv, bias1d, cb), sw)
    assert counts() == (before[0], before[1] + 1, before[2], before[3] + 1)


def test_backward_wrappers_compute_the_plain_backward_on_the_cpu():
    """On the CPU ``attention_backward`` / ``sal_attention_backward`` give the
    plain version: dq, dk, dv of autograd through the plain forward and dS,
    the logits' gradient, which sums to the bias's gradient."""
    q, k, v, bias, mask, w = (torch.from_numpy(x) for x in _inputs(2, 3, 17, 17, 8, seed=17))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias[:1])]
    out = t_attn.reference_attention(*leaves, mask, True, 0.5)
    want = torch.autograd.grad(out, leaves, w)
    dq, dk, dv, ds = t_flash.attention_backward(q, k, v, out.detach(), w, bias[:1], mask, True,
                                                0.5, want_ds=True)
    for a, b_ in zip((dq, dk, dv, ds.sum(0, keepdim=True)), want):
        torch.testing.assert_close(a, b_, atol=1e-6, rtol=1e-6)
    assert t_flash.attention_backward(q, k, v, out.detach(), w, bias[:1], mask, True, 0.5)[3] is None
    sq, sk, sv, bias1d, cb, cell, smask, sw = (
        torch.from_numpy(x) for x in _sal_inputs(2, 2, 24, 8, seed=18))
    leaves = [t.clone().requires_grad_() for t in (sq, sk, sv, bias1d, cb)]
    out = t_sfa.sal_reference_attention(*leaves, cell, smask)
    want = torch.autograd.grad(out, leaves, sw)
    dq, dk, dv, ds = t_sfa.sal_attention_backward(sq, sk, sv, out.detach(), sw, bias1d, cb, cell,
                                                  smask, want_ds=True)
    got = (dq, dk, dv, ds.sum(0), t_sfa.cell_pair_sums(ds, cell, cb.shape[-1]))
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, atol=1e-5, rtol=1e-5)
