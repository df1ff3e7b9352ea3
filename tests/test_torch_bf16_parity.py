"""bf16 against the JAX package at tiny widths, on the CPU: a bridged LaTr
(the stock T5 decode) and a bridged PhonemeSaL forward and loss, and one
bf16 LaTr training step whose f32 masters (``train/state.py``) take an
adam update.

The rule is ``tests/test_torch_latr_family.py:
test_bf16_phoneme_latr_forward_and_loss_hold_against_jax``'s: both sides
round the same f32 weights to bf16 but sum in other orders and round
intermediates at other places, so the loss holds within 2e-2 relative and
the argmax is equal wherever JAX's top-2 logits part by more than the
largest logit gap between the two. The step's counterpart: an adam first
step moves a master by ``lr * sign(g)`` whatever ``|g|`` is, so every
updated master is within 2 lr (plus an f32 rounding) of JAX's, a master
whose JAX gradient exceeds the largest gradient gap of its tensor moves as
JAX's does, within 1e-3 lr, and at least 97 % of all masters do (a bf16
gradient near zero may flip its sign; 1.03 % flip on these seeded inputs).
"""

import functools

import jax
import numpy as np
import optax
import torch

from __graft_entry__ import _make_batch, _tiny_yaml_config
from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.models import latr as t_latr
from phoneme_vqa_torch.models import phoneme as t_phoneme
from phoneme_vqa_torch.models import customized as t_customized
from phoneme_vqa_torch.models import sal as t_sal
from phoneme_vqa_torch.train import optim as t_optim
from phoneme_vqa_torch.train import state as t_state
from phoneme_vqa_tpu.models import customized as j_customized
from phoneme_vqa_tpu.models import latr as j_latr
from phoneme_vqa_tpu.models import phoneme as j_phoneme
from phoneme_vqa_tpu.train import optim as j_optim

from .test_torch_phoneme_sal import ANSWER_VOCAB, BOS, CFG as SAL_CFG, EOS, PAD
from .test_torch_phoneme_sal import _batch as sal_batch

BF16_LOSS_RTOL = 2e-2
VOCAB = 512
LR = 1e-3


def _compute_dtypes(model) -> set:
    """The module weights' dtypes: bf16 matrices, f32 where the models keep
    f32 (the norms, the tied embedding and LM head)."""
    return {p.dtype for p in model.parameters()}


def _split(batch):
    model_batch = {k: v for k, v in batch.items() if not k.startswith("label")}
    return model_batch, batch["label_ids"], batch["label_attention_mask"]


def _hold(got: torch.Tensor, want) -> int:
    """The argmax rule of the module docstring; returns the positions
    compared."""
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    assert np.isfinite(g).all()
    gap = float(np.abs(g - w).max())
    top2 = np.sort(w, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > gap
    assert clear.mean() > 0.5, (clear.mean(), gap)
    np.testing.assert_array_equal(g.argmax(-1)[clear], w.argmax(-1)[clear])
    return int(clear.sum())


LATR_CFG = {**_tiny_yaml_config(VOCAB), "DTYPE": "bfloat16", "dropout_rate": 0.0}


@functools.lru_cache(maxsize=None)
def _j_latr():
    batch = _make_batch(3, VOCAB, 32, seed=2)
    batch["ocr_attention_mask"][:, 9:] = 0
    batch["src_attention_mask"][1:, 5:] = 0
    batch["label_ids"][0, 6:] = 0  # a padded answer: its pads are not scored
    batch["label_attention_mask"][0, 6:] = 0
    j_model = j_latr.LaTr(j_latr.LaTr_config().build(LATR_CFG))
    model_batch, labels, mask = _split(batch)
    params = jax.jit(j_model.init)(jax.random.PRNGKey(0),
                                   {k: v[:1] for k, v in model_batch.items()}, labels[:1, :-1],
                                   mask[:1, :-1])["params"]
    return j_model, jax.tree.map(np.asarray, params), batch


def _latr():
    """The JAX LaTr in bf16 compute (f32 params), and the port's on the same
    weights: its bf16 module and f32 masters."""
    j_model, params, batch = _j_latr()
    model = t_latr.LaTr(t_latr.LaTr_config().build(LATR_CFG), device="cpu")
    masters = t_state.bind_params(model, bridge.flax_to_state_dict(params, model))
    return j_model, params, model, masters, batch


def _j_loss(j_model, pad=0, **apply_kw):
    def loss(params, batch):
        model_batch, labels, mask = _split(batch)
        logits = j_model.apply({"params": params}, model_batch, labels[:, :-1], mask[:, :-1],
                               **apply_kw)
        return j_optim.cross_entropy_loss(logits, labels[:, 1:], pad), logits

    return loss


def _t_loss(model, batch, keys, pad=0):
    tb = t_latr.to_device_batch(batch, "cpu", keys)
    labels = torch.from_numpy(batch["label_ids"])
    mask = torch.from_numpy(batch["label_attention_mask"])
    logits = model(tb, labels[:, :-1], mask[:, :-1])
    return t_optim.cross_entropy_loss(logits, labels[:, 1:], pad), logits


def test_bf16_latr_forward_and_loss_hold_against_jax():
    j_model, params, model, _, batch = _latr()
    assert _compute_dtypes(model) == {torch.bfloat16, torch.float32}
    want_loss, want = jax.jit(_j_loss(j_model))(params, batch)
    with torch.no_grad():
        loss, got = _t_loss(model.eval(), batch, t_latr.BATCH_KEYS)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=BF16_LOSS_RTOL)
    assert _hold(got, want) > 0


def test_bf16_phoneme_sal_forward_and_loss_hold_against_jax():
    cfg = {**SAL_CFG, "DTYPE": "bfloat16"}
    j_model = j_phoneme.PhonemeSaL(j_customized.CustomizedSaL_config().build(
        cfg, ANSWER_VOCAB, PAD, BOS, EOS))
    model = t_phoneme.PhonemeSaL(t_customized.CustomizedSaL_config().build(
        cfg, ANSWER_VOCAB, PAD, BOS, EOS), device="cpu")
    batch = sal_batch(ANSWER_VOCAB, seed=5)
    model_batch, labels, mask = _split(batch)
    params = jax.tree.map(np.asarray, jax.jit(j_model.init)(
        jax.random.PRNGKey(0), {k: v[:1] for k, v in model_batch.items()}, labels[:1, :-1],
        mask[:1, :-1])["params"])
    t_state.bind_params(model, bridge.flax_to_state_dict(params, model))
    assert _compute_dtypes(model) == {torch.bfloat16, torch.float32}
    want_loss, want = jax.jit(_j_loss(j_model, PAD, deterministic=True))(params, batch)
    with torch.no_grad():
        loss, got = _t_loss(model.eval(), batch, t_sal.BATCH_KEYS, PAD)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=BF16_LOSS_RTOL)
    assert _hold(got, want) > 0


def test_bf16_train_step_updates_the_f32_masters_as_jax():
    """One adam step (LR 1e-3, the ViT frozen) of a bf16 LaTr: the port's
    bf16 module weights and f32 masters against JAX's f32 params under bf16
    compute."""
    j_model, params, model, masters, batch = _latr()
    vit = lambda name: name.split(".", 1)[0] == "vit"  # noqa: E731
    tx = j_optim.build_optimizer(j_optim.epoch_decay_schedule(LR, 2),
                                 freeze_predicate=lambda path: path[0].key == "vit")
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(_j_loss(j_model), has_aux=True))(
        params, batch)
    updates, _ = tx.update(j_grads, tx.init(params), params)
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, optax.apply_updates(
        params, updates)), model)
    want_grads = bridge.flax_to_state_dict(jax.tree.map(np.asarray, j_grads), model)

    t_tx = t_optim.build_optimizer(t_optim.epoch_decay_schedule(LR, 2), freeze_predicate=vit)
    state = t_state.TrainState.create(masters, t_tx)
    trainable = list(state.opt_state["mu"])
    copies = t_state.compute_copies(model, state.params, trainable)
    assert copies  # bf16: the module's matrices are compute copies of f32 masters
    loss, _ = _t_loss(model.train(), batch, t_latr.BATCH_KEYS)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=BF16_LOSS_RTOL)
    grads = t_state.master_grads(model, state.params, trainable)
    t_tx.update_(state.params, grads, state.opt_state)
    t_state.refresh_compute_weights_(copies)

    ulp = torch.finfo(torch.float32).eps
    n_clear = n_same = n_all = 0
    for name in trainable:
        got, w = state.params[name].detach(), want[name]
        assert got.dtype == torch.float32, name
        gap = (got - w).abs()
        assert float((gap - 2 * LR - 2 * ulp * w.abs()).max()) <= 0, name
        g_gap = float((grads[name] - want_grads[name]).abs().max())
        clear = want_grads[name].abs() > g_gap
        if clear.any():
            assert float(gap[clear].max()) <= 1e-3 * LR + 2 * ulp * float(w.abs().max()), name
        n_clear += int(clear.sum())
        n_same += int((gap <= 1e-3 * LR + 2 * ulp * w.abs()).sum())
        n_all += clear.numel()
    # on these seeded inputs (CPU): 16.5 % of the masters clear, 98.97 % move as JAX's
    assert n_clear > 0.1 * n_all and n_same >= 0.97 * n_all, (n_clear, n_same, n_all)
    for name in masters:  # the frozen ViT takes no update on either side
        if vit(name):
            torch.testing.assert_close(state.params[name].detach(), want[name], rtol=0, atol=0)
    # the bf16 compute weights are the masters' rounding
    named = dict(model.named_parameters())
    for module_weight, master in copies:
        assert torch.equal(module_weight, master.to(torch.bfloat16))
    assert any(named[n].dtype == torch.bfloat16 for n in trainable)
