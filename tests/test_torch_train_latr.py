"""The port's LaTr training path against the JAX package's, on the CPU in
f32 at tiny widths: the loss and every gradient against
``jax.value_and_grad`` of the JAX executor's loss, the parameters after 3
adam steps against optax, the ViT freeze, dropout and the f32 masters of a
bf16 model.

Flax initializes the weights and ``models.bridge`` maps them (and the
gradient tree) onto the port's names and layouts.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _make_batch, _tiny_yaml_config
from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.models import latr as t_latr
from phoneme_vqa_torch.models import t5 as t_t5
from phoneme_vqa_torch.models.generate import make_generate_fn as t_make_generate_fn
from phoneme_vqa_torch.train import optim as t_optim
from phoneme_vqa_torch.train import state as t_state
from phoneme_vqa_tpu.models import latr as j_latr
from phoneme_vqa_tpu.train import optim as j_optim

VOCAB = 512
LR = 1e-3


def _config(**over):
    return {**_tiny_yaml_config(VOCAB), "DTYPE": "float32", "dropout_rate": 0.0, **over}


def _batch(seed=0):
    batch = _make_batch(3, VOCAB, 32, seed=seed)
    batch["ocr_attention_mask"][:, 9:] = 0
    batch["src_attention_mask"][1:, 5:] = 0
    batch["label_ids"][0, 6:] = 0  # a padded answer: its pads are not scored
    batch["label_attention_mask"][0, 6:] = 0
    return batch


def _j_loss(model):
    """The JAX executor's ``_loss_from_batch`` computation (no dropout)."""

    def loss(params, batch):
        model_batch = {k: v for k, v in batch.items() if not k.startswith("label")}
        logits = model.apply({"params": params}, model_batch, batch["label_ids"][:, :-1],
                             batch["label_attention_mask"][:, :-1])
        return j_optim.cross_entropy_loss(logits, batch["label_ids"][:, 1:], 0)

    return loss


def _t_loss(model, batch):
    tb = t_latr.to_device_batch(batch, "cpu", t_latr.BATCH_KEYS)
    labels = torch.from_numpy(batch["label_ids"])
    mask = torch.from_numpy(batch["label_attention_mask"])
    logits = model(tb, labels[:, :-1], mask[:, :-1])
    return t_optim.cross_entropy_loss(logits, labels[:, 1:], 0)


@pytest.fixture(scope="module")
def pair():
    cfg = _config()
    batch = _batch()
    j_model = j_latr.LaTr(j_latr.LaTr_config().build(cfg))
    model_batch = {k: v[:1] for k, v in batch.items() if not k.startswith("label")}
    params = j_model.init(jax.random.PRNGKey(0), model_batch, batch["label_ids"][:1, :-1],
                          batch["label_attention_mask"][:1, :-1])["params"]
    return cfg, j_model, jax.tree.map(np.asarray, params)


def _port_model(cfg, params):
    model = t_latr.LaTr(t_latr.LaTr_config().build(cfg), device="cpu")
    masters = t_state.bind_params(model, bridge.flax_to_state_dict(params, model))
    return model.train(), masters


def _vit(name):
    return name.split(".", 1)[0] == "vit"


def test_loss_and_every_gradient_match_jax_value_and_grad(pair):
    cfg, j_model, params = pair
    batch = _batch()
    want_loss, j_grads = jax.jit(jax.value_and_grad(_j_loss(j_model)))(params, batch)
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, j_grads), _port_model(cfg, params)[0])

    model, masters = _port_model(cfg, params)
    loss = _t_loss(model, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-6)
    n_checked = 0
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if _vit(name):  # stop_gradient in flax, no_grad here
            assert p.grad is None and not np.any(w), name
            continue
        assert p.grad is not None, name
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(p.grad.numpy(), w, atol=2e-5 * scale, rtol=1e-4, err_msg=name)
        if not np.any(w):  # e.g. relative-bias buckets no distance reaches
            assert not p.grad.any(), name
        n_checked += 1
    assert n_checked > 40


def test_params_after_three_adam_steps_match_optax(pair):
    """Three steps on three batches at LR 1e-3. The two frameworks' f32
    gradients differ by ~2e-5 of their largest entry at step 1, and more
    once the parameters have moved. An adam step moves a parameter by
    ``lr * m / sqrt(v)``, about ``lr * sign(g)`` at first, whatever |g| is:
    where |g| is near that rounding the update can differ by up to ``2 *
    lr``. So after step 1 entries with |g| >= 1e-3 agree within 1e-2 * lr
    and every entry within 2 * lr; after step 3 every entry within 2 * 3 *
    lr, entries whose |g| stayed >= 1e-2 within 0.1 * lr, and fewer than
    1 % of the trainable entries part by more than 0.1 * lr. Entries with a
    zero gradient in every step (rows no token touched, the frozen ViT) stay
    bit-equal."""
    cfg, j_model, params = pair
    schedule = j_optim.epoch_decay_schedule(LR, 2)
    tx = j_optim.build_optimizer(schedule, freeze_predicate=lambda path: path[0].key == "vit")
    j_params, j_state = params, tx.init(params)
    j_value_and_grad = jax.jit(jax.value_and_grad(_j_loss(j_model)))

    model, masters = _port_model(cfg, params)
    t_tx = t_optim.build_optimizer(t_optim.epoch_decay_schedule(LR, 2), freeze_predicate=_vit)
    state = t_state.TrainState.create(masters, t_tx)
    assert not any(_vit(n) for n in state.opt_state["mu"])  # the ViT holds no state
    trainable = list(state.opt_state["mu"])
    copies = t_state.compute_copies(model, state.params, trainable)
    assert copies == []  # f32: every master is its module parameter
    start = bridge.flax_to_state_dict(params, model)

    def parted(j_params):
        want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, j_params), model)
        return {n: (np.abs(p.detach().numpy() - want[n].numpy()), want[n].numpy())
                for n, p in model.named_parameters()}

    min_grad, max_grad = {}, {}
    for step in range(3):
        batch = _batch(seed=step)
        j_loss, j_grads = j_value_and_grad(j_params, batch)
        updates, j_state = tx.update(j_grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        flat = bridge.flax_to_state_dict(jax.tree.map(np.asarray, j_grads), model)
        for n, g in flat.items():
            a = np.abs(g.numpy())
            min_grad[n] = a if n not in min_grad else np.minimum(min_grad[n], a)
            max_grad[n] = a if n not in max_grad else np.maximum(max_grad[n], a)

        loss = _t_loss(model, batch)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=2e-5)
        t_tx.update_(state.params, t_state.master_grads(model, state.params, trainable),
                     state.opt_state)
        t_state.refresh_compute_weights_(copies)
        model.zero_grad(set_to_none=True)
        if step == 0:
            for name, (diff, _) in parted(j_params).items():
                big = min_grad[name] >= 1e-3
                assert diff.max() <= 2 * LR * 1.001, name
                assert diff[big].max(initial=0) <= 1e-2 * LR, name

    n_far = n_all = 0
    for name, (diff, want) in parted(j_params).items():
        got = dict(model.named_parameters())[name].detach().numpy()
        zero = max_grad[name] == 0.0
        if _vit(name):
            assert zero.all(), name
        np.testing.assert_array_equal(got[zero], start[name].numpy()[zero], err_msg=name)
        np.testing.assert_array_equal(got[zero], want[zero], err_msg=name)
        assert diff.max() <= 2 * 3 * LR * 1.001, name
        assert diff[min_grad[name] >= 1e-2].max(initial=0) <= 0.1 * LR, name
        if not _vit(name):
            n_far += int((diff > 0.1 * LR).sum())
            n_all += diff.size
    assert n_far < 0.01 * n_all, (n_far, n_all)


def test_dropout_is_the_identity_in_eval_mode_and_in_generate(pair):
    cfg, j_model, params = pair
    batch = _batch()
    plain, _ = _port_model(cfg, params)
    dropped, _ = _port_model(dict(cfg, dropout_rate=0.5), params)
    with torch.no_grad():
        want = _t_loss(plain.eval(), batch)
        assert float(_t_loss(dropped.eval(), batch)) == float(want)
        assert float(_t_loss(dropped.train(), batch)) != float(want)
    tb = t_latr.to_device_batch(batch, "cpu", t_latr.BATCH_KEYS)
    tokens = t_make_generate_fn(plain.eval(), 8)(tb)
    torch.testing.assert_close(t_make_generate_fn(dropped.train(), 8)(tb), tokens)
    assert dropped.training  # generate leaves the mode as it found it


def test_dropout_drops_at_its_rate_and_is_reproducible_from_seed_and_step():
    rng = t_t5.DropoutRNG()
    drop = t_t5.Dropout(0.3, rng).train()
    x = torch.ones(400, 500)
    rng.reseed(13, 7)
    a = drop(x)
    assert abs(float((a == 0).float().mean()) - 0.3) < 0.005
    torch.testing.assert_close(a[a != 0], torch.full_like(a[a != 0], 1 / 0.7))
    rng.reseed(13, 7)
    torch.testing.assert_close(drop(x), a, atol=0, rtol=0)
    rng.reseed(13, 8)  # the next step draws another mask
    assert not torch.equal(drop(x), a)
    assert drop.eval()(x) is x


def test_dropout_sits_at_the_jax_sites():
    """FFN inner activations and every residual branch: 1 + 2 calls per
    encoder block, 1 + 3 per decoder block in one forward, all drawing from
    the model's one stream; none in the ViT."""
    model = t_latr.LaTr(t_latr.LaTr_config().build(_config(dropout_rate=0.1)), device="cpu")
    calls = []
    for name, m in model.named_modules():
        if isinstance(m, t_t5.Dropout):
            assert m.rng is model.t5.dropout_rng and m.rate == 0.1, name
            m.register_forward_hook(lambda m, i, o, name=name: calls.append(name))
    with torch.no_grad():
        _t_loss(model.train(), _batch())
    assert len(calls) == 2 * 3 + 2 * 4
    assert calls.count("t5.encoder.block_0.drop") == 2
    assert calls.count("t5.decoder.block_1.drop") == 3
    assert calls.count("t5.decoder.block_1.ffn.drop") == 1
    assert not any(n.startswith("vit") for n in calls)


def test_bf16_model_keeps_f32_masters_that_take_sub_resolution_updates():
    cfg = _config(DTYPE="bfloat16")
    model = t_latr.LaTr(t_latr.LaTr_config().build(cfg), device="cpu")
    source = t_latr.random_params(model, torch.Generator().manual_seed(0))
    masters = t_state.bind_params(model, {n: v.clone() for n, v in source.items()})
    named = dict(model.named_parameters())
    wq = "t5.encoder.block_0.attn.q.weight"
    assert named[wq].dtype == torch.bfloat16 and masters[wq].dtype == torch.float32
    # masters come from the f32 source, not from the rounded module weight
    torch.testing.assert_close(masters[wq], source[wq], atol=0, rtol=0)
    assert not torch.equal(masters[wq], named[wq].float())
    norm = "t5.encoder.block_0.ln0.weight"
    assert masters[norm] is named[norm]  # an f32 parameter is its own master

    tx = t_optim.build_optimizer(lambda step: 1e-5, freeze_predicate=_vit)
    state = t_state.TrainState.create(masters, tx)
    trainable = list(state.opt_state["mu"])
    copies = t_state.compute_copies(model, state.params, trainable)
    assert wq in {n for n in trainable if named[n] is not state.params[n]}
    before = state.params[wq].clone()
    loss = _t_loss(model.train(), _batch())
    loss.backward()
    grads = t_state.master_grads(model, state.params, trainable)
    assert grads[wq].dtype == torch.float32
    torch.testing.assert_close(grads[wq], named[wq].grad.float(), atol=0, rtol=0)
    tx.update_(state.params, grads, state.opt_state)
    t_state.refresh_compute_weights_(copies)
    moved = state.params[wq] != before
    assert moved.float().mean() > 0.99  # every master with a gradient moved by ~1e-5
    torch.testing.assert_close(named[wq], state.params[wq].to(torch.bfloat16), atol=0, rtol=0)
    # the same step on the bf16 weights themselves would leave most in place
    stuck = (before.to(torch.bfloat16) - 1e-5 * torch.sign(grads[wq])).to(torch.bfloat16) \
        == before.to(torch.bfloat16)
    assert stuck.float().mean() > 0.9
