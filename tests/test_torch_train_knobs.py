"""The port's fine-tuning knobs on the CPU at tiny widths in f32 (LaTr):
``EMA_DECAY``, ``GRAD_ACCUM_STEPS``, ``OPTIMIZER: adafactor`` and
``OPT_MU_DTYPE: bfloat16`` each run three steps against the JAX executor
(optax) from the same bridged parameters: losses within 1e-5, parameters
within 1e-5 (but at elements whose gradient sat at rounding level, which the
normalized steps of adam and adafactor part by up to 2 lr; under 0.1 % of
them). ``REMAT``'s loss and every gradient equal REMAT off with dropout 0.1
(the recompute draws the forward's masks); a ``SAVE_EVERY_STEPS``
stop-and-resume trajectory equals the one without a stop.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from phoneme_vqa_torch import config as t_config
from phoneme_vqa_torch import train  # noqa: F401  (registers the executors)
from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.models import t5 as t5_mod
from phoneme_vqa_torch.utils.registry import EXECUTORS as T_EXECUTORS
from phoneme_vqa_tpu import registry_setup  # noqa: F401
from phoneme_vqa_tpu.config import get_config
from phoneme_vqa_tpu.utils.registry import EXECUTORS

from .fixtures import make_latr_fixture, tiny_latr_yaml

TOL = 1e-5
STEPS = 3


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return make_latr_fixture(tmp_path_factory.mktemp("knobs"))


def pair(paths, root, **over):
    """The JAX executor and the port's, the port's from the JAX one's
    initial parameters, each after three one-step epochs."""
    j_config = get_config(tiny_latr_yaml(paths, str(root / "jax"), NUM_EPOCHS=STEPS, SAVE=False,
                                         **over))
    t_cfg = t_config.Config({**j_config, "SAVE_PATH": str(root / "port")})
    j_ex = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="train")
    t_ex = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "train", device="cpu")
    t_ex.load_params(bridge.flax_to_state_dict(jax.tree.map(np.asarray, j_ex.state.params),
                                               t_ex.model))
    losses = [(j_ex._train_epoch(e), t_ex._train_epoch(e)) for e in range(1, STEPS + 1)]
    np.testing.assert_allclose([t for _, t in losses], [j for j, _ in losses], rtol=TOL, atol=TOL)
    return j_ex, t_ex


def assert_params_match(got: dict, want: dict, lr: float) -> None:
    """Every tensor within TOL of the JAX one's, but at elements a normalized
    step parted (up to 2 lr a step; under 0.1 % of all)."""
    n_far = n_all = 0
    for name, value in want.items():
        gap = np.abs(got[name].detach().float().numpy() - value.numpy())
        assert gap.max() <= 2 * lr * STEPS * 1.001, name
        n_far += int((gap > TOL).sum())
        n_all += gap.size
    assert n_far <= 1e-3 * n_all, (n_far, n_all)


def jax_params(j_ex, t_ex, tree=None):
    tree = j_ex.state.params if tree is None else tree
    return bridge.flax_to_state_dict(jax.tree.map(np.asarray, tree), t_ex.model)


@pytest.mark.parametrize("knob", [
    dict(EMA_DECAY=0.9),
    dict(GRAD_ACCUM_STEPS=2),
    dict(OPTIMIZER="adafactor", LR=1e-2),
    dict(OPTIMIZER="adafactor", LR=1e-2, WEIGHT_DECAY=0.01),
    dict(OPT_MU_DTYPE="bfloat16"),
], ids=["ema", "grad_accum", "adafactor", "adafactor_wd", "mu_bf16"])
def test_three_steps_match_the_jax_executor(paths, tmp_path, knob):
    j_ex, t_ex = pair(paths, tmp_path, **knob)
    lr = float(t_ex._lr_schedule(0))
    assert_params_match(t_ex.state.params, jax_params(j_ex, t_ex), lr)
    assert t_ex.state.step == int(j_ex.state.step) == STEPS
    if "EMA_DECAY" in knob:
        assert_params_match(t_ex.state.ema_params, jax_params(j_ex, t_ex, j_ex.state.ema_params),
                            lr)
    if knob.get("OPTIMIZER") == "adafactor":
        state = t_ex.state.opt_state
        assert set(state) == {"count", "v_row", "v_col", "v"} and state["count"] == STEPS
        assert not any(n.startswith("vit.") for part in ("v", "v_row") for n in state[part])
    if "OPT_MU_DTYPE" in knob:
        assert {m.dtype for m in t_ex.state.opt_state["mu"].values()} == {torch.bfloat16}
        assert {m.dtype for m in t_ex.state.opt_state["nu"].values()} == {torch.float32}


def test_grad_accum_must_divide_the_batch(paths, tmp_path):
    cfg = t_config.Config(get_config(tiny_latr_yaml(paths, str(tmp_path), GRAD_ACCUM_STEPS=3)))
    with pytest.raises(ValueError, match="must divide TRAIN_BATCH_SIZE"):
        T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")


def test_grad_accum_draws_each_microbatch_its_own_dropout(paths, tmp_path):
    """With dropout, microbatch i draws from (SEED, step, i): two halves of
    one batch built from the same row get different masks."""
    cfg = t_config.Config(get_config(tiny_latr_yaml(paths, str(tmp_path), dropout_rate=0.5,
                                                    GRAD_ACCUM_STEPS=2)))
    ex = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")
    batch = ex.train_data.gather(np.zeros(4, np.int64))
    with torch.no_grad():
        losses = [float(ex.forward_loss(ex._to_device(batch), micro=i)) for i in (0, 1)]
        again = float(ex.forward_loss(ex._to_device(batch), micro=0))
    assert losses[0] != losses[1] and again == losses[0]


def test_ema_checkpoint_and_eval_routing(paths, tmp_path):
    cfg = t_config.Config(get_config(tiny_latr_yaml(paths, str(tmp_path), EMA_DECAY=0.5,
                                                    NUM_EPOCHS=1)))
    ex = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")
    ex.run()
    saved = torch.load(os.path.join(cfg.SAVE_PATH, "last_ckp"), weights_only=True)
    assert set(saved["ema_params"]) == set(saved["params"])
    moved = [n for n in saved["params"]
             if not torch.equal(saved["ema_params"][n], saved["params"][n])]
    assert moved  # one step: ema = (start + params) / 2 where a parameter moved
    for evaluate_ema, source in ((None, "ema_params"), (False, "params")):
        ev_cfg = t_config.Config({**cfg, "EVAL_EMA": evaluate_ema}
                                 if evaluate_ema is not None else cfg)
        ev = T_EXECUTORS.get(cfg.EXECUTOR)(ev_cfg, "eval", device="cpu")
        ev._load_trained_checkpoint("last")
        for name in moved[:5]:
            torch.testing.assert_close(ev.model.get_parameter(name), saved[source][name],
                                       atol=0, rtol=0)
    # an EMA run resumed from a checkpoint without an average seeds it from
    # the salvaged params
    flat = {k: v for k, v in saved.items() if k not in ("ema_params", "opt_state")}
    torch.save(flat, os.path.join(cfg.SAVE_PATH, "last_ckp"))
    resumed = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")
    for name, value in saved["params"].items():
        torch.testing.assert_close(resumed.state.ema_params[name], value, atol=0, rtol=0)
    with pytest.raises(ValueError, match="EMA_DECAY"):
        T_EXECUTORS.get(cfg.EXECUTOR)(t_config.Config({**cfg, "EMA_DECAY": 1.5}), "train",
                                      device="cpu")


def _loss_and_grads(ex, batch, remat: bool):
    for stack in (ex.model.t5.encoder, ex.model.t5.decoder):
        stack.cfg = dataclasses.replace(stack.cfg, remat=remat)
    loss = ex.forward_loss(ex._to_device(batch))
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in ex.model.named_parameters()
             if p.grad is not None}
    ex.model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def test_remat_gives_the_loss_and_gradients_of_no_remat_under_dropout(paths, tmp_path):
    """Dropout 0.1 draws from the model's own generator, which checkpoint's
    ``preserve_rng_state`` does not restore: the recompute must draw the
    forward's masks, or the gradients would be wrong without an error."""
    cfg = t_config.Config(get_config(tiny_latr_yaml(paths, str(tmp_path), dropout_rate=0.1,
                                                    REMAT=True)))
    ex = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")
    assert ex.model.t5.cfg.remat
    batch = ex.train_data.gather(np.arange(8))
    calls = []
    real = t5_mod.checkpoint
    t5_mod.checkpoint = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        loss_on, grads_on = _loss_and_grads(ex, batch, remat=True)
    finally:
        t5_mod.checkpoint = real
    assert len(calls) == 4  # two encoder and two decoder blocks
    loss_off, grads_off = _loss_and_grads(ex, batch, remat=False)
    assert float(loss_on) == float(loss_off)
    assert set(grads_on) == set(grads_off) and len(grads_on) > 40
    for name, g in grads_off.items():
        gap = float((grads_on[name] - g).norm())
        assert gap <= 1e-6 * max(float(g.norm()), 1e-12), name
    # without dropout the masks play no part and the T5 blocks still remat
    no_drop = t5_mod.DropoutRNG()
    out = t5_mod.remat_block(ex.model.t5.encoder.block_0.eval(), no_drop,
                             torch.randn(2, 3, 32, requires_grad=True), None,
                             torch.zeros(1, 4, 3, 3))
    assert out.shape == (2, 3, 32)


def test_save_every_steps_resumes_mid_epoch_on_the_uninterrupted_trajectory(paths, tmp_path):
    over = dict(NUM_EPOCHS=2, TRAIN_BATCH_SIZE=4, SAVE_EVERY_STEPS=2, dropout_rate=0.1)
    whole_cfg = t_config.Config(get_config(tiny_latr_yaml(paths, str(tmp_path / "whole"),
                                                          **over)))
    whole = T_EXECUTORS.get(whole_cfg.EXECUTOR)(whole_cfg, "train", device="cpu")
    start = {n: p.detach().clone() for n, p in whole.state.params.items()}
    whole.run()

    cut_cfg = t_config.Config({**whole_cfg, "SAVE_PATH": str(tmp_path / "cut")})
    cut = T_EXECUTORS.get(cut_cfg.EXECUTOR)(cut_cfg, "train", device="cpu")
    cut.load_params(start)
    real, calls = cut.train_step, []

    def preempted(batch):  # three steps an epoch: stop at epoch 2's third
        calls.append(1)
        if len(calls) == 6:
            raise KeyboardInterrupt
        return real(batch)

    cut.train_step = preempted
    with pytest.raises(KeyboardInterrupt):
        cut.run()
    saved = torch.load(os.path.join(cut_cfg.SAVE_PATH, "last_ckp"), weights_only=True)
    assert (saved["epoch"], saved["step_in_epoch"], saved["step"]) == (1, 2, 5)
    resumed = T_EXECUTORS.get(cut_cfg.EXECUTOR)(cut_cfg, "train", device="cpu")
    assert resumed._resume_step_in_epoch == 2 and resumed.state.step == 5
    resumed.run()
    assert resumed.state.step == whole.state.step == 6
    for name, p in whole.state.params.items():
        torch.testing.assert_close(resumed.state.params[name], p, atol=0, rtol=0)
    for name, m in whole.state.opt_state["nu"].items():
        torch.testing.assert_close(resumed.state.opt_state["nu"][name], m, atol=0, rtol=0)
