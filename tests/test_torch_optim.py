"""The port's loss, schedules and optimizer against the JAX package's
(``phoneme_vqa_tpu/train/optim.py`` on optax), on the CPU in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from phoneme_vqa_torch.config import Config as TConfig
from phoneme_vqa_torch.train import optim as t_optim
from phoneme_vqa_tpu.config import Config as JConfig
from phoneme_vqa_tpu.train import optim as j_optim


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_loss_matches_jax(smoothing):
    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 7, 23) * 3).astype(np.float32)
    targets = rng.randint(1, 23, (3, 7)).astype(np.int32)
    targets[0, 4:] = 0  # pads are not scored
    targets[2, 1:] = 0
    want = float(j_optim.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets), 0,
                                            label_smoothing=smoothing))
    got = t_optim.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets), 0,
                                     label_smoothing=smoothing)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_cross_entropy_of_all_pad_targets_is_zero():
    logits = torch.randn(2, 3, 5)
    assert float(t_optim.cross_entropy_loss(logits, torch.zeros(2, 3, dtype=torch.long), 0)) == 0.0


SCHEDULES = [
    ({}, "epoch_decay"),
    ({}, "warmup"),
    ({"LR_SCHEDULE": "cosine"}, None),
    ({"LR_SCHEDULE": "cosine", "WARMUP_STEPS": 4, "LR_MIN": 1e-5}, None),
    ({"LR_SCHEDULE": "cosine", "WARMUP_STEPS": 40}, None),  # warmup past the end
    ({"LR_SCHEDULE": "constant"}, None),
    ({"LR_SCHEDULE": "constant", "WARMUP_STEPS": 5}, None),
]


@pytest.mark.parametrize("overrides,default", SCHEDULES)
def test_schedules_match_jax_at_every_step(overrides, default):
    base = {"LR": 3e-4, "NUM_EPOCHS": 3, **overrides}
    steps_per_epoch = 7
    defaults = {
        "epoch_decay": (t_optim.epoch_decay_schedule(3e-4, steps_per_epoch),
                        j_optim.epoch_decay_schedule(3e-4, steps_per_epoch)),
        "warmup": (t_optim.linear_warmup_schedule(3e-4, 9),
                   j_optim.linear_warmup_schedule(3e-4, 9)),
        None: (t_optim.epoch_decay_schedule(3e-4, steps_per_epoch),
               j_optim.epoch_decay_schedule(3e-4, steps_per_epoch)),
    }[default]
    got = t_optim.schedule_from_config(TConfig(base), defaults[0], steps_per_epoch)
    want = j_optim.schedule_from_config(JConfig(base), defaults[1], steps_per_epoch)
    # the JAX schedules compute in f32, the port's in double: a cosine near
    # its end loses digits to cancellation in f32, so atol is 1e-7 of the LR
    for step in range(3 * steps_per_epoch + 5):
        np.testing.assert_allclose(got(step), float(want(jnp.int32(step))), rtol=2e-6,
                                   atol=1e-7 * base["LR"], err_msg=f"step {step}")


def test_unknown_schedule_and_optimizer_raise():
    with pytest.raises(ValueError, match="LR_SCHEDULE"):
        t_optim.schedule_from_config(TConfig({"LR": 1.0, "LR_SCHEDULE": "step"}), None, 1)
    with pytest.raises(ValueError, match="OPTIMIZER"):
        t_optim.build_optimizer(lambda s: 1.0, kind="sgd")


@pytest.mark.parametrize("key,value", [("OPTIMIZER", "adafactor"), ("OPT_MU_DTYPE", "bfloat16")])
def test_unported_optimizer_knobs_raise(key, value):
    config = TConfig({key: value})
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        t_optim.build_optimizer(lambda s: 1.0, mu_dtype=t_optim.mu_dtype_from_config(config),
                                kind=t_optim.optimizer_kind_from_config(config))


def _tree(seed):
    """A small parameter tree: two trainable leaves and a ``vit`` one."""
    rng = np.random.RandomState(seed)
    return {
        "enc": {"kernel": rng.randn(6, 5).astype(np.float32),
                "embedding": rng.randn(4, 3).astype(np.float32)},
        "vit": {"kernel": rng.randn(3, 3).astype(np.float32)},
    }


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


OPTIMIZERS = {
    "adam": dict(kind="adam"),
    "adamw": dict(kind="adamw", weight_decay=0.1),
    "adam_clip": dict(kind="adam", grad_clip=0.5),  # the norm is ~4: clips every step
    "adam_clip_unused": dict(kind="adam", grad_clip=100.0),
    "adam_freeze": dict(kind="adam", freeze=True),
    "adamw_clip_freeze": dict(kind="adamw", weight_decay=0.1, grad_clip=0.5, freeze=True),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_three_optimizer_steps_match_optax(name):
    opts = dict(OPTIMIZERS[name])
    freeze = opts.pop("freeze", False)
    j_schedule = j_optim.epoch_decay_schedule(1e-2, 2)  # the LR changes after step 2
    t_schedule = t_optim.epoch_decay_schedule(1e-2, 2)
    j_pred = (lambda path: getattr(path[0], "key", None) == "vit") if freeze else None
    t_pred = (lambda n: n.split(".", 1)[0] == "vit") if freeze else None
    tx = j_optim.build_optimizer(j_schedule, betas=(0.9, 0.98), freeze_predicate=j_pred, **opts)
    t_tx = t_optim.build_optimizer(t_schedule, betas=(0.9, 0.98), freeze_predicate=t_pred, **opts)

    j_params = jax.tree.map(jnp.asarray, _tree(0))
    t_params = {n: torch.from_numpy(v.copy()) for n, v in _flat(_tree(0)).items()}
    j_state, t_state = tx.init(j_params), t_tx.init(t_params)
    if freeze:
        assert "vit.kernel" not in t_state["mu"] and "vit.kernel" not in t_state["nu"]
    for step in range(3):
        grads = _tree(10 + step)
        grads["enc"]["embedding"][1] = 0.0  # a row no token touched
        updates, j_state = tx.update(jax.tree.map(jnp.asarray, grads), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_grads = {n: torch.from_numpy(v.copy()) for n, v in _flat(grads).items()}
        t_tx.update_(t_params, t_grads, t_state)
        assert t_state["count"] == step + 1
        for n, want in _flat(jax.tree.map(np.asarray, j_params)).items():
            np.testing.assert_allclose(t_params[n].numpy(), want, atol=2e-7, rtol=1e-6,
                                       err_msg=f"{name} step {step} {n}")
    start = _flat(_tree(0))
    if not opts.get("weight_decay"):  # a zero-gradient row stays bit-equal
        np.testing.assert_array_equal(t_params["enc.embedding"][1].numpy(),
                                      start["enc.embedding"][1])
    if freeze:
        np.testing.assert_array_equal(t_params["vit.kernel"].numpy(), start["vit.kernel"])
