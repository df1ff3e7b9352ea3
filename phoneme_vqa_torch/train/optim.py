"""Optimizer, schedules, loss (counterpart of ``phoneme_vqa_tpu/train/optim.py``).

The reference trains with Adam(LR, BETAS, eps=1e-9), CE(ignore_index=pad)
and a 0.95**epoch LR decay; the JAX package adds label smoothing, cosine and
constant schedules, adamw, global-norm clipping and a frozen-subtree mask.
The port follows optax's rules, not ``torch.optim``'s:

* a schedule is read at the optimizer's step count *before* the increment;
* ``clip_by_global_norm`` scales by ``max_norm / norm`` only when the norm
  exceeds the limit (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to it);
* adam's update is ``mu_hat / (sqrt(nu_hat) + eps)``; adamw adds ``wd * p``
  to it before the learning rate scales it (decoupled decay);
* a frozen parameter has no optimizer state and takes no update
  (``optax.multi_transform`` with ``set_to_zero``), and the clip's norm
  runs over the trainable parameters only.

Parameters, gradients and moments are dicts of f32 tensors by parameter
name; the update runs in place with ``torch._foreach_*`` ops.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

Schedule = Callable[[int], float]


def epoch_decay_schedule(base_lr: float, steps_per_epoch: int, gamma: float = 0.95) -> Schedule:
    def schedule(step):
        return base_lr * gamma ** (step // max(1, steps_per_epoch))

    return schedule


def linear_warmup_schedule(base_lr: float, warmup_steps: int) -> Schedule:
    """torch LinearLR(total_iters=warmup) equivalent: ramps from
    base_lr/3 (torch's default start_factor) to base_lr."""

    def schedule(step):
        frac = min(step / max(1, warmup_steps), 1.0)
        return base_lr * (1.0 / 3.0 + (1.0 - 1.0 / 3.0) * frac)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule`` by its formula: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine to
    ``end_value`` over the remaining ``decay_steps - warmup_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(step):
        if step < warmup_steps:
            return (init_value - peak_value) * (1.0 - step / warmup_steps) + peak_value
        count = min(step - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def schedule_from_config(config, default_schedule: Schedule, steps_per_epoch: int) -> Schedule:
    """YAML ``LR_SCHEDULE`` overrides the family-default schedule. Absent or
    empty -> ``default_schedule``.

    * ``cosine`` — optional linear warmup over ``WARMUP_STEPS`` then cosine
      decay to ``LR_MIN`` (default 0) across NUM_EPOCHS x steps_per_epoch.
    * ``constant`` — optional linear warmup then flat LR.
    """
    kind = str(config.get("LR_SCHEDULE", "") or "").lower()
    if not kind:
        return default_schedule
    base = float(config.LR)
    warmup = int(config.get("WARMUP_STEPS", 0) or 0)
    total = max(1, int(config.get("NUM_EPOCHS", 1)) * max(1, steps_per_epoch))
    if kind == "cosine":
        total = max(total, warmup + 1)  # the cosine needs steps past the warmup
        return warmup_cosine_decay_schedule(
            init_value=0.0 if warmup else base, peak_value=base, warmup_steps=warmup,
            decay_steps=total, end_value=float(config.get("LR_MIN", 0.0) or 0.0),
        )
    if kind == "constant":
        if not warmup:
            return lambda step: base
        return lambda step: base * min((step + 1) / warmup, 1.0)
    raise ValueError(f"unknown LR_SCHEDULE {kind!r} (cosine | constant)")


class Adam:
    """optax ``adam`` / ``adamw`` over a dict of f32 parameters, after
    ``clip_by_global_norm`` when ``grad_clip`` is set. ``freeze_predicate``
    (parameter name -> bool) marks parameters that hold no state and take
    no update.

    ``init(params)`` returns the state ``{"count", "mu", "nu"}`` (moments
    for the trainable names only); ``update_(params, grads, state)``
    applies one step in place."""

    def __init__(self, lr_schedule: Schedule, betas=(0.9, 0.98), eps: float = 1e-9,
                 weight_decay: float = 0.0, grad_clip: Optional[float] = None,
                 freeze_predicate: Optional[Callable[[str], bool]] = None):
        self.lr_schedule = lr_schedule
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.grad_clip = grad_clip
        self.freeze_predicate = freeze_predicate

    def trainable(self, name: str) -> bool:
        return self.freeze_predicate is None or not self.freeze_predicate(name)

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        names = [n for n in params if self.trainable(n)]
        return {
            "count": 0,
            "mu": {n: torch.zeros_like(params[n]) for n in names},
            "nu": {n: torch.zeros_like(params[n]) for n in names},
        }

    @torch.no_grad()
    def update_(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                state: dict) -> None:
        """One step: ``grads`` holds an f32 gradient for every trainable
        name (the caller's zeros where the forward gave none); it may be
        scaled in place by the clip."""
        names = list(state["mu"])
        g = [grads[n] for n in names]
        p = [params[n] for n in names]
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        lr = float(self.lr_schedule(state["count"]))
        if self.grad_clip:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            torch._foreach_mul_(g, torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm))
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        count = state["count"] + 1
        denom = torch._foreach_div(nu, 1.0 - self.b2**count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(mu, 1.0 - self.b1**count)
        torch._foreach_div_(update, denom)
        if self.weight_decay:
            torch._foreach_add_(update, p, alpha=self.weight_decay)
        torch._foreach_add_(p, update, alpha=-lr)
        state["count"] = count


def build_optimizer(
    lr_schedule: Schedule,
    betas=(0.9, 0.98),
    eps: float = 1e-9,
    freeze_predicate: Optional[Callable[[str], bool]] = None,
    mu_dtype=None,
    kind: str = "adam",
    grad_clip: Optional[float] = None,
    weight_decay: float = 0.0,
) -> Adam:
    """``kind`` (YAML ``OPTIMIZER``): ``adam`` (the reference's), or
    ``adamw`` (decoupled weight decay ``WEIGHT_DECAY``, also implied by
    ``adam`` with ``WEIGHT_DECAY > 0``). ``adafactor`` and a reduced
    ``mu_dtype`` are not ported yet and raise."""
    if kind == "adafactor":
        raise NotImplementedError("OPTIMIZER: adafactor is not ported yet (ROADMAP A12)")
    if kind not in ("adam", "adamw"):
        raise ValueError(f"unknown OPTIMIZER {kind!r} (adam | adamw | adafactor)")
    if mu_dtype is not None:
        raise NotImplementedError("OPT_MU_DTYPE is not ported yet (ROADMAP A12)")
    return Adam(lr_schedule, betas, eps, weight_decay=weight_decay, grad_clip=grad_clip,
                freeze_predicate=freeze_predicate)


def mu_dtype_from_config(config):
    """YAML ``OPT_MU_DTYPE`` ('bfloat16'/'float32') -> the name, or None for
    f32 (the only type the port's adam keeps its moments in)."""
    name = config.get("OPT_MU_DTYPE", None)
    return None if name in (None, "", "float32") else name


def optimizer_kind_from_config(config) -> str:
    """YAML ``OPTIMIZER`` ('adam' | 'adamw' | 'adafactor'); default adam."""
    return str(config.get("OPTIMIZER", "adam") or "adam").lower()


def optimizer_extras_from_config(config) -> dict:
    """YAML ``GRAD_CLIP`` (float global-norm threshold, 0/absent = off) and
    ``WEIGHT_DECAY`` (decoupled decay rate, 0/absent = off) ->
    `build_optimizer` kwargs. Fails fast on nonsense values."""
    clip = float(config.get("GRAD_CLIP", 0) or 0)
    wd = float(config.get("WEIGHT_DECAY", 0) or 0)
    if clip < 0:
        raise ValueError(f"GRAD_CLIP must be > 0 (or 0/absent = off), got {clip}")
    if wd < 0:
        raise ValueError(f"WEIGHT_DECAY must be >= 0, got {wd}")
    return {"grad_clip": clip or None, "weight_decay": wd}


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor, pad_id: int,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Token-mean CE over non-pad targets (torch CrossEntropyLoss
    ignore_index semantics). logits (..., V), targets (...) int.

    ``label_smoothing`` a (YAML ``LABEL_SMOOTHING``): the smoothed CE
    (1-a)·NLL(target) - (a/V)·sum(logp), without a one-hot."""
    mask = (targets != pad_id).float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets[..., None].long())[..., 0]
    if label_smoothing:
        a = float(label_smoothing)
        ll = (1.0 - a) * ll + (a / logits.shape[-1]) * logp.sum(dim=-1)
    return -(ll * mask).sum() / mask.sum().clamp(min=1.0)
