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
  runs over the trainable parameters only;
* adafactor is optax's (:class:`Adafactor`), not ``torch.optim``'s.

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
                 freeze_predicate: Optional[Callable[[str], bool]] = None,
                 mu_dtype: Optional[torch.dtype] = None):
        self.lr_schedule = lr_schedule
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.grad_clip = grad_clip
        self.freeze_predicate = freeze_predicate
        self.mu_dtype = mu_dtype

    def trainable(self, name: str) -> bool:
        return self.freeze_predicate is None or not self.freeze_predicate(name)

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        names = [n for n in params if self.trainable(n)]
        return {
            "count": 0,
            "mu": {n: torch.zeros_like(params[n], dtype=self.mu_dtype) for n in names},
            "nu": {n: torch.zeros_like(params[n]) for n in names},
        }

    def _clip_(self, g) -> None:
        if self.grad_clip:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            torch._foreach_mul_(g, torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm))

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
        self._clip_(g)
        if self.mu_dtype is None:
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
            stored = mu
        else:
            # optax's mu_dtype: the moment decays in its stored type (b1
            # rounded to it), the sum and the update run in f32, the new
            # moment is stored rounded
            b1 = float(torch.tensor(self.b1, dtype=self.mu_dtype))
            stored, mu = mu, [m.float() for m in torch._foreach_mul(mu, b1)]
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
        if stored is not mu:
            torch._foreach_copy_(stored, mu)
        state["count"] = count


def _flax_view(t: torch.Tensor, kernel: bool) -> torch.Tensor:
    """A Linear or Conv weight viewed in flax's layout ((in, out), (kh, kw,
    in, out)), where adafactor's factored axes are chosen; other parameters
    as they are."""
    if not kernel:
        return t
    return t.t() if t.dim() == 2 else t.permute(2, 3, 1, 0)


class Adafactor:
    """``optax.adafactor(lr, multiply_by_parameter_scale=False,
    momentum=None, weight_decay_rate=wd)`` by its rule, over a dict of f32
    parameters (optax 0.2.6: ``scale_by_factored_rms`` with decay 0.8, eps
    1e-30 and factoring when the second-largest axis has >= 128 entries,
    then ``clip_by_block_rms(1.0)``, the learning rate, the decayed weights
    added after it, and the sign). Not ``torch.optim.Adafactor``, whose
    rule differs. ``kernels`` names the Linear and Conv weights: their
    statistics are kept in flax's layout, so the factored axes are the JAX
    package's.

    The state is ``{"count", "v_row", "v_col", "v"}`` over the trainable
    names (a factored parameter holds its row and column vectors, the
    others ``v``); there is no first moment."""

    def __init__(self, lr_schedule: Schedule, weight_decay: float = 0.0,
                 grad_clip: Optional[float] = None,
                 freeze_predicate: Optional[Callable[[str], bool]] = None,
                 kernels=(), min_dim_size_to_factor: int = 128, decay_rate: float = 0.8,
                 clipping_threshold: float = 1.0, eps: float = 1e-30):
        self.lr_schedule = lr_schedule
        self.weight_decay = float(weight_decay)
        self.grad_clip = grad_clip
        self.freeze_predicate = freeze_predicate
        self.kernels = set(kernels)
        self.min_dim = min_dim_size_to_factor
        self.decay_rate = decay_rate
        self.clipping_threshold = clipping_threshold
        self.eps = eps
        # over a mesh (``parallel/optimizer.py``): each split parameter's
        # split dimensions in flax's view, each with the group it is split
        # over (the model axis's, and ZeRO-1's data axis), and every
        # parameter's global shape in that view, so the factored axes and
        # the means are the one-process ones
        self.view_splits: Dict[str, Dict[int, object]] = {}
        self.global_shapes: Dict[str, tuple] = {}

    trainable = Adam.trainable
    _clip_ = Adam._clip_

    def _factored_dims(self, shape):
        if len(shape) < 2:
            return None
        order = sorted(range(len(shape)), key=lambda i: shape[i])  # np.argsort's order
        if shape[order[-2]] < self.min_dim:
            return None
        return order[-2], order[-1]

    def _shape(self, name: str, view: torch.Tensor) -> tuple:
        return self.global_shapes.get(name, tuple(view.shape))

    @staticmethod
    def _mean(t: torch.Tensor, dim: int, splits: dict, length: int,
              keepdim: bool = False) -> torch.Tensor:
        """``t.mean(dim)`` over the global tensor: summed over the group that
        splits ``dim``, where one does (``length``: its global size)."""
        group = splits.get(dim)
        if group is None:
            return t.mean(dim, keepdim=keepdim)
        from ..parallel.tensor_parallel import all_reduce

        return all_reduce(t.sum(dim, keepdim=keepdim), group) / length

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        state = {"count": 0, "v_row": {}, "v_col": {}, "v": {}}
        for n, p in params.items():
            if not self.trainable(n):
                continue
            view = _flax_view(p, n in self.kernels)
            dims = self._factored_dims(self._shape(n, view))
            if dims is None:
                state["v"][n] = torch.zeros_like(view)
            else:
                d1, d0 = dims
                state["v_row"][n] = torch.zeros_like(view.sum(d0))
                state["v_col"][n] = torch.zeros_like(view.sum(d1))
        return state

    @torch.no_grad()
    def update_(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                state: dict) -> None:
        names = [n for n in params if n in state["v"] or n in state["v_row"]]
        self._clip_([grads[n] for n in names])
        count = state["count"]
        # the decay schedule in f32, as optax computes it
        decay = 1.0 - torch.tensor(count + 1, dtype=torch.float32) ** -self.decay_rate
        keep = 1.0 - decay
        lr = float(self.lr_schedule(count))
        for n in names:
            kernel = n in self.kernels
            g = _flax_view(grads[n], kernel)
            grad_sqr = g * g + self.eps
            shape, splits = self._shape(n, g), self.view_splits.get(n, {})
            if n in state["v"]:
                v = state["v"][n]
                v.copy_(decay * v + keep * grad_sqr)
                update = g * v ** -0.5
            else:
                d1, d0 = self._factored_dims(shape)
                v_row, v_col = state["v_row"][n], state["v_col"][n]
                v_row.copy_(decay * v_row + keep * self._mean(grad_sqr, d0, splits, shape[d0]))
                v_col.copy_(decay * v_col + keep * self._mean(grad_sqr, d1, splits, shape[d1]))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_splits = {d - (d > d0): grp for d, grp in splits.items() if d != d0}
                row_mean = self._mean(v_row, reduced_d1, row_splits, shape[d1], keepdim=True)
                row_factor = (v_row / row_mean) ** -0.5
                update = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
            if not splits:
                rms = update.square().mean().sqrt()
            else:
                from ..parallel.tensor_parallel import all_reduce

                total = update.square().sum()
                for group in splits.values():
                    total = all_reduce(total, group)
                rms = (total / math.prod(shape)).sqrt()
            update = update / torch.clamp(rms / self.clipping_threshold, min=1.0)
            update = lr * update
            p = _flax_view(params[n], kernel)
            if self.weight_decay:
                update = update + self.weight_decay * p
            p.sub_(update)
        state["count"] = count + 1


def build_optimizer(
    lr_schedule: Schedule,
    betas=(0.9, 0.98),
    eps: float = 1e-9,
    freeze_predicate: Optional[Callable[[str], bool]] = None,
    mu_dtype=None,
    kind: str = "adam",
    grad_clip: Optional[float] = None,
    weight_decay: float = 0.0,
    kernels=(),
):
    """``kind`` (YAML ``OPTIMIZER``): ``adam`` (the reference's), ``adamw``
    (decoupled weight decay ``WEIGHT_DECAY``, also implied by ``adam`` with
    ``WEIGHT_DECAY > 0``), or ``adafactor`` (:class:`Adafactor`; betas and
    eps are adam's and ignored; ``kernels`` names the Linear and Conv
    weights). ``mu_dtype`` (YAML ``OPT_MU_DTYPE: bfloat16``) stores adam's
    first moment in that type."""
    if kind == "adafactor":
        return Adafactor(lr_schedule, weight_decay=weight_decay, grad_clip=grad_clip,
                         freeze_predicate=freeze_predicate, kernels=kernels)
    if kind not in ("adam", "adamw"):
        raise ValueError(f"unknown OPTIMIZER {kind!r} (adam | adamw | adafactor)")
    return Adam(lr_schedule, betas, eps, weight_decay=weight_decay, grad_clip=grad_clip,
                freeze_predicate=freeze_predicate, mu_dtype=mu_dtype)


def mu_dtype_from_config(config) -> Optional[torch.dtype]:
    """YAML ``OPT_MU_DTYPE`` ('bfloat16'/'float32') -> the torch dtype, or
    None for f32."""
    name = config.get("OPT_MU_DTYPE", None)
    if name in (None, "", "float32"):
        return None
    if name not in ("bfloat16", "float16"):
        raise ValueError(f"unknown OPT_MU_DTYPE {name!r} (bfloat16 | float16 | float32)")
    return getattr(torch, name)


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
                       label_smoothing: float = 0.0, count: Optional[torch.Tensor] = None,
                       vocab_shard=None) -> torch.Tensor:
    """Token-mean CE over non-pad targets (torch CrossEntropyLoss
    ignore_index semantics). logits (..., V), targets (...) int.

    ``label_smoothing`` a (YAML ``LABEL_SMOOTHING``): the smoothed CE
    (1-a)·NLL(target) - (a/V)·sum(logp), without a one-hot.

    Over a mesh: ``count`` is the non-pad token count of the global batch
    (the data ranks' counts summed), so each rank's loss is its share of the
    global token mean and the ranks' gradients sum to the gradient of that
    mean; ``vocab_shard`` (``parallel.tensor_parallel.Shard``) marks
    ``logits`` as this rank's vocabulary slice
    (``vocab_parallel_cross_entropy``)."""
    mask = (targets != pad_id).float()
    if vocab_shard is not None:
        from ..parallel.tensor_parallel import vocab_parallel_cross_entropy

        ll = vocab_parallel_cross_entropy(logits, targets, vocab_shard, label_smoothing)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = logp.gather(-1, targets[..., None].long())[..., 0]
        if label_smoothing:
            a = float(label_smoothing)
            ll = (1.0 - a) * ll + (a / logits.shape[-1]) * logp.sum(dim=-1)
    denominator = mask.sum() if count is None else count
    return -(ll * mask).sum() / denominator.clamp(min=1.0)
