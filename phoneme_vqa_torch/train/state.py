"""Training state and f32 master weights (counterpart of
``phoneme_vqa_tpu/train/state.py``).

Flax keeps every parameter in f32 and casts the Dense kernels to the
compute dtype at each call. The port keeps that split explicitly:

* ``TrainState.params`` holds an f32 master of every model parameter by
  name. A module parameter that is f32 itself (norm scales, embeddings, the
  relative-bias and spatial tables) *is* its master; a bf16 compute weight
  (the Linear and Conv weights of a bf16 model) has a separate f32 master.
* After a step, :func:`refresh_compute_weights_` copies the updated masters
  into their bf16 weights with one ``torch._foreach_copy_``; before it,
  :func:`master_grads` casts each bf16 weight's gradient up to f32, which is
  the vjp of flax's ``astype``. Serving reads the module as before.

In an f32 model every master is its module parameter: one set of weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]  # f32 master of every parameter, by name
    opt_state: Any
    step: int = 0
    epoch: int = 0

    @classmethod
    def create(cls, params: Dict[str, torch.Tensor], tx) -> "TrainState":
        return cls(params=params, opt_state=tx.init(params), step=0, epoch=0)


def bind_params(model: nn.Module, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Loads f32 ``params`` (every parameter of ``model`` by name, on any
    device) into ``model`` and returns its masters: the module parameter
    where it is f32, else ``params[name]`` as f32 on the model's device (no
    copy when it already is one). Raises KeyError on a missing or extra
    name and ValueError on a shape that disagrees."""
    named = dict(model.named_parameters())
    if set(named) != set(params):
        raise KeyError(f"parameters missing {sorted(set(named) - set(params))}, "
                       f"unknown {sorted(set(params) - set(named))}")
    masters = {}
    with torch.no_grad():
        for name, p in named.items():
            value = params[name]
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(value.shape)}, the model's {tuple(p.shape)}")
            p.copy_(value)
            masters[name] = p if p.dtype == torch.float32 else value.to(p.device, torch.float32)
    return masters


def compute_copies(model: nn.Module, params: Dict[str, torch.Tensor], names: Iterable[str]
                   ) -> List[tuple]:
    """(module weight, master) for each of ``names`` whose module weight is
    a separate compute copy (not f32)."""
    named = dict(model.named_parameters())
    return [(named[n], params[n]) for n in names if named[n] is not params[n]]


def master_grads(model: nn.Module, params: Dict[str, torch.Tensor], names: Iterable[str]
                 ) -> Dict[str, torch.Tensor]:
    """The f32 gradient of each named master: the module parameter's
    gradient, cast up from a compute copy's dtype, zeros where the forward
    gave none (the optimizer sees a full gradient, as optax does)."""
    named = dict(model.named_parameters())
    out = {}
    for n in names:
        g = named[n].grad
        out[n] = torch.zeros_like(params[n]) if g is None else g.float()
    return out


def refresh_compute_weights_(copies: List[tuple]) -> None:
    """Copy updated masters into their compute copies (``compute_copies``)."""
    if copies:
        with torch.no_grad():
            torch._foreach_copy_([w for w, _ in copies], [m for _, m in copies])
