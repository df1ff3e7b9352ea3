"""The optimizer step over a mesh (what XLA derives from the shardings in
the JAX package): data-parallel gradient sums, the global-norm clip over
split parameters, ZeRO-1, and the gather and split of checkpoints.

:class:`MeshOptimizer` wraps ``train/optim.py``'s ``Adam`` or ``Adafactor``
over this rank's parameters (its tensor-parallel parts, ``parallel/mesh.py:
tp_plan``):

1. each gradient is summed over the ``data`` axis (one all-reduce over the
   flattened gradients), or, for a ZeRO-1 parameter, reduce-scattered along
   its ZeRO dimension. The loss is already the global token mean (the
   executor divides each rank's sum by the all-reduced token count), so the
   sum is the gradient of the global loss: no average of per-rank means;
2. the clip's norm counts each element of the global model once: a split
   parameter's squares are summed over the ``model`` axis, a ZeRO part's
   over the ``data`` axis, a replicated one's not at all;
3. the wrapped rule runs on the parts (a ZeRO-1 parameter's moments and
   update on its 1/data slice of the master, a view);
4. ZeRO slices are all-gathered back into the masters.

Adafactor's factored statistics of a split parameter reduce over the axis
that splits each of its dimensions (``Adafactor.view_splits``): the
``model`` axis for a tensor-parallel split, the ``data`` axis for a ZeRO-1
one. Under ZeRO-1 its row and column moments are split over the data axis
with the parameter, but for the moment of the dimension ZeRO splits, which
is the mean over that dimension and is kept whole.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..train.optim import Adafactor
from .mesh import Mesh, shard_tensor
from .tensor_parallel import all_gather_dim, all_reduce, reduce_scatter_dim


class MeshOptimizer:
    def __init__(self, tx, mesh: Mesh, split_dims: Dict[str, int],
                 full_shapes: Dict[str, Tuple[int, ...]]):
        self.tx, self.mesh = tx, mesh
        self.split = dict(split_dims)
        self.full_shapes = dict(full_shapes)
        self.grad_clip, tx.grad_clip = tx.grad_clip, None  # the clip runs here, over the mesh
        self.zero1 = mesh.zero1 and mesh.dp > 1
        self.adafactor = isinstance(tx, Adafactor)
        self.zero_dims: Dict[str, int] = {}
        if self.adafactor:
            tx.global_shapes = {n: tuple(self._view_shape(n, s)) for n, s in full_shapes.items()}
            self._set_view_splits()

    def trainable(self, name: str) -> bool:
        return self.tx.trainable(name)

    # -- layouts --------------------------------------------------------------

    def _view_dim(self, name: str, dim: int) -> int:
        """A torch-layout dimension in adafactor's flax view ((in, out), or
        (kh, kw, in, out) for a conv's (out, in, kh, kw))."""
        if name not in self.tx.kernels:
            return dim
        return 1 - dim if len(self.full_shapes[name]) == 2 else (3, 2, 0, 1)[dim]

    def _view_axes(self, name: str) -> Dict[int, str]:
        """Adafactor's view dims of ``name`` that are split -> the axis
        (``model`` or ``data``)."""
        axes = {}
        if name in self.split:
            axes[self._view_dim(name, self.split[name])] = "model"
        if name in self.zero_dims:
            axes[self._view_dim(name, self.zero_dims[name])] = "data"
        return axes

    def _set_view_splits(self) -> None:
        groups = {"model": self.mesh.tp_group, "data": self.mesh.dp_group}
        self.tx.view_splits = {n: {d: groups[a] for d, a in self._view_axes(n).items()}
                               for n in set(self.split) | set(self.zero_dims)}

    def _view_shape(self, name: str, shape):
        if name not in self.tx.kernels:
            return shape
        return shape[::-1] if len(shape) == 2 else (shape[2], shape[3], shape[1], shape[0])

    def _zero_dim(self, name: str, shape) -> Optional[int]:
        for d, size in enumerate(shape):
            if d != self.split.get(name) and size % self.mesh.dp == 0 and size >= self.mesh.dp:
                return d
        return None

    def _part(self, name: str, t: torch.Tensor) -> torch.Tensor:
        d = self.zero_dims.get(name)
        return t if d is None else shard_tensor(t, d, self.mesh.dp_rank, self.mesh.dp)

    def _state_dims(self, part: str, name: str) -> Tuple[Optional[int], Optional[int]]:
        """(model-axis dim, data-axis dim) of a state tensor of ``name``."""
        if not self.adafactor:
            return self.split.get(name), self.zero_dims.get(name)
        axes = self._view_axes(name)
        if part != "v":  # a factored moment: the mean over one view dim
            d1, d0 = self.tx._factored_dims(self.tx.global_shapes[name])
            gone = d0 if part == "v_row" else d1
            axes = {d - (d > gone): a for d, a in axes.items() if d != gone}
        dims = {a: d for d, a in axes.items()}
        return dims.get("model"), dims.get("data")

    # -- the step -------------------------------------------------------------

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        if self.zero1:
            self.zero_dims = {}
            for n, p in params.items():
                d = self._zero_dim(n, p.shape) if self.trainable(n) else None
                if d is not None:
                    self.zero_dims[n] = d
            if self.adafactor:
                self._set_view_splits()
        return self.tx.init({n: self._part(n, p) for n, p in params.items()})

    def _global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        device = next(iter(grads.values())).device
        sq = torch.zeros(4, dtype=torch.float32, device=device)  # split/whole x full/zero
        for n, g in grads.items():
            k = (0 if n in self.split else 2) + (1 if n in self.zero_dims else 0)
            sq[k] += g.float().square().sum()
        over_data = all_reduce(sq[[1, 3]].clone(), self.mesh.dp_group)
        over_model = all_reduce(torch.stack([sq[0], over_data[0]]), self.mesh.tp_group)
        return torch.sqrt(over_model.sum() + sq[2] + over_data[1])

    @torch.no_grad()
    def update_(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                state: dict) -> None:
        dp_group = self.mesh.dp_group
        whole = [grads[n] for n in grads if n not in self.zero_dims]
        if whole and self.mesh.dp > 1:
            flat = all_reduce(_flatten_dense_tensors(whole), dp_group)
            torch._foreach_copy_(whole, _unflatten_dense_tensors(flat, whole))
        for n, d in self.zero_dims.items():
            if n in grads:
                grads[n] = reduce_scatter_dim(grads[n], d, dp_group)
        if self.grad_clip:
            norm = self._global_norm(grads)
            torch._foreach_mul_(list(grads.values()),
                                torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm))
        self.tx.update_({n: self._part(n, p) for n, p in params.items()}, grads, state)
        for n, d in self.zero_dims.items():
            params[n].copy_(all_gather_dim(self._part(n, params[n]), d, dp_group))

    # -- checkpoints: full tensors on every rank, and back -------------------------

    def _gather(self, t: torch.Tensor, model_dim, data_dim) -> torch.Tensor:
        if data_dim is not None:
            t = all_gather_dim(t, data_dim, self.mesh.dp_group)
        if model_dim is not None:
            t = all_gather_dim(t, model_dim, self.mesh.tp_group)
        return t

    def _shard(self, t: torch.Tensor, model_dim, data_dim) -> torch.Tensor:
        if model_dim is not None:
            t = shard_tensor(t, model_dim, self.mesh.tp_rank, self.mesh.tp)
        if data_dim is not None:
            t = shard_tensor(t, data_dim, self.mesh.dp_rank, self.mesh.dp)
        return t.clone()

    def gather_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {n: self._gather(t, self.split.get(n), None) for n, t in params.items()}

    def _map_state(self, state: dict, fn) -> dict:
        out = {}
        for part, value in state.items():
            if isinstance(value, dict):
                out[part] = {n: fn(t, *self._state_dims(part, n)) for n, t in value.items()}
            else:
                out[part] = value
        return out

    def gather_state(self, state: dict) -> dict:
        """The optimizer state as one process holds it."""
        return self._map_state(state, self._gather)

    def shard_state(self, state: dict) -> dict:
        """A one-process optimizer state as this rank's parts."""
        return self._map_state(state, self._shard)
