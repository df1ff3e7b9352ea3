"""Megatron-style tensor parallelism over the mesh's ``model`` axis, on
plain ``torch.distributed``.

* **Collectives** (:func:`all_reduce`, :func:`all_gather_dim`,
  :func:`reduce_scatter_dim`): NCCL's own, and gloo's on CPU tensors. gloo
  on CUDA tensors has ``all_reduce`` and ``broadcast`` only; it serves one
  case, several processes sharing one card (:data:`SHARED_CARD_GLOO`, set by
  ``dryrun.run_mesh``, as NCCL refuses two ranks on one device), where a
  gather is an ``all_reduce`` of zero-padded shards and a reduce-scatter an
  ``all_reduce`` then a slice: the same values, more traffic. Anywhere else
  gloo on CUDA tensors raises.
* **Autograd pieces**: :func:`copy_to_tp` (identity forward, all-reduce of
  the gradient backward: before a column split), :func:`reduce_from_tp`
  (all-reduce forward, identity backward: after a row split) and
  :func:`gather_from_tp` (all-gather forward, the local slice backward).
* **Split layers** (:func:`parallelize_`, over the plan of
  ``parallel/mesh.py: tp_plan``): a column-split ``nn.Linear`` keeps its
  rows (output features) of this rank, a row-split one its columns (input
  features) and adds its bias after the all-reduce; a split embedding
  looks up the ids in its vocabulary range and all-reduces; a split
  attention runs ``H / tp`` heads, read off its local width, with its head
  slice of the relative bias (:func:`head_slice`, which sums the bias
  gradient over the ranks); a split FFN's inner dropout takes its slice of
  a full-width mask (its ``width_shard``). The tied LM head gives
  vocab-parallel logits, gathered for decoding, or kept local for
  :func:`vocab_parallel_cross_entropy` (a max and a sum-exp all-reduce).

Replicated parameters then get the same gradient on every rank of a model
group: every activation the ranks hold in common is all-reduced forward or
backward, so no replicated gradient needs a reduction over the ``model``
axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import types
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


# True in a process of a mesh whose ranks share one card over gloo
SHARED_CARD_GLOO = False


def _native(group, t: torch.Tensor) -> bool:
    """Whether ``group``'s backend has the gather / reduce-scatter
    collectives for ``t``'s device (gloo has them on the CPU only); False
    only for the shared-card stand-in."""
    if not (t.is_cuda and dist.get_backend(group) == "gloo"):
        return True
    if not SHARED_CARD_GLOO:
        raise RuntimeError("gloo has no all_gather / reduce_scatter on CUDA tensors: launch "
                           "one NCCL rank a card (torchrun), or pass --device cpu for gloo")
    return False


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place; returns ``t``."""
    if dist.get_world_size(group) > 1:
        dist.all_reduce(t, op=op, group=group)
    return t


@torch.no_grad()
def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim``, in rank order (no
    autograd: ``gather_from_tp`` is the differentiable one)."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    t = t.detach().contiguous()
    if _native(group, t):
        moved = t.movedim(dim, 0).contiguous()
        out = torch.empty((n * moved.shape[0],) + tuple(moved.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, moved, group=group)
        return out.movedim(0, dim).contiguous()
    rank = dist.get_rank(group)
    shape = list(t.shape)
    shape[dim] *= n
    out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    out.narrow(dim, rank * t.shape[dim], t.shape[dim]).copy_(t)
    dist.all_reduce(out, group=group)
    return out


@torch.no_grad()
def reduce_scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the ranks of ``t``, this rank's 1/n slice along ``dim``."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    t = t.detach()
    rank, size = dist.get_rank(group), t.shape[dim] // n
    if _native(group, t):
        moved = t.movedim(dim, 0).contiguous()
        out = torch.empty((size,) + tuple(moved.shape[1:]), dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, moved, group=group)
        return out.movedim(0, dim).contiguous()
    summed = t.clone()
    dist.all_reduce(summed, group=group)
    return summed.narrow(dim, rank * size, size).contiguous()


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherFromTP.apply(x, dim % x.dim(), group)


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's part ``[start, stop)`` of a dimension split over
    ``group``."""
    start: int
    stop: int
    group: object

    @property
    def size(self) -> int:
        return self.stop - self.start


def head_slice(bias: torch.Tensor, shard: Optional[Shard], dim: int) -> torch.Tensor:
    """``bias``'s heads of this rank along ``dim``; the full bias's gradient
    is summed over the model group, so a bias table that every rank holds
    whole gets the whole gradient on each."""
    if shard is None:
        return bias
    return copy_to_tp(bias, shard.group).narrow(dim, shard.start, shard.size)


def _column_forward(self, x):
    return F.linear(copy_to_tp(x, self.tp_group), self.weight, self.bias)


def _row_forward(self, x):
    y = reduce_from_tp(F.linear(x, self.weight), self.tp_group)
    return y if self.bias is None else y + self.bias


def _embedding_forward(self, ids):
    local = ids - self.vocab_shard.start
    inside = (local >= 0) & (local < self.vocab_shard.size)
    out = F.embedding(torch.where(inside, local, 0), self.weight)
    return reduce_from_tp(out * inside[..., None], self.vocab_shard.group)


def _narrow_param(module: nn.Module, name: str, dim: int, rank: int, tp: int) -> None:
    p = getattr(module, name)
    size = p.shape[dim] // tp
    part = p.detach().narrow(dim, rank * size, size).clone()
    setattr(module, name, nn.Parameter(part, requires_grad=p.requires_grad))


def parallelize_(model: nn.Module, plan: Dict[str, int], rank: int, tp: int, group) -> None:
    """Split ``model``'s modules in place by ``plan`` (parameter name -> the
    split dimension, ``parallel/mesh.py: tp_plan``): each parameter keeps
    this rank's part, and the modules that hold them run the collectives.
    Heads and widths are read off the local weights, so the model code is
    the same at any ``tp``."""
    if tp == 1:
        return
    modules = dict(model.named_modules())
    split_modules = {}
    for name, dim in plan.items():
        module_name, _, leaf = name.rpartition(".")
        split_modules.setdefault(module_name, {})[leaf] = dim
    for module_name, leaves in split_modules.items():
        module = modules[module_name]
        if isinstance(module, nn.Embedding):
            full = module.weight.shape[0]
            _narrow_param(module, "weight", 0, rank, tp)
            size = full // tp
            module.vocab_shard = Shard(rank * size, (rank + 1) * size, group)
            module.forward = types.MethodType(_embedding_forward, module)
            continue
        column = leaves["weight"] == 0
        for leaf in leaves:
            _narrow_param(module, leaf, leaves[leaf], rank, tp)
        module.out_features, module.in_features = module.weight.shape
        module.tp_group = group
        module.forward = types.MethodType(_column_forward if column else _row_forward, module)
    for module_name, module in modules.items():
        heads = getattr(module, "tp_bias_heads", None)
        if heads is not None and heads % tp == 0:
            size = heads // tp
            module.head_shard = Shard(rank * size, (rank + 1) * size, group)
        if hasattr(module, "width_shard"):
            columns, _, width = module.tp_layout()
            stem = f"{module_name}." if module_name else ""
            if f"{stem}{columns[0]}.weight" in plan:
                size = width // tp
                module.width_shard = Shard(rank * size, (rank + 1) * size, group)


@contextlib.contextmanager
def local_logits(t5):
    """Inside the block a tied, vocab-split LM head returns this rank's
    vocabulary slice of the logits (the training loss's
    :func:`vocab_parallel_cross_entropy`); yields that ``Shard``, or None
    where the head is whole."""
    shard = getattr(getattr(t5, "shared", None), "vocab_shard", None)
    if shard is None or not getattr(t5, "tied_head", False):
        yield None
        return
    t5.local_logits = True
    try:
        yield shard
    finally:
        t5.local_logits = False


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, shard: Shard,
                                 label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-token log-likelihood of ``targets`` (the smoothed one with
    ``label_smoothing``) from this rank's vocabulary slice of the logits:
    the log-sum-exp from a max and a sum-exp all-reduce, the target's logit
    from the rank that holds it. Every rank returns the same values."""
    x = logits.float()
    m = x.detach().max(dim=-1).values
    all_reduce(m, shard.group, dist.ReduceOp.MAX)
    lse = m + torch.log(reduce_from_tp(torch.exp(x - m[..., None]).sum(-1), shard.group))
    local = targets.long() - shard.start
    inside = (local >= 0) & (local < shard.size)
    picked = x.gather(-1, torch.where(inside, local, 0)[..., None])[..., 0]
    ll = reduce_from_tp(picked * inside, shard.group) - lse
    if label_smoothing:
        a = float(label_smoothing)
        vocab = shard.size * dist.get_world_size(shard.group)
        sum_logp = reduce_from_tp(x.sum(-1), shard.group) - vocab * lse
        ll = (1.0 - a) * ll + (a / vocab) * sum_logp
    return ll
