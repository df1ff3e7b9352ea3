"""The (data, model) mesh (counterpart of ``phoneme_vqa_tpu/parallel/mesh.py``).

``MESH: {data: N, model: M}`` lays the processes of a ``torch.distributed``
group out as a ``DeviceMesh`` of N data-parallel rows of M tensor-parallel
ranks (``data: -1``: every rank the model axis leaves). The world size must
be exactly N x M: every process is on the mesh.

* ``data``: each data rank trains on its interleaved rows of the global
  batch and the gradients are summed over the axis
  (``parallel/optimizer.py``); eval decodes each batch's rows split over the
  axis (:func:`shard_rows`), falling back to every rank decoding the whole
  batch, with one warning, when a batch does not divide the axis.
* ``model``: Megatron-style tensor parallelism (:func:`tp_plan`, carried
  out by ``parallel/tensor_parallel.py``): attention ``q/k/v`` and FFN
  ``wi*`` split by output features (columns of the flax kernel), ``o`` /
  ``wo`` by input features (rows), the T5 word embedding over its
  vocabulary. The port splits a module only where its heads (or inner
  width, or vocabulary) divide ``M``, and splits a pair (``q/k/v`` with
  ``o``) together, so each split layer runs on local data; it therefore
  splits a few layers the JAX package leaves whole (the ViT's, the custom
  decoder's ``out`` and FFN), never fewer of the large ones.
* ZeRO-1 (``MESH: {zero1: true}``): optimizer moments split over the
  ``data`` axis on a dimension the plan left whole (``parallel/optimizer.py``).
* Serving (``serving/engine.py``, ``serving/continuous.py``): a served
  batch's bucket is a multiple of ``data`` and each data rank decodes its
  block of the bucket's rows (:func:`serve_rows`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils.logger import get_logger

log = get_logger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(eq=False)
class Mesh:
    """A ``DeviceMesh`` with dims (``data``, ``model``) and this process's
    place on it."""
    device_mesh: DeviceMesh
    zero1: bool = False
    _warned_replicated: bool = False

    @property
    def dp(self) -> int:
        return self.device_mesh.size(0)

    @property
    def tp(self) -> int:
        return self.device_mesh.size(1)

    @property
    def dp_rank(self) -> int:
        return self.device_mesh.get_local_rank(DATA_AXIS)

    @property
    def tp_rank(self) -> int:
        return self.device_mesh.get_local_rank(MODEL_AXIS)

    @property
    def dp_group(self):
        return self.device_mesh.get_group(DATA_AXIS)

    @property
    def tp_group(self):
        return self.device_mesh.get_group(MODEL_AXIS)

    @property
    def is_main(self) -> bool:
        """Rank 0 of the world: it writes results, metrics and checkpoints."""
        return dist.get_rank() == 0

    @property
    def backend(self) -> str:
        return dist.get_backend()

    def describe(self) -> str:
        return (f"data {self.dp} x model {self.tp} over {self.backend} "
                f"(rank {dist.get_rank()}: data rank {self.dp_rank}, model rank {self.tp_rank})")


def mesh_dims(mesh_cfg, world: int):
    """(data, model) from the ``MESH`` dict over ``world`` processes."""
    tp = int(mesh_cfg.get("model", 1) or 1) if mesh_cfg else 1
    dp = int(mesh_cfg.get("data", -1) or -1) if mesh_cfg else -1
    if dp <= 0:
        dp = max(1, world // tp)
    if dp * tp > world:
        raise ValueError(f"MESH data={dp} x model={tp} needs {dp * tp} devices, have {world}")
    if dp * tp < world:
        raise ValueError(f"MESH data={dp} x model={tp} covers {dp * tp} of {world} processes: "
                         "every process must be on the mesh (launch data x model processes)")
    return dp, tp


def create_mesh(mesh_cfg, device_type: str) -> Mesh:
    """The mesh over the initialized process group (``multihost``)."""
    dp, tp = mesh_dims(mesh_cfg, dist.get_world_size())
    device_mesh = init_device_mesh(device_type, (dp, tp), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    zero1 = bool(mesh_cfg.get("zero1")) if mesh_cfg else False
    return Mesh(device_mesh, zero1=zero1)


def pad_batch_to_devices(batch_size: int, n_devices: int) -> int:
    """Round a batch size up so it divides evenly over the data axis."""
    return -(-batch_size // n_devices) * n_devices


def shard_rows(mesh: Optional[Mesh], n_rows: int) -> Optional[slice]:
    """This data rank's rows of a batch of ``n_rows`` (a contiguous
    1/data block), or None (every rank takes the whole batch) without a
    data axis or, with one warning per mesh, when the batch does not divide
    it: correct, but every rank then computes the full batch."""
    if mesh is None or mesh.dp == 1:
        return None
    if n_rows % mesh.dp:
        if not mesh._warned_replicated:
            mesh._warned_replicated = True
            log.warning(f"(!) batch size [{n_rows}] does not divide the data axis ({mesh.dp}): "
                        f"falling back to REPLICATED placement: every rank computes the full "
                        f"batch ({mesh.dp}x slower than data-parallel). Pick a batch size "
                        f"divisible by {mesh.dp} (pad_batch_to_devices) to restore DP.")
        return None
    size = n_rows // mesh.dp
    return slice(mesh.dp_rank * size, (mesh.dp_rank + 1) * size)


def serve_rows(mesh: Optional[Mesh], n_rows: int, bucket: int) -> slice:
    """This data rank's slice of a served batch of ``n_rows`` requests: the
    batch rides a ``bucket`` of rows, a multiple of the data axis (the
    engines round their buckets up to one), split over the axis by
    :func:`shard_rows`; the rank's block is cut to the requests there are
    (it may hold none), and the loader pads it back to ``bucket / data``
    rows, as :func:`pad_batch_to_devices` pads a batch."""
    dp = 1 if mesh is None else mesh.dp
    if bucket % dp:
        raise ValueError(f"bucket {bucket} does not divide the data axis ({dp})")
    block = shard_rows(mesh, bucket) or slice(0, bucket)
    return slice(min(block.start, n_rows), min(block.stop, n_rows))


def shard_batch(mesh: Optional[Mesh], batch: dict) -> dict:
    """This data rank's rows of every leaf (all of them when
    :func:`shard_rows` falls back)."""
    sizes = {len(v) for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"ragged batch: {sorted(sizes)}")
    rows = shard_rows(mesh, sizes.pop())
    return batch if rows is None else {k: v[rows] for k, v in batch.items()}


def tp_plan(model: nn.Module, tp: int) -> Dict[str, int]:
    """Parameter name -> the dimension split over the model axis (torch
    layout: a column split is dim 0 of a Linear weight and of its bias, a
    row split dim 1). A module declares its pair with ``tp_layout()`` ->
    (column Linear names, row Linear names, the count that must divide
    ``tp``: heads or inner width); the T5 word embedding is split over its
    vocabulary where ``tp`` divides it. Empty at ``tp == 1``."""
    plan: Dict[str, int] = {}
    if tp == 1:
        return plan
    for prefix, module in model.named_modules():
        stem = f"{prefix}." if prefix else ""
        layout = getattr(module, "tp_layout", None)
        if layout is not None:
            columns, rows, units = layout()
            if units % tp:
                continue
            for name in columns:
                lin = getattr(module, name)
                plan[f"{stem}{name}.weight"] = 0
                if lin.bias is not None:
                    plan[f"{stem}{name}.bias"] = 0
            for name in rows:
                plan[f"{stem}{name}.weight"] = 1
        for name in getattr(module, "tp_vocab_embeddings", ()):
            if getattr(module, name).weight.shape[0] % tp == 0:
                plan[f"{stem}{name}.weight"] = 0
    return plan


def shard_tensor(t, dim: int, rank: int, parts: int):
    """``t``'s part ``rank`` of ``parts`` along ``dim`` (a view)."""
    size = t.shape[dim] // parts
    return t.narrow(dim, rank * size, size)
