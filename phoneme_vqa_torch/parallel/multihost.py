"""Process-group start-up for training across cards (counterpart of
``phoneme_vqa_tpu/parallel/multihost.py``).

``torchrun --nproc-per-node N -m phoneme_vqa_torch.run ...`` sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in each
process; :func:`maybe_initialize_distributed` reads them and joins the
group: NCCL on the card (each process on ``cuda:LOCAL_RANK``), gloo when the
caller asked for the CPU. It runs when the config sets ``MULTIHOST: true``
or ``WORLD_SIZE`` is above 1; in a single process it does nothing. It is
idempotent, and a failure to start NCCL raises: no run falls back to the
CPU or to a world of one.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from ..utils.logger import get_logger

log = get_logger(__name__)


def maybe_initialize_distributed(config=None, device="cuda", timeout_s: float = None) -> bool:
    """Join the process group a launcher describes. Returns whether a
    group is up (started here or before). ``timeout_s`` bounds every
    collective of the group (a rank that died or hangs fails its peers' next
    collective after at most that long; the serve CLI passes
    ``--group-timeout``); None keeps torch's default."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    want = bool(config and config.get("MULTIHOST")) or world > 1
    if not want:
        return False
    if dist.is_initialized():
        return True
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT", "29500")
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a multi-process launch on the card needs CUDA; pass "
                               "--device cpu for gloo processes on the CPU")
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    else:
        backend = "gloo"
    kw = {} if timeout_s is None else {"timeout": timedelta(seconds=float(timeout_s))}
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                            world_size=world, **kw)
    log.info(f"# torch.distributed up: rank {rank}/{world} ({backend}, local rank {local_rank})")
    return True


def local_device(device="cuda") -> torch.device:
    """The device of this process: ``cuda:LOCAL_RANK`` on the card (modulo
    the cards there are, so two processes may share one), else the CPU."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not dist.is_initialized():
        return device
    local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local_rank % max(torch.cuda.device_count(), 1))
