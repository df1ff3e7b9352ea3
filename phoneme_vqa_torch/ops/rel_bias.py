"""T5 relative position bucketing (counterpart of ``phoneme_vqa_tpu/ops/rel_bias.py``).

Half the buckets are exact small offsets, the other half log-spaced up to
``max_distance``; the bidirectional variant splits buckets between signs.
"""

from __future__ import annotations

import math

import torch


def relative_position_bucket(
    relative_position: torch.Tensor,
    bidirectional: bool = True,
    num_buckets: int = 32,
    max_distance: int = 128,
) -> torch.Tensor:
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(relative_position.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)

    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = torch.log(n.float() / max_exact + 1e-20) / math.log(max_distance / max_exact)
    val_if_large = max_exact + (log_ratio * (num_buckets - max_exact)).to(relative_position.dtype)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)
