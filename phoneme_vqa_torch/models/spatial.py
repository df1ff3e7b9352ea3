"""2D layout (bounding-box) embedding (counterpart of
``phoneme_vqa_tpu/models/spatial.py``): six tables (x0, y0, x1, y1, width,
height) over 1024 position buckets in one (6, buckets, d) parameter; a
lookup is one gather + sum over the component axis."""

from __future__ import annotations

import torch
from torch import nn


class SpatialModule(nn.Module):
    def __init__(self, max_2d_positions: int = 1024, d_model: int = 768,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.max_2d_positions = max_2d_positions
        self.dtype = dtype
        self.tables = nn.Parameter(
            torch.zeros(6, max_2d_positions, d_model, device=device, dtype=torch.float32)
        )

    def forward(self, coordinates: torch.Tensor) -> torch.Tensor:
        """coordinates (B, L, 6) int -> (B, L, d_model)."""
        coords = coordinates.long().clamp(0, self.max_2d_positions - 1)
        component = torch.arange(6, device=coords.device)
        gathered = self.tables[component, coords]  # (B, L, 6, d)
        return gathered.sum(dim=2).to(self.dtype)
