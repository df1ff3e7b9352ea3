"""SaL 2D relative position bias: a T5 1D sequence bias plus the SCP spatial
bias (counterpart of ``phoneme_vqa_tpu/models/rel_bias_2d.py``).

* 1D: T5-style bucketed sequence-distance bias over the whole fused
  sequence (bidirectional, 32 buckets, max distance 128).
* SCP ("Spatial Circle Position"): OCR bbox centres snap to an 11 x 11 grid;
  the euclidean grid distance x5 is bucketed (bidirectional, 32 buckets,
  max distance 100) and embedded, between OCR tokens only.

The bias is returned in factored form (``ops.sal_fused_attention.
FusedSalBias``): the 1D bias (H, L, L), the SCP bias between grid cells
(H, 122, 122, with a zero sentinel row and column) and each token's cell
(B, L). Tokens outside the OCR block ``[max_ques, max_ques + max_ocr)`` get
the sentinel. Inside it, the cell comes from the token's box as it stands:
the OCR block's PAD positions (box zeros) get cell 0, and its EOS position
(box 0.9999^4) cell 120, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.rel_bias import relative_position_bucket
from ..ops.sal_fused_attention import SENTINEL, FusedSalBias

GRID = 11


def _grid_distance_table() -> np.ndarray:
    """(121, 121) int32: euclidean distance between grid cells x5, floored."""
    xs, ys = np.mgrid[0:GRID, 0:GRID]
    cells = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float64)
    diff = cells[:, None, :] - cells[None, :, :]
    return (np.sqrt((diff**2).sum(-1)) * 5).astype(np.int32)


class Sal2DPositionBias(nn.Module):
    """Submodules ``rel1d`` and ``scp`` are the flax ``Embed`` tables
    (32, H), f32."""

    def __init__(self, num_heads: int, num_buckets: int = 32, max_distance_1d: int = 128,
                 max_distance_scp: int = 100, augmentation: bool = False, device=None):
        super().__init__()
        if augmentation:
            raise NotImplementedError(
                "Sal2DPositionBias: the train-time distance augmentation is not ported")
        self.num_buckets = num_buckets
        self.max_distance_1d = max_distance_1d
        self.max_distance_scp = max_distance_scp
        self.rel1d = nn.Embedding(num_buckets, num_heads, device=device, dtype=torch.float32)
        self.scp = nn.Embedding(num_buckets, num_heads, device=device, dtype=torch.float32)

    def forward(self, seq_len: int, ocr_coordinates: torch.Tensor, max_ques: int,
                max_ocr: int) -> FusedSalBias:
        """``ocr_coordinates``: (B, L_ocr, 4) floats in [0, 1]."""
        if max_ques + max_ocr > seq_len:
            raise ValueError(f"OCR block [{max_ques}, {max_ques + max_ocr}) past {seq_len}")
        device = self.rel1d.weight.device
        pos = torch.arange(seq_len, device=device)
        buckets_1d = relative_position_bucket(
            pos[None, :] - pos[:, None], True, self.num_buckets, self.max_distance_1d
        )
        bias_1d = self.rel1d(buckets_1d).permute(2, 0, 1).contiguous()  # (H, L, L)

        table = torch.from_numpy(_grid_distance_table()).to(device)
        buckets121 = relative_position_bucket(table, True, self.num_buckets,
                                              self.max_distance_scp)
        cell_bias = self.scp(buckets121).permute(2, 0, 1)  # (H, 121, 121)
        cell_bias = nn.functional.pad(cell_bias, (0, 1, 0, 1))  # zero sentinel row/col

        coords = ocr_coordinates.float()
        cx = (coords[..., 0] + coords[..., 2]) / 2
        cy = (coords[..., 1] + coords[..., 3]) / 2
        ix = torch.floor(cx * GRID).to(torch.int32).clamp(0, GRID - 1)
        iy = torch.floor(cy * GRID).to(torch.int32).clamp(0, GRID - 1)
        cell = torch.full((coords.shape[0], seq_len), SENTINEL, dtype=torch.int32, device=device)
        cell[:, max_ques : max_ques + coords.shape[1]] = ix * GRID + iy
        return FusedSalBias(bias1d=bias_1d, cell_bias=cell_bias.contiguous(), cell=cell)
