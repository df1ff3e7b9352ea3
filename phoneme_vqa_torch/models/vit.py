"""ViT image encoder in PyTorch (counterpart of ``phoneme_vqa_tpu/models/vit.py``).

Pre-LN ViT: conv patch embedding, CLS token, learned position embeddings,
scaled dot-product attention with biases, exact-GELU MLP, final LayerNorm
(eps 1e-12). Pixel values arrive (B, C, H, W); patches are numbered row by
row, as the JAX package's NHWC conv + reshape numbers them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS


class LayerNorm(nn.Module):
    """LayerNorm with f32 parameters and statistics, output in ``dtype``."""

    def __init__(self, d: int, eps: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(d, device=device, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(d, device=device, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias, self.eps)
        return y.to(self.dtype)


class ViTSelfAttention(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        dense = lambda: nn.Linear(cfg.hidden_size, cfg.hidden_size, device=device, dtype=cfg.dtype)
        self.query, self.key, self.value, self.out = dense(), dense(), dense(), dense()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        split = lambda t: t.view(b, l, self.num_heads, self.head_dim).transpose(1, 2)
        out = dot_product_attention(
            split(self.query(x)), split(self.key(x)), split(self.value(x)),
            scale=self.head_dim**-0.5,
        )
        return self.out(out.transpose(1, 2).reshape(b, l, -1))


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.ln_before = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, device)
        self.attention = ViTSelfAttention(cfg, device)
        self.ln_after = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, device)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.mlp_dim, device=device, dtype=cfg.dtype)
        self.fc2 = nn.Linear(cfg.mlp_dim, cfg.hidden_size, device=device, dtype=cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.ln_before(x))
        return x + self.fc2(F.gelu(self.fc1(self.ln_after(x)), approximate="none"))


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = nn.Conv2d(
            cfg.num_channels, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size,
            device=device, dtype=cfg.dtype,
        )
        self.cls_token = nn.Parameter(
            torch.zeros(1, 1, cfg.hidden_size, device=device, dtype=torch.float32)
        )
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, cfg.seq_len, cfg.hidden_size, device=device, dtype=torch.float32)
        )
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", ViTBlock(cfg, device))
        self.blocks = [getattr(self, f"block_{i}") for i in range(cfg.num_layers)]
        self.final_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, device)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values (B, C, H, W) -> (B, 1 + patches, hidden)."""
        dtype = self.cfg.dtype
        x = self.patch_embed(pixel_values.to(dtype))  # (B, D, h, w)
        x = x.flatten(2).transpose(1, 2)  # (B, P, D), patches row by row
        cls = self.cls_token.to(dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embeddings.to(dtype)
        for block in self.blocks:
            x = block(x)
        return self.final_ln(x)
