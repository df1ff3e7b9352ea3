"""Attention core: the plain PyTorch version and the kernel dispatch.

One attention serves every model (T5 encoder/decoder, ViT): batched
multi-head dot-product attention over (B, H, L, D) with an optional additive
bias (B|1, H, Lq, Lk), a boolean key mask and causal masking, f32 logits and
softmax. Counterpart of ``phoneme_vqa_tpu/ops/attention.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9

# Below this query length (the decoder's one-token steps) attention stays
# plain PyTorch, as in the JAX package: the kernel tiles 64 query rows.
_FLASH_MIN_QLEN = 16


def reference_attention(
    q: torch.Tensor,  # (B, H, Lq, D)
    k: torch.Tensor,  # (B, H, Lk, D)
    v: torch.Tensor,  # (B, H, Lk, D)
    bias: Optional[torch.Tensor] = None,  # (B or 1, H, Lq, Lk) additive
    key_mask: Optional[torch.Tensor] = None,  # (B, Lk) True/1 = attend
    causal: bool = False,
    scale: Optional[float] = None,  # None = no scaling (T5 convention)
) -> torch.Tensor:
    """The plain version of the fused kernel, and its parity oracle.

    Logits in f32; a masked or causal key's logit is replaced by -1e9; the
    exp tensor is cast to v's dtype for P·V and the softmax divide lands
    after it, in v's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if scale is not None:
        logits = logits * scale
    if bias is not None:
        logits = logits + bias.float()
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask.bool()[:, None, None, :], NEG_INF)
    if causal:
        lq, lk = logits.shape[-2], logits.shape[-1]
        rows = torch.arange(lq, device=logits.device)[:, None]
        cols = torch.arange(lk, device=logits.device)[None, :]
        logits = logits.masked_fill(cols > rows, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    unnorm = torch.exp(logits - m)
    denom = unnorm.sum(dim=-1, keepdim=True)
    out = torch.matmul(unnorm.to(v.dtype), v)
    return out * (1.0 / denom).to(v.dtype)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias=None,  # tensor (B|1, H, Lq, Lk) or FusedSalBias
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """A CUDA call with a ``FusedSalBias``, no causal mask, no scale and
    Lq == Lk launches the SaL kernel; any other ``FusedSalBias`` is
    materialized first. Then a CUDA call with Lq >= 16 and a 2-D key mask (or
    none) launches the fused kernel; every other call (CPU tensors, one-token
    decode steps) takes the plain version. The kernels read q, k and v in
    place (the models' transposed views included); only a tensor whose layout
    they do not take is copied (``any_layout``, ``ops.layout.kernel_operand``)."""
    from .sal_fused_attention import FusedSalBias

    if isinstance(bias, FusedSalBias):
        if q.is_cuda and not causal and scale is None and q.shape[-2] == k.shape[-2]:
            from .sal_fused_attention import sal_fused_attention

            mask = (
                torch.ones(k.shape[0], k.shape[2], dtype=torch.int32, device=k.device)
                if key_mask is None
                else key_mask.to(torch.int32).contiguous()
            )
            return sal_fused_attention(
                q, k, v, bias.bias1d, bias.cell_bias.contiguous(),
                bias.cell.to(torch.int32).contiguous(), mask, any_layout=True,
            )
        bias = bias.materialize()
    use_kernel = (
        q.is_cuda
        and q.shape[-2] >= _FLASH_MIN_QLEN
        and (key_mask is None or key_mask.dim() == 2)
    )
    if use_kernel:
        from .flash_attention import fused_attention

        mask = None if key_mask is None else key_mask.to(torch.int32).contiguous()
        b = None if bias is None else bias.float()
        return fused_attention(q, k, v, b, mask, causal, scale, any_layout=True)
    return reference_attention(q, k, v, bias, key_mask, causal, scale)
