"""Attention core: the plain PyTorch version and the kernel dispatch.

One attention serves every model (T5 encoder/decoder, ViT): batched
multi-head dot-product attention over (B, H, L, D) with an optional additive
bias (B|1, H, Lq, Lk), a boolean key mask and causal masking, f32 logits and
softmax. Counterpart of ``phoneme_vqa_tpu/ops/attention.py``.

On the card a call that needs gradients goes through
:class:`FusedAttentionFn` (the counterpart of the JAX package's ``_flash``
``custom_vjp``): the kernel computes the forward, and for bf16 tensors the
backward kernels (``csrc/attention_bwd.cuh``, written for the port: the JAX
package recomputes the plain version under autodiff) compute dq, dk, dv and
the logits' gradient that the bias's sums; CPU and f32 calls recompute
:func:`reference_attention` under autograd instead
(:func:`reference_attention_backward`).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9

# Below this query length (the decoder's one-token steps) attention stays
# plain PyTorch, as in the JAX package: the kernel tiles 64 query rows.
_FLASH_MIN_QLEN = 16

# SAL_FUSED: a FusedSalBias on the card goes to the SaL kernel, which
# rebuilds the 2D bias in its tiles; off, it is materialized as a (B, H, L,
# L) f32 tensor and read by the attention kernel (and the SaL models
# materialize it once per forward, ``models.sal.encoder_bias``). On by
# default: on an H100 the 12 SaL-kernel launches of a SaL-base batch take
# less time than one materialization plus 12 attention-kernel launches on
# the bias (PERF.md, ``chip_smoke.py`` phase 6b). The JAX package's default
# (off) was set by TPU v5e times.
SAL_FUSED_ENABLED = True


def enable_sal_fused(enabled: bool = True) -> None:
    """The ``SAL_FUSED`` knob (the executor sets it from the config)."""
    global SAL_FUSED_ENABLED
    SAL_FUSED_ENABLED = bool(enabled)


def sal_fused_enabled() -> bool:
    return SAL_FUSED_ENABLED


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


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def backward_kernel_takes(q: torch.Tensor) -> bool:
    """Whether the backward kernels take a kernel call's tensors: bf16 on the
    card (the forward's contract already holds the head dim to a multiple of
    8, at most 128). Else the backward wrappers recompute the plain version
    (:func:`reference_attention_backward`)."""
    return q.is_cuda and q.dtype == torch.bfloat16


def reference_attention_backward(q, k, v, g, bias=None, key_mask=None, causal=False, scale=None,
                                 want_ds=False):
    """The backward kernels' plain version: (dq, dk, dv, dS) of
    :func:`reference_attention` for the upstream gradient ``g``, recomputed
    under autograd on detached copies, dS the gradient of the logits (B, H,
    Lq, Lk) f32 when ``want_ds`` (else None): what a bias of batch B
    receives, zero where a key is masked or causal."""
    b, h, lq, _ = q.shape
    # the bias at batch B (zeros without one: x + 0 == x), whose gradient is dS
    full_bias = torch.zeros(b, h, lq, k.shape[2], dtype=torch.float32, device=q.device)
    if bias is not None:
        full_bias = full_bias + bias.detach().float()
    leaves = [t.detach().requires_grad_() for t in (q, k, v)] + [full_bias.requires_grad_(want_ds)]
    with torch.enable_grad():
        out = reference_attention(*leaves, key_mask, causal, scale)
        grads = torch.autograd.grad(out, leaves[:3 + want_ds], g)
    return (*grads[:3], grads[3] if want_ds else None)


class FusedAttentionFn(torch.autograd.Function):
    """The attention kernel under autograd.

    ``forward`` launches ``flash_attention.fused_attention`` and saves q, k,
    v, the bias, the mask and the output; ``backward`` calls
    ``flash_attention.attention_backward`` (the backward kernels for bf16 on
    the card, else the plain recompute) and returns dq, dk, dv and dbias
    (the logits' gradient, summed over the batch when the bias has batch 1),
    only for the inputs that need them, and None for the mask, the causal
    flag and the scale. Counterpart of
    ``phoneme_vqa_tpu/ops/attention.py: _flash`` / ``_flash_fwd`` /
    ``_flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, bias, key_mask, causal, scale):
        from .flash_attention import fused_attention

        out = fused_attention(q, k, v, bias, key_mask, causal, scale, any_layout=True)
        ctx.save_for_backward(q, k, v, bias, key_mask, out)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        from .flash_attention import attention_backward

        q, k, v, bias, key_mask, out = ctx.saved_tensors
        needs = ctx.needs_input_grad[:4]
        dq, dk, dv, ds = attention_backward(q, k, v, out, g, bias, key_mask, ctx.causal,
                                            ctx.scale, want_ds=needs[3])
        dbias = None
        if needs[3]:
            dbias = ds.sum(0, keepdim=True) if bias.shape[0] == 1 else ds
        return (*(x if n else None for x, n in zip((dq, dk, dv), needs)), dbias,
                None, None, None)


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
    Lq == Lk launches the SaL kernel while ``SAL_FUSED`` is on; any other
    ``FusedSalBias`` is materialized first. Then a CUDA call with Lq >= 16 and a 2-D key mask (or
    none) launches the fused kernel; every other call (CPU tensors, one-token
    decode steps) takes the plain version. A kernel call that needs
    gradients (grad mode on and an input that requires grad) goes through
    the kernel's ``autograd.Function`` (:class:`FusedAttentionFn`,
    ``sal_fused_attention.SalAttentionFn``), whose backward launches the
    backward kernels (bf16) or recomputes the plain version (f32); any
    other calls the kernel's wrapper directly. The
    kernels read q, k and v in place (the models' transposed views
    included); only a tensor whose layout they do not take is copied
    (``any_layout``, ``ops.layout.kernel_operand``)."""
    from .sal_fused_attention import FusedSalBias

    if isinstance(bias, FusedSalBias):
        if (SAL_FUSED_ENABLED and q.is_cuda and not causal and scale is None
                and q.shape[-2] == k.shape[-2]):
            from .sal_fused_attention import SalAttentionFn, sal_fused_attention

            mask = (
                torch.ones(k.shape[0], k.shape[2], dtype=torch.int32, device=k.device)
                if key_mask is None
                else key_mask.to(torch.int32).contiguous()
            )
            args = (q, k, v, bias.bias1d, bias.cell_bias.contiguous(),
                    bias.cell.to(torch.int32).contiguous(), mask)
            if _needs_grad(q, k, v, bias.bias1d, bias.cell_bias):
                return SalAttentionFn.apply(*args)
            return sal_fused_attention(*args, any_layout=True)
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
        if _needs_grad(q, k, v, b):
            return FusedAttentionFn.apply(q, k, v, b, mask, causal, scale)
        return fused_attention(q, k, v, b, mask, causal, scale, any_layout=True)
    return reference_attention(q, k, v, bias, key_mask, causal, scale)
