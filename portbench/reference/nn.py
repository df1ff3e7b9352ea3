"""Plain float32 building blocks of the reference models, written on a dict
of named parameters.

Every matrix product takes an optional ``quant`` (a function applied to
both operands first): None is the float32 reference; :func:`fp8` is the
control, the same mathematics with the operands of every product rounded
to float8 e4m3 (the nearest precision below the bfloat16 the
configurations state)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e9
FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale, in float32;
    the gradient passes the rounding unchanged (straight through)."""
    scale = x.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
    rounded = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (rounded - x.detach())


def plain_precision() -> None:
    """float32 products stay float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mm(x, w, quant=None):
    """x @ w.T"""
    if quant is not None:
        x, w = quant(x), quant(w)
    return torch.matmul(x, w.t())


def linear(p, name, x, quant=None, bias=True):
    y = mm(x, p[f"{name}.weight"], quant)
    return y + p[f"{name}.bias"] if bias else y


def rms_norm(p, name, x, eps=1e-6):
    return p[f"{name}.weight"] * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def layer_norm(p, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def attention(q, k, v, bias=None, key_mask=None, causal=False, scale=None, quant=None):
    """Softmax attention over (B, H, L, D), float32 logits; a masked key's
    logit is -1e9."""
    if quant is not None:
        q, k, v = quant(q), quant(k), quant(v)
    logits = torch.matmul(q, k.transpose(-1, -2))
    if scale is not None:
        logits = logits * scale
    if bias is not None:
        logits = logits + bias
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask.bool()[:, None, None, :], NEG_INF)
    if causal:
        lq, lk = logits.shape[-2:]
        logits = logits.masked_fill(torch.ones(lq, lk, dtype=torch.bool, device=q.device)
                                    .triu(1), NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if quant is not None:
        probs = quant(probs)
    return torch.matmul(probs, v)


def split_heads(x, d):
    b, l, _ = x.shape
    return x.view(b, l, -1, d).transpose(1, 2)


def merge_heads(x):
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def relative_bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int = 32,
                    max_distance: int = 128) -> torch.Tensor:
    """T5's relative position buckets: half exact small offsets, half
    log-spaced up to ``max_distance``; bidirectional splits them by sign."""
    ret = torch.zeros_like(rel)
    n = -rel
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(rel.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    exact = num_buckets // 2
    large = exact + (torch.log(n.float() / exact + 1e-20) / math.log(max_distance / exact)
                     * (num_buckets - exact)).to(rel.dtype)
    return ret + torch.where(n < exact, n, large.clamp(max=num_buckets - 1))


def t5_bias(p, name, lq, lk, bidirectional, device):
    """(1, H, lq, lk) relative-position bias from the table ``name``."""
    rel = torch.arange(lk, device=device)[None, :] - torch.arange(lq, device=device)[:, None]
    return p[f"{name}.weight"][relative_bucket(rel, bidirectional)].permute(2, 0, 1)[None]


def t5_attention(p, name, x, kv, d_kv, quant, **kw):
    q = split_heads(mm(x, p[f"{name}.q.weight"], quant), d_kv)
    k = split_heads(mm(kv, p[f"{name}.k.weight"], quant), d_kv)
    v = split_heads(mm(kv, p[f"{name}.v.weight"], quant), d_kv)
    return mm(merge_heads(attention(q, k, v, quant=quant, **kw)), p[f"{name}.o.weight"], quant)


def t5_ffn(p, name, x, quant):
    h = F.gelu(mm(x, p[f"{name}.wi_0.weight"], quant), approximate="tanh") \
        * mm(x, p[f"{name}.wi_1.weight"], quant)
    return mm(h, p[f"{name}.wo.weight"], quant)


def t5_encoder(p, x, mask, bias, c, quant=None, prefix="t5.encoder"):
    """Pre-norm T5 encoder blocks over ``x`` with the (B|1, H, L, L) bias."""
    for i in range(c["num_encoder_layers"]):
        b = f"{prefix}.block_{i}"
        x = x + t5_attention(p, f"{b}.attn", rms_norm(p, f"{b}.ln0", x),
                             rms_norm(p, f"{b}.ln0", x), c["d_kv"], quant, bias=bias,
                             key_mask=mask)
        x = x + t5_ffn(p, f"{b}.ffn", rms_norm(p, f"{b}.ln1", x), quant)
    return rms_norm(p, f"{prefix}.final_ln", x)


def t5_decoder_logits(p, labels, label_mask, enc, enc_mask, c, quant=None):
    """Teacher-forced T5 decoder over ``labels`` (B, T) and the tied head:
    (B, T, V) logits."""
    t = labels.shape[1]
    x = p["t5.shared.weight"][labels]
    bias = t5_bias(p, "t5.decoder.rel_bias.rel_embedding", t, t, False, labels.device)
    for i in range(c["num_t5_decoder_layers"]):
        b = f"t5.decoder.block_{i}"
        h = rms_norm(p, f"{b}.ln0", x)
        x = x + t5_attention(p, f"{b}.self_attn", h, h, c["d_kv"], quant, bias=bias,
                             key_mask=label_mask, causal=True)
        x = x + t5_attention(p, f"{b}.cross_attn", rms_norm(p, f"{b}.ln1", x), enc,
                             c["d_kv"], quant, key_mask=enc_mask)
        x = x + t5_ffn(p, f"{b}.ffn", rms_norm(p, f"{b}.ln2", x), quant)
    x = rms_norm(p, "t5.decoder.final_ln", x) * c["d_model"] ** -0.5
    return mm(x, p["t5.shared.weight"], quant)


def cross_entropy(logits, targets, pad_id):
    """Token mean of the negative log-likelihood over non-pad targets."""
    mask = (targets != pad_id).float()
    ll = torch.log_softmax(logits, -1).gather(-1, targets[..., None])[..., 0]
    return -(ll * mask).sum() / mask.sum().clamp(min=1.0)


class Adam:
    """Adam with bias correction (the update ``mu_hat / (sqrt(nu_hat) +
    eps)``) over a dict of float32 parameters, the learning rate read from
    ``lr(step)`` before the step."""

    def __init__(self, names, lr, betas, eps):
        self.names, self.lr, (self.b1, self.b2), self.eps = list(names), lr, betas, eps
        self.count, self.mu, self.nu = 0, {}, {}

    @torch.no_grad()
    def step(self, params, grads):
        lr = self.lr(self.count)
        self.count += 1
        for n in self.names:
            g = grads[n]
            m = self.mu[n] = self.mu.get(n, torch.zeros_like(g)) * self.b1 + (1 - self.b1) * g
            v = self.nu[n] = self.nu.get(n, torch.zeros_like(g)) * self.b2 + (1 - self.b2) * g * g
            update = (m / (1 - self.b1 ** self.count)) / (
                torch.sqrt(v / (1 - self.b2 ** self.count)) + self.eps)
            params[n].sub_(lr * update)
