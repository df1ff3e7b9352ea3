"""T5 encoder-decoder in PyTorch (counterpart of ``phoneme_vqa_tpu/models/t5.py``).

* RMS layer norm (no mean subtraction, no bias), pre-norm residual blocks
* relative position bias computed once per stack and shared by every layer;
  a model may inject the encoder's instead (SaL's 2D bias, ``position_bias``)
* no attention logit scaling (T5 convention)
* gated-gelu (tanh approximation) or relu feed-forward
* tied or untied lm head (tied heads scale hidden by d_model**-0.5)

Submodules carry the flax scope names (``encoder.block_3.attn.q``), so the
weight bridge (``models/bridge.py``) is a near 1:1 map. Linear weights are
held in the compute dtype: the cast flax makes of its f32 kernels at each
call, made once. In training their f32 masters live in the train state
(``train/state.py``), which refreshes these copies after every step; norms,
embeddings and the relative-bias table are f32 and their own masters.

Dropout (``dropout_rate``) sits where the JAX T5 puts it: on the FFN's inner
activations and on every residual branch of the encoder and decoder
blocks. It draws from the model's :class:`DropoutRNG` in training mode and
is the identity in eval mode and in the decode steps.

Under tensor parallelism (``parallel/tensor_parallel.py``) the attention
and FFN Linears hold this rank's part: heads are read off the local width
(``H / tp``), the relative bias gives this rank's heads, the decode cache
holds them, and the tied head's vocab-parallel logits are gathered (or kept
local for the training loss).

Decoding uses a stacked (L, B, H, T, d) self-attention cache and
cross-attention K/V projected once per sequence in :meth:`T5Decoder.init_cache`:
one token a step (:meth:`T5Decoder.step`), or a window of K tokens at
per-row positions (:meth:`T5Decoder.step_k`, for speculative verification and
the pool decode).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import NEG_INF, dot_product_attention
from ..ops.layout import kernel_operand
from ..ops.rel_bias import relative_position_bucket
from ..parallel.tensor_parallel import copy_to_tp, gather_from_tp, head_slice

Cache = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    num_heads: int = 12
    d_ff: int = 2048
    num_layers: int = 12
    num_decoder_layers: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1  # in training mode only (``Dropout``)
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"  # or "relu"
    tie_word_embeddings: bool = True
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    dtype: torch.dtype = torch.bfloat16
    # REMAT: each encoder and decoder block's activations are recomputed in
    # the backward (``remat_block``), in training with gradients only
    remat: bool = False


def _linear(d_in: int, d_out: int, cfg: T5Config, device) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False, device=device, dtype=cfg.dtype)


class DropoutRNG:
    """The random stream of one model's dropout sites: a ``torch.Generator``
    on the inputs' device, seeded from ``(seed, step)``, or ``(seed, step,
    micro)`` for a microbatch of an accumulated step. The trainer reseeds it
    before every step, as the JAX executor folds the step (and the
    microbatch) into its dropout key (``jax.random.fold_in``); the two
    frameworks draw different bits from the same seed. On a data-parallel
    mesh each data rank draws its own stream (``rank``); the model ranks of
    one data rank draw the same masks, so the activations they hold in
    common stay equal, and an activation split over them takes its slice of
    one full-width mask (:class:`Dropout`'s ``shard``)."""

    def __init__(self, seed: int = 0, step: int = 0):
        self.reseed(seed, step)

    def reseed(self, seed: int, step: int, micro: Optional[int] = None,
               rank: Optional[int] = None) -> None:
        self.seed, self.step, self.micro, self.rank = int(seed), int(step), micro, rank
        self._generator = None

    def generator(self, device: torch.device) -> torch.Generator:
        if self._generator is None or self._generator.device != device:
            entropy = [self.seed, self.step] + ([] if self.micro is None else [int(self.micro)])
            if self.rank is not None:
                entropy += [2**32, int(self.rank)]
            mixed = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
            self._generator = torch.Generator(device=device).manual_seed(int(mixed))
        return self._generator


def remat_block(block: nn.Module, rng: DropoutRNG, *args):
    """``block(*args)`` under ``torch.utils.checkpoint`` (``REMAT``, the JAX
    package's ``nn.remat`` per T5 block): the block's activations are freed
    after the forward and recomputed in the backward. The dropout masks come
    from ``rng``'s generator, which ``checkpoint``'s ``preserve_rng_state``
    does not cover (it restores the default generators only), so the
    generator's state at the block's forward is kept and set again around
    the recompute: the recompute draws the forward's masks."""
    x = args[0]
    if not any(m.rate and m.training for m in block.modules() if isinstance(m, Dropout)):
        return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
    gen = rng.generator(x.device)
    at_forward = gen.get_state()
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:  # the forward: draws advance the stream as usual
            return block(*a)
        after = gen.get_state()
        gen.set_state(at_forward)
        try:
            return block(*a)
        finally:
            gen.set_state(after)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training mode keeps each element with
    probability ``1 - rate`` and scales it by ``1 / (1 - rate)``; the
    identity in eval mode or at rate 0. For an activation whose last
    dimension is split over the model axis, ``shard`` (a
    ``parallel.tensor_parallel.Shard``) names this rank's part: the mask is
    drawn at the full width and sliced, so every rank draws the same amount
    and the masks are those of one process."""

    def __init__(self, rate: float, rng: DropoutRNG):
        super().__init__()
        self.rate = rate
        self.rng = rng

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        gen = self.rng.generator(x.device)
        if shard is None:
            keep = torch.rand(x.shape, generator=gen, device=x.device)
        else:
            full = x.shape[:-1] + (shard.size * dist.get_world_size(shard.group),)
            keep = torch.rand(full, generator=gen, device=x.device).narrow(-1, shard.start,
                                                                          shard.size)
        return torch.where(keep < keep_prob, x / keep_prob, 0.0)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(d, device=device, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return (self.weight * x32).to(self.dtype)


class T5FFN(nn.Module):
    def __init__(self, cfg: T5Config, device=None, rng: Optional[DropoutRNG] = None):
        super().__init__()
        self.drop = Dropout(cfg.dropout_rate, rng or DropoutRNG())
        self.d_ff = cfg.d_ff
        self.gated = cfg.feed_forward_proj == "gated-gelu"
        if self.gated:
            self.wi_0 = _linear(cfg.d_model, cfg.d_ff, cfg, device)
            self.wi_1 = _linear(cfg.d_model, cfg.d_ff, cfg, device)
        else:
            self.wi = _linear(cfg.d_model, cfg.d_ff, cfg, device)
        self.wo = _linear(cfg.d_ff, cfg.d_model, cfg, device)
        self.width_shard = None  # this rank's part of d_ff under TP (``parallelize_``)

    def tp_layout(self):
        """(column-split Linears, row-split Linears, the width that must
        divide ``tp``): ``parallel/mesh.py: tp_plan``."""
        return (("wi_0", "wi_1") if self.gated else ("wi",)), ("wo",), self.d_ff

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            x = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            x = F.relu(self.wi(x))
        return self.wo(self.drop(x, self.width_shard))


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.num_heads, self.d_kv = cfg.num_heads, cfg.d_kv
        inner = cfg.num_heads * cfg.d_kv
        self.q = _linear(cfg.d_model, inner, cfg, device)
        self.k = _linear(cfg.d_model, inner, cfg, device)
        self.v = _linear(cfg.d_model, inner, cfg, device)
        self.o = _linear(inner, cfg.d_model, cfg, device)

    def tp_layout(self):
        return ("q", "k", "v"), ("o",), self.num_heads

    @property
    def local_heads(self) -> int:
        """The heads this rank runs: all, or ``H / tp`` of a split module."""
        return self.q.out_features // self.d_kv

    def _split(self, x: torch.Tensor) -> torch.Tensor:  # (B, L, H*D) -> (B, H, L, D)
        b, l, _ = x.shape
        return x.view(b, l, -1, self.d_kv).transpose(1, 2)

    @staticmethod
    def _merge(x: torch.Tensor) -> torch.Tensor:  # (B, H, L, D) -> (B, L, H*D)
        b, h, l, d = x.shape
        return x.transpose(1, 2).reshape(b, l, h * d)

    def forward(self, x, kv_source=None, key_mask=None, bias=None, causal: bool = False):
        kv_source = x if kv_source is None else kv_source
        q = self._split(self.q(x))
        k = self._split(self.k(kv_source))
        v = self._split(self.v(kv_source))
        out = dot_product_attention(q, k, v, bias=bias, key_mask=key_mask, causal=causal)
        return self.o(self._merge(out))

    # -- incremental decode -------------------------------------------------

    def project_kv(self, x: torch.Tensor):
        """Project K/V once for a full sequence (cross-attention cache)."""
        return self._split(self.k(x)), self._split(self.v(x))

    def step(self, x, cache_k, cache_v, index: int, bias_row=None, key_mask=None):
        """One self-attention decode step over the cache (B, H, T, d).

        The port writes this position's K/V into the cache IN PLACE first and
        then attends over positions <= index: one cache write per layer and
        step. (The JAX package folds the new K/V in analytically and writes
        all layers at once, an XLA measure; the result is the same.)"""
        q = self._split(self.q(x))  # (B, H, 1, d)
        cache_k[:, :, index] = self._split(self.k(x))[:, :, 0]
        cache_v[:, :, index] = self._split(self.v(x))[:, :, 0]
        t = cache_k.shape[2]
        logits = torch.matmul(q.float(), cache_k.float().transpose(-1, -2))  # (B, H, 1, T)
        if bias_row is not None:
            logits = logits + bias_row.float()
        keep = torch.arange(t, device=x.device) <= index
        keep = keep[None, None, None, :]
        if key_mask is not None:
            keep = keep & key_mask.bool()[:, None, None, :]
        logits = logits.masked_fill(~keep, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(cache_v.dtype)
        return self.o(self._merge(torch.matmul(probs, cache_v)))

    def cross_step(self, x, cached_k, cached_v, key_mask=None):
        q = self._split(self.q(x))
        out = dot_product_attention(q, cached_k, cached_v, key_mask=key_mask)
        return self.o(self._merge(out))

    def step_k(self, x, cache_k, cache_v, pos, bias_rows=None):
        """Self-attention over a window of K tokens per row starting at the
        per-row position ``pos`` (B,): each query attends the cache strictly
        before its row's window plus the window's own K/V up to itself, with
        the relative bias gathered per row (``bias_rows`` (B, H, K, T)). The
        cache is not touched here: the caller writes all layers' window K/V
        at once (:func:`scatter_window_kv`). Returns (out (B, K, D), k_new,
        v_new (B, H, K, d))."""
        q = self._split(self.q(x))
        k_new, v_new = self._split(self.k(x)), self._split(self.v(x))
        win_bias = None
        if bias_rows is not None:
            # the bias of the window's own keys: columns pos+m of its rows,
            # clamped at the buffer end (only tails no query accepts reach it)
            t, kk = cache_k.shape[2], x.shape[1]
            cols = (pos[:, None] + torch.arange(kk, device=pos.device)[None, :]).clamp(max=t - 1)
            win_bias = bias_rows.gather(3, cols[:, None, None, :].expand(*bias_rows.shape[:3], kk))
        out = window_attention(q, cache_k, cache_v, k_new, v_new, pos, bias_rows, win_bias)
        return self.o(self._merge(out)), k_new, v_new


def window_attention(q, cache_k, cache_v, k_new, v_new, pos, bias_cache=None, bias_win=None,
                     scale=None):
    """Attention of a K-query window at per-row positions ``pos`` (B,): the
    keys are the cache's positions strictly before the row's window, then
    the window's own keys up to the query (causal), one softmax over both,
    f32 logits. q, k_new, v_new (B, H, K, d); cache (B, H, T, d); biases
    (B, H, K, T) and (B, H, K, K), added after ``scale``."""
    t, kk = cache_k.shape[2], q.shape[2]
    logits_cache = torch.matmul(q.float(), cache_k.float().transpose(-1, -2))  # (B, H, K, T)
    logits_win = torch.matmul(q.float(), k_new.float().transpose(-1, -2))  # (B, H, K, K)
    if scale is not None:
        logits_cache, logits_win = logits_cache * scale, logits_win * scale
    if bias_cache is not None:
        logits_cache = logits_cache + bias_cache.float()
        logits_win = logits_win + bias_win.float()
    before = torch.arange(t, device=q.device)[None, :] < pos[:, None]  # (B, T)
    logits_cache = logits_cache.masked_fill(~before[:, None, None, :], NEG_INF)
    causal = torch.ones(kk, kk, dtype=torch.bool, device=q.device).tril()
    logits_win = logits_win.masked_fill(~causal, NEG_INF)
    probs = torch.softmax(torch.cat([logits_cache, logits_win], dim=-1), dim=-1).to(cache_v.dtype)
    # one product over [cache | window] values: one rounding of the output in
    # the compute dtype, as the one-token step has
    return torch.matmul(probs, torch.cat([cache_v, v_new], dim=2))


def scatter_window_kv(cache: Cache, k_news, v_news, pos) -> Cache:
    """Write the window K/V of every layer, (L, B, H, K, d), into the
    stacked (L, B, H, T, d) cache in place at per-row positions pos..pos+K-1;
    positions at or past T are dropped (a row's window may run past the
    buffer only with tokens no query accepts). The JAX package clamps them
    to T-1 and sums them there, into a slot nothing reads."""
    t, kk = cache["k"].shape[3], k_news.shape[3]
    j = torch.arange(t, device=pos.device)[None, :] - pos[:, None]  # (B, T): window index
    hit = ((j >= 0) & (j < kk))[None, :, None, :, None]
    idx = j.clamp(0, kk - 1)[None, :, None, :, None]
    for name, new in (("k", k_news), ("v", v_news)):
        old = cache[name]
        picked = new.gather(3, idx.expand(*new.shape[:3], t, new.shape[4]))
        old.copy_(torch.where(hit, picked, old))
    return cache


class RelativeBias(nn.Module):
    def __init__(self, cfg: T5Config, bidirectional: bool, device=None):
        super().__init__()
        self.bidirectional = bidirectional
        self.num_buckets = cfg.relative_attention_num_buckets
        self.max_distance = cfg.relative_attention_max_distance
        self.rel_embedding = nn.Embedding(
            cfg.relative_attention_num_buckets, cfg.num_heads, device=device,
            dtype=torch.float32,
        )
        # tensor parallelism: the heads this rank's split attention runs
        self.tp_bias_heads = cfg.num_heads
        self.head_shard = None

    def forward(self, qlen: int, klen: int) -> torch.Tensor:
        """(1, H, qlen, klen) f32 with rows 16 bytes apart (``ops.layout.
        kernel_operand``: the storage pads klen to a multiple of 4), so the
        attention kernels read it in place in every layer of the stack;
        under tensor parallelism this rank's ``H / tp`` heads."""
        device = self.rel_embedding.weight.device
        ctx = torch.arange(qlen, device=device)[:, None]
        mem = torch.arange(klen, device=device)[None, :]
        buckets = relative_position_bucket(
            mem - ctx, self.bidirectional, self.num_buckets, self.max_distance
        )
        bias = head_slice(self.rel_embedding(buckets).permute(2, 0, 1)[None], self.head_shard, 1)
        return kernel_operand(bias)[0]


class T5EncoderBlock(nn.Module):
    def __init__(self, cfg: T5Config, device=None, rng: Optional[DropoutRNG] = None):
        super().__init__()
        rng = rng or DropoutRNG()
        self.ln0 = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, cfg.dtype, device)
        self.attn = T5Attention(cfg, device)
        self.ln1 = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, cfg.dtype, device)
        self.ffn = T5FFN(cfg, device, rng)
        self.drop = Dropout(cfg.dropout_rate, rng)

    def forward(self, x, key_mask, bias):
        x = x + self.drop(self.attn(self.ln0(x), key_mask=key_mask, bias=bias))
        return x + self.drop(self.ffn(self.ln1(x)))


def _add_blocks(module: nn.Module, make, n: int):
    for i in range(n):
        module.add_module(f"block_{i}", make())
    return [getattr(module, f"block_{i}") for i in range(n)]


class T5Encoder(nn.Module):
    """``rel_bias=False`` builds an encoder without its own relative-bias
    table, for a model that always injects ``position_bias`` (SaL): flax
    never creates the table of a submodule that is never called, so such a
    model's parameter set has none."""

    def __init__(self, cfg: T5Config, device=None, rel_bias: bool = True,
                 rng: Optional[DropoutRNG] = None):
        super().__init__()
        self.cfg = cfg
        self.rng = rng = rng or DropoutRNG()
        self.rel_bias = RelativeBias(cfg, bidirectional=True, device=device) if rel_bias else None
        self.blocks = _add_blocks(self, lambda: T5EncoderBlock(cfg, device, rng), cfg.num_layers)
        self.final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, cfg.dtype, device)

    def forward(self, inputs_embeds, attention_mask=None, position_bias=None):
        """``position_bias`` (a (B|1, H, L, L) tensor or a ``FusedSalBias``),
        when given, replaces the encoder's own relative bias."""
        l = inputs_embeds.shape[1]
        if position_bias is not None:
            bias = position_bias
        elif self.rel_bias is not None:
            bias = self.rel_bias(l, l)
        else:
            raise ValueError("T5Encoder built without rel_bias needs a position_bias")
        key_mask = None if attention_mask is None else attention_mask.bool()
        x = inputs_embeds.to(self.cfg.dtype)
        remat = self.cfg.remat and self.training and torch.is_grad_enabled()
        for block in self.blocks:
            x = remat_block(block, self.rng, x, key_mask, bias) if remat else block(x, key_mask, bias)
        return self.final_ln(x)


class T5DecoderBlock(nn.Module):
    def __init__(self, cfg: T5Config, device=None, rng: Optional[DropoutRNG] = None):
        super().__init__()
        rng = rng or DropoutRNG()
        self.ln0 = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, cfg.dtype, device)
        self.self_attn = T5Attention(cfg, device)
        self.ln1 = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, cfg.dtype, device)
        self.cross_attn = T5Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, cfg.dtype, device)
        self.ffn = T5FFN(cfg, device, rng)
        self.drop = Dropout(cfg.dropout_rate, rng)

    def forward(self, x, enc_out, enc_mask, self_mask, bias):
        drop = self.drop
        x = x + drop(self.self_attn(self.ln0(x), key_mask=self_mask, bias=bias, causal=True))
        x = x + drop(self.cross_attn(self.ln1(x), kv_source=enc_out, key_mask=enc_mask))
        return x + drop(self.ffn(self.ln2(x)))

    def step(self, x, cache_k, cache_v, cross_k, cross_v, index, bias_row, enc_mask):
        x = x + self.self_attn.step(self.ln0(x), cache_k, cache_v, index, bias_row)
        x = x + self.cross_attn.cross_step(self.ln1(x), cross_k, cross_v, enc_mask)
        return x + self.ffn(self.ln2(x))

    def step_k(self, x, cache_k, cache_v, cross_k, cross_v, pos, bias_rows, enc_mask):
        """A K-token window at per-row positions; the cross-attention is
        position-free and serves the K queries as they are. Returns (x,
        k_new, v_new)."""
        h, k_new, v_new = self.self_attn.step_k(self.ln0(x), cache_k, cache_v, pos, bias_rows)
        x = x + h
        x = x + self.cross_attn.cross_step(self.ln1(x), cross_k, cross_v, enc_mask)
        return x + self.ffn(self.ln2(x)), k_new, v_new


class T5Decoder(nn.Module):
    def __init__(self, cfg: T5Config, device=None, rng: Optional[DropoutRNG] = None):
        super().__init__()
        self.cfg = cfg
        self.rng = rng = rng or DropoutRNG()
        self.rel_bias = RelativeBias(cfg, bidirectional=False, device=device)
        self.blocks = _add_blocks(
            self, lambda: T5DecoderBlock(cfg, device, rng), cfg.num_decoder_layers
        )
        self.final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, cfg.dtype, device)

    def forward(self, dec_embeds, enc_out, enc_mask=None, dec_mask=None):
        t = dec_embeds.shape[1]
        bias = self.rel_bias(t, t)
        enc_mask = None if enc_mask is None else enc_mask.bool()
        dec_mask = None if dec_mask is None else dec_mask.bool()
        x = dec_embeds.to(self.cfg.dtype)
        remat = self.cfg.remat and self.training and torch.is_grad_enabled()
        for block in self.blocks:
            args = (x, enc_out, enc_mask, dec_mask, bias)
            x = remat_block(block, self.rng, *args) if remat else block(*args)
        return self.final_ln(x)

    # -- incremental decode --------------------------------------------------

    def init_cache(self, enc_out: torch.Tensor, max_len: int):
        """The stacked self-attention cache (L, B, H, T, d), the stacked
        cross-attention K/V and the full decoder relative bias (1, H, T, T)."""
        cfg = self.cfg
        b = enc_out.shape[0]
        heads = self.blocks[0].self_attn.local_heads
        shape = (cfg.num_decoder_layers, b, heads, max_len, cfg.d_kv)
        kv = [block.cross_attn.project_kv(enc_out) for block in self.blocks]
        cache = {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=enc_out.device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=enc_out.device),
            "ck": torch.stack([k for k, _ in kv]),
            "cv": torch.stack([v for _, v in kv]),
        }
        return cache, self.rel_bias(max_len, max_len)

    def step(self, tok_embed, cache: Cache, index: int, full_bias, enc_mask=None):
        """One decode step at position ``index``; writes the cache in place."""
        bias_row = full_bias[:, :, index : index + 1, :]
        enc_mask = None if enc_mask is None else enc_mask.bool()
        x = tok_embed.to(self.cfg.dtype)
        for l, block in enumerate(self.blocks):
            x = block.step(
                x, cache["k"][l], cache["v"][l], cache["ck"][l], cache["cv"][l],
                index, bias_row, enc_mask,
            )
        return self.final_ln(x), cache

    def step_k(self, tok_embeds, cache: Cache, pos, full_bias, enc_mask=None):
        """A decode step over a window of K tokens per row at the per-row
        positions ``pos`` (B,) (speculative verification, the pool decode):
        the relative-bias rows are gathered per row, clamped at T-1, and the
        window K/V written in place (:func:`scatter_window_kv`). Reads no
        device value back to the host."""
        t, kk = full_bias.shape[-1], tok_embeds.shape[1]
        qpos = (pos[:, None] + torch.arange(kk, device=pos.device)[None, :]).clamp(max=t - 1)
        bias_rows = full_bias[0][:, qpos].permute(1, 0, 2, 3)  # (B, H, K, T)
        enc_mask = None if enc_mask is None else enc_mask.bool()
        x = tok_embeds.to(self.cfg.dtype)
        k_news, v_news = [], []
        for l, block in enumerate(self.blocks):
            x, k_new, v_new = block.step_k(
                x, cache["k"][l], cache["v"][l], cache["ck"][l], cache["cv"][l],
                pos, bias_rows, enc_mask,
            )
            k_news.append(k_new)
            v_news.append(v_new)
        scatter_window_kv(cache, torch.stack(k_news), torch.stack(v_news), pos)
        return self.final_ln(x), cache


class T5(nn.Module):
    """Full encoder-decoder with shared token embedding and LM head. Every
    dropout site draws from ``dropout_rng``.

    ``decoder=False`` builds the encoder and the shared embedding only, for
    a model with its own answer decoder (``models/customized.py``): flax
    never creates the parameters of a submodule that is never called, so
    such a model's ``t5`` tree holds ``encoder`` and ``shared`` alone.

    Under tensor parallelism ``shared`` may be split over its vocabulary
    (``tp_vocab_embeddings``); the tied head then computes this rank's
    vocabulary slice of the logits and gathers them, or, inside
    ``parallel.tensor_parallel.local_logits`` (the training loss), returns
    the slice."""

    tp_vocab_embeddings = ("shared",)
    local_logits = False

    def __init__(self, cfg: T5Config, device=None, encoder_rel_bias: bool = True,
                 decoder: bool = True):
        super().__init__()
        self.cfg = cfg
        self.dropout_rng = DropoutRNG()
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device, dtype=torch.float32)
        self.encoder = T5Encoder(cfg, device, rel_bias=encoder_rel_bias, rng=self.dropout_rng)
        if decoder:
            self.decoder = T5Decoder(cfg, device, rng=self.dropout_rng)
            if not cfg.tie_word_embeddings:
                self.lm_head = _linear(cfg.d_model, cfg.vocab_size, cfg, device)

    @property
    def tied_head(self) -> bool:
        return hasattr(self, "decoder") and self.cfg.tie_word_embeddings

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.shared(ids).to(self.cfg.dtype)

    def encode(self, inputs_embeds, attention_mask=None, position_bias=None):
        return self.encoder(inputs_embeds, attention_mask, position_bias)

    def lm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.tie_word_embeddings:
            # products of compute-dtype values, summed and returned in f32
            hidden = hidden * (cfg.d_model**-0.5)
            table = self.shared.weight.to(cfg.dtype).float()
            shard = getattr(self.shared, "vocab_shard", None)
            if shard is None:
                return torch.matmul(hidden.float(), table.t())
            logits = torch.matmul(copy_to_tp(hidden, shard.group).float(), table.t())
            return logits if self.local_logits else gather_from_tp(logits, -1, shard.group)
        return self.lm_head(hidden).float()

    def decode(self, dec_ids, enc_out, enc_mask=None, dec_mask=None):
        """Teacher-forced decode: (B, T, V) f32 logits."""
        return self.lm_logits(self.decoder(self.embed(dec_ids), enc_out, enc_mask, dec_mask))

    def init_cache(self, enc_out, max_len: int):
        return self.decoder.init_cache(enc_out, max_len)

    def decode_step(self, token_ids, cache, index: int, full_bias, enc_mask=None):
        """One decode step: token_ids (B,) -> ((B, V) f32 logits, cache)."""
        hidden, cache = self.decoder.step(
            self.embed(token_ids[:, None]), cache, index, full_bias, enc_mask
        )
        return self.lm_logits(hidden)[:, 0], cache

    def decode_step_k(self, token_ids, cache, pos, full_bias, enc_mask=None):
        """A K-token decode step at per-row positions: token_ids (B, K), pos
        (B,) -> ((B, K, V) f32 logits, cache)."""
        hidden, cache = self.decoder.step_k(self.embed(token_ids), cache, pos, full_bias,
                                            enc_mask)
        return self.lm_logits(hidden), cache
