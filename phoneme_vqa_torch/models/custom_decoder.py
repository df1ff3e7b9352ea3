"""Customized answer decoder: a post-LN transformer decoder over a T5
encoder (counterpart of ``phoneme_vqa_tpu/models/custom_decoder.py``).

Token embedding scaled by sqrt(d_model), sinusoidal positional encoding,
then a stack of post-LayerNorm blocks (``nn.TransformerDecoderLayer``'s
default layout: scaled dot-product self- and cross-attention with biased
projections, a ReLU FFN of width 2048, LayerNorm eps 1e-5 with a bias), and
a Linear LM head onto the answer tokenizer's vocabulary.

Submodules carry the flax scope names (``decoder.layer_0.self_attn.q``,
``ln1``, ``fc1``, ``embed``, ``lm_head``), so ``models/bridge.py`` maps a
flax tree 1:1. The positional table is a non-persistent buffer: it is a
function of the shape, not a parameter.

Every attention with a query length of 16 or more (the teacher-forced
self-attention, causal with a key mask, and the cross-attention, both
scaled by (d_model / heads)^-0.5) goes through ``dot_product_attention``,
so on the card it is the attention kernel. Dropout (after the PE, on every
residual branch, inside the FFN) draws from the T5 backbone's
:class:`~phoneme_vqa_torch.models.t5.DropoutRNG`, which the trainer
reseeds every step. Decoding uses a stacked (L, B, H, T, d) cache written in
place, one position per layer and step, as ``T5Decoder.step`` does, or a
K-token window at per-row positions (``step_k``, the pool decode).
:class:`DecoderStack` holds what the phoneme triple decoder
(``models/phoneme.py``) shares with this one.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import NEG_INF, dot_product_attention
from .t5 import Dropout, DropoutRNG, scatter_window_kv, window_attention
from .vit import LayerNorm

Cache = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CustomDecoderConfig:
    vocab_size: int = 1000
    d_model: int = 768
    num_heads: int = 12
    num_layers: int = 4
    d_ff: int = 2048  # torch TransformerDecoderLayer default
    dropout_rate: float = 0.1
    max_len: int = 5000
    pad_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    dtype: torch.dtype = torch.bfloat16


@functools.lru_cache(maxsize=4)
def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """Classic sin/cos PE, computed in f64 and stored f32 (the JAX
    package's ``sinusoidal_table``). Cached: callers must not write to it."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    div = np.exp(-np.arange(0, d_model, 2) * (np.log(10000.0) / d_model))
    table = np.zeros((max_len, d_model), np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return table


def _dense(d_in: int, d_out: int, cfg: CustomDecoderConfig, device) -> nn.Linear:
    return nn.Linear(d_in, d_out, device=device, dtype=cfg.dtype)


class MHA(nn.Module):
    """``nn.MultiheadAttention`` equivalent: biased q/k/v/out projections,
    logits scaled by (d_model / heads)^-0.5."""

    def __init__(self, cfg: CustomDecoderConfig, device=None):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.scale = (cfg.d_model // cfg.num_heads) ** -0.5
        self.q, self.k, self.v, self.out = (_dense(cfg.d_model, cfg.d_model, cfg, device)
                                            for _ in range(4))

    def _split(self, x: torch.Tensor) -> torch.Tensor:  # (B, L, H*D) -> (B, H, L, D)
        b, l, _ = x.shape
        return x.view(b, l, self.num_heads, -1).transpose(1, 2)

    @staticmethod
    def _merge(x: torch.Tensor) -> torch.Tensor:  # (B, H, L, D) -> (B, L, H*D)
        b, h, l, d = x.shape
        return x.transpose(1, 2).reshape(b, l, h * d)

    def forward(self, x, kv=None, key_mask=None, causal: bool = False):
        kv = x if kv is None else kv
        out = dot_product_attention(self._split(self.q(x)), self._split(self.k(kv)),
                                    self._split(self.v(kv)), key_mask=key_mask, causal=causal,
                                    scale=self.scale)
        return self.out(self._merge(out))

    def project_kv(self, x: torch.Tensor):
        return self._split(self.k(x)), self._split(self.v(x))

    def step(self, x, cache_k, cache_v, index: int):
        """One self-attention decode step over the cache (B, H, T, d): this
        position's K/V are written in place, then positions <= index are
        attended (the JAX package folds them in analytically; the result is
        the same)."""
        q = self._split(self.q(x))  # (B, H, 1, d)
        cache_k[:, :, index] = self._split(self.k(x))[:, :, 0]
        cache_v[:, :, index] = self._split(self.v(x))[:, :, 0]
        logits = torch.matmul(q.float(), cache_k.float().transpose(-1, -2)) * self.scale
        keep = torch.arange(cache_k.shape[2], device=x.device) <= index
        logits = logits.masked_fill(~keep, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(cache_v.dtype)
        return self.out(self._merge(torch.matmul(probs, cache_v)))

    def cross_step(self, x, cached_k, cached_v, key_mask=None):
        out = dot_product_attention(self._split(self.q(x)), cached_k, cached_v,
                                    key_mask=key_mask, scale=self.scale)
        return self.out(self._merge(out))

    def step_k(self, x, cache_k, cache_v, pos):
        """Self-attention over a K-token window at the per-row positions
        ``pos`` (B,), as ``T5Attention.step_k`` without a relative bias; the
        cache is not touched here. Returns (out (B, K, D), k_new, v_new)."""
        k_new, v_new = self._split(self.k(x)), self._split(self.v(x))
        out = window_attention(self._split(self.q(x)), cache_k, cache_v, k_new, v_new, pos,
                               scale=self.scale)
        return self.out(self._merge(out)), k_new, v_new


class DecoderLayer(nn.Module):
    """Post-LN: x = LN(x + sublayer(x))."""

    def __init__(self, cfg: CustomDecoderConfig, device=None,
                 rng: Optional[DropoutRNG] = None):
        super().__init__()
        self.self_attn = MHA(cfg, device)
        self.cross_attn = MHA(cfg, device)
        self.ln1, self.ln2, self.ln3 = (LayerNorm(cfg.d_model, 1e-5, cfg.dtype, device)
                                        for _ in range(3))
        self.fc1 = _dense(cfg.d_model, cfg.d_ff, cfg, device)
        self.fc2 = _dense(cfg.d_ff, cfg.d_model, cfg, device)
        self.drop = Dropout(cfg.dropout_rate, rng or DropoutRNG())

    def _ffn(self, x):
        return self.fc2(self.drop(F.relu(self.fc1(x))))

    def forward(self, x, memory, memory_mask=None, tgt_keep_mask=None):
        drop = self.drop
        x = self.ln1(x + drop(self.self_attn(x, key_mask=tgt_keep_mask, causal=True)))
        x = self.ln2(x + drop(self.cross_attn(x, kv=memory, key_mask=memory_mask)))
        return self.ln3(x + drop(self._ffn(x)))

    def step(self, x, cache_k, cache_v, cross_k, cross_v, index: int, memory_mask=None):
        x = self.ln1(x + self.self_attn.step(x, cache_k, cache_v, index))
        x = self.ln2(x + self.cross_attn.cross_step(x, cross_k, cross_v, memory_mask))
        return self.ln3(x + self._ffn(x))

    def step_k(self, x, cache_k, cache_v, cross_k, cross_v, pos, memory_mask=None):
        h, k_new, v_new = self.self_attn.step_k(x, cache_k, cache_v, pos)
        x = self.ln1(x + h)
        x = self.ln2(x + self.cross_attn.cross_step(x, cross_k, cross_v, memory_mask))
        return self.ln3(x + self._ffn(x)), k_new, v_new


def per_row_pe_rows(pe: torch.Tensor, pos: torch.Tensor, kk: int) -> torch.Tensor:
    """The PE rows of a K-token window at per-row start positions: (maxlen,
    D), (B,) -> (B, K, D), clamped at the table's end."""
    qpos = (pos[:, None] + torch.arange(kk, device=pos.device)[None, :]).clamp(max=pe.shape[0] - 1)
    return pe[qpos]


class DecoderStack:
    """What the custom and the phoneme triple decoders share (a mixin of
    ``nn.Module`` subclasses with a ``cfg`` that has ``d_model``,
    ``num_heads``, ``num_layers``, ``max_len`` and ``dtype``): the post-LN
    layer stack over the encoder memory, its stacked cache, the sinusoidal
    PE as a non-persistent buffer and the PE dropout. Each decoder embeds
    its tokens and reads its heads itself."""

    def _add_stack(self, layer_cfg: CustomDecoderConfig, device, rng: DropoutRNG) -> None:
        for i in range(layer_cfg.num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(layer_cfg, device, rng))
        self.layers = [getattr(self, f"layer_{i}") for i in range(layer_cfg.num_layers)]
        self.pe_drop = Dropout(layer_cfg.dropout_rate, rng)
        self.register_buffer("pe", self._pe_table(device), persistent=False)

    def _pe_table(self, device) -> torch.Tensor:
        return torch.tensor(sinusoidal_table(self.cfg.max_len, self.cfg.d_model), device=device)

    def _apply(self, fn, recurse=True):
        # the table is a function of the shape: rebuilt after every move, so
        # ``to_empty`` (which leaves buffers uninitialized) keeps it exact
        super()._apply(fn, recurse)
        if self.pe.device.type != "meta":
            self.pe = self._pe_table(self.pe.device)
        return self

    def _with_pe(self, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """(B, T, d) f32 embeddings + the PE rows from ``offset``, in the
        compute dtype."""
        return (x + self.pe[offset : offset + x.shape[1]][None]).to(self.cfg.dtype)

    def _with_pe_rows(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """(B, K, d) f32 embeddings + the PE rows of each row's window from
        its own ``pos`` (B,), in the compute dtype."""
        return (x + per_row_pe_rows(self.pe, pos, x.shape[1])).to(self.cfg.dtype)

    def _run_stack(self, x, memory, memory_mask=None, tgt_keep_mask=None) -> torch.Tensor:
        """Teacher-forced: PE dropout, then every layer."""
        memory_mask = None if memory_mask is None else memory_mask.bool()
        tgt_keep_mask = None if tgt_keep_mask is None else tgt_keep_mask.bool()
        x = self.pe_drop(x)
        memory = memory.to(self.cfg.dtype)
        for layer in self.layers:
            x = layer(x, memory, memory_mask, tgt_keep_mask)
        return x

    def init_cache(self, memory: torch.Tensor, max_len: int) -> Cache:
        """The stacked (L, B, H, T, d) self-attention cache and the stacked
        cross-attention K/V."""
        c = self.cfg
        memory = memory.to(c.dtype)
        shape = (c.num_layers, memory.shape[0], c.num_heads, max_len, c.d_model // c.num_heads)
        kv = [layer.cross_attn.project_kv(memory) for layer in self.layers]
        return {
            "k": torch.zeros(shape, dtype=c.dtype, device=memory.device),
            "v": torch.zeros(shape, dtype=c.dtype, device=memory.device),
            "ck": torch.stack([k for k, _ in kv]),
            "cv": torch.stack([v for _, v in kv]),
        }

    def _step_stack(self, x, cache: Cache, index: int, memory_mask=None) -> torch.Tensor:
        """Every layer's decode step at position ``index``, the cache written
        in place."""
        memory_mask = None if memory_mask is None else memory_mask.bool()
        for l, layer in enumerate(self.layers):
            x = layer.step(x, cache["k"][l], cache["v"][l], cache["ck"][l], cache["cv"][l],
                           index, memory_mask)
        return x

    def _step_k_stack(self, x, cache: Cache, pos, memory_mask=None) -> torch.Tensor:
        """Every layer's K-token step at the per-row positions ``pos``, then
        one write of all layers' window K/V into the cache."""
        memory_mask = None if memory_mask is None else memory_mask.bool()
        k_news, v_news = [], []
        for l, layer in enumerate(self.layers):
            x, k_new, v_new = layer.step_k(x, cache["k"][l], cache["v"][l], cache["ck"][l],
                                           cache["cv"][l], pos, memory_mask)
            k_news.append(k_new)
            v_news.append(v_new)
        scatter_window_kv(cache, torch.stack(k_news), torch.stack(v_news), pos)
        return x


class CustomDecoder(DecoderStack, nn.Module):
    """Scaled token embedding + sinusoidal PE + post-LN decoder stack + LM
    head. ``rng`` is the dropout stream it shares with the encoder."""

    def __init__(self, cfg: CustomDecoderConfig, device=None,
                 rng: Optional[DropoutRNG] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device,
                                  dtype=torch.float32)
        self._add_stack(cfg, device, rng or DropoutRNG())
        self.lm_head = _dense(cfg.d_model, cfg.vocab_size, cfg, device)

    def _embed(self, ids: torch.Tensor, offset: int = 0) -> torch.Tensor:
        return self._with_pe(self.embed(ids) * math.sqrt(self.cfg.d_model), offset)

    def forward(self, tgt_ids, memory, memory_mask=None, tgt_keep_mask=None):
        """Teacher-forced: (B, T) ids -> (B, T, V) f32 logits."""
        x = self._run_stack(self._embed(tgt_ids), memory, memory_mask, tgt_keep_mask)
        return self.lm_head(x).float()

    def step(self, tokens: torch.Tensor, cache: Cache, index: int, memory_mask=None):
        """One decode step at position ``index``: tokens (B,) -> ((B, V) f32
        logits, cache), the cache written in place."""
        x = self._step_stack(self._embed(tokens[:, None], offset=index), cache, index, memory_mask)
        return self.lm_head(x).float()[:, 0], cache

    def step_k(self, tokens: torch.Tensor, cache: Cache, pos, memory_mask=None):
        """A K-token decode step at the per-row positions ``pos`` (B,):
        tokens (B, K) -> ((B, K, V) f32 logits, cache), the window's K/V
        written in place."""
        x = self._with_pe_rows(self.embed(tokens) * math.sqrt(self.cfg.d_model), pos)
        return self.lm_head(self._step_k_stack(x, cache, pos, memory_mask)).float(), cache
