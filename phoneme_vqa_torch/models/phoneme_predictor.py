"""Standalone phoneme predictor: a transformer encoder over per-word
(onset, rhyme, tone) embeddings with one log-softmax head per component.

Counterpart of the model part of ``examples/phoneme_predictor.py`` (the JAX
version of the reference's ``decode/multi_token.py: MultiTokensPredictor``).
Three embeddings are concatenated to a width of 3 x ``embed_dim``, a
sinusoidal table of 512 positions is added, then ``num_layers`` post-LN
encoder layers (8 heads, biased q / k / v / o, a ReLU FFN of width 2048),
then per component a LayerNorm, a Linear head and ``log_softmax``.

Held exactly as the JAX demo has it:

* LayerNorm eps is 1e-6 (flax's ``nn.LayerNorm`` default), not torch's 1e-5;
* the layers' width is the embeddings' width, 3 x ``embed_dim``:
  ``d_model`` is kept and never read, as in the demo (its ``--model-dim``
  changes nothing);
* a sentence is at most 512 tokens long (the table's length); a longer one
  raises here, where the demo fails on a broadcast.

Every layer's attention goes through ``ops.attention.dot_product_attention``
on (B, H, L, D) views of the projections' (B, L, H, D) storage, so on the
card a sentence of 16 tokens or more runs the attention kernel (head dim 48
at the default width), a shorter one the plain version, as the demo does on
a TPU. Submodules carry the flax scope names (``onset_embed``, ``layer_0.q``,
``layer_0.ln1``, ``onset_ln``, ``onset_head``), so ``models/bridge.py`` maps a
flax tree 1:1 (:func:`phoneme_predictor_from_flax`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..phonology.analyze import is_vietnamese_3
from .bridge import load_flax_params
from .custom_decoder import sinusoidal_table
from .vit import LayerNorm

PARTS = ("onset", "rhyme", "tone")
MAX_LEN = 512  # rows of the positional table
LN_EPS = 1e-6  # flax nn.LayerNorm's default
NUM_HEADS = 8
D_FF = 2048


class EncoderLayer(nn.Module):
    """Post-LN self-attention + ReLU FFN block (the demo's ``EncoderLayer``)."""

    def __init__(self, d_model: int, num_heads: int = NUM_HEADS, d_ff: int = D_FF,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        dense = lambda d_in, d_out: nn.Linear(d_in, d_out, device=device, dtype=dtype)
        self.q, self.k, self.v, self.o = (dense(d_model, d_model) for _ in range(4))
        self.ln1 = LayerNorm(d_model, LN_EPS, dtype, device)
        self.fc1 = dense(d_model, d_ff)
        self.fc2 = dense(d_ff, d_model)
        self.ln2 = LayerNorm(d_model, LN_EPS, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        split = lambda t: t.view(b, l, self.num_heads, self.head_dim).transpose(1, 2)
        a = dot_product_attention(split(self.q(x)), split(self.k(x)), split(self.v(x)),
                                  scale=self.head_dim ** -0.5)
        x = self.ln1(x + self.o(a.transpose(1, 2).reshape(b, l, -1)))
        return self.ln2(x + self.fc2(F.relu(self.fc1(x))))


class MultiTokensPredictor(nn.Module):
    """Per-token (onset, rhyme, tone) predictor over phoneme embeddings.

    ``vocab`` is ``{"onset": {...}, "rhyme": {...}, "tone": {...}}``;
    ``forward`` takes (B, T, 3) ids and returns each part's (B, T, V_part)
    log-probabilities in f32."""

    def __init__(self, vocab: Dict[str, Dict[str, int]], d_model: int = 384,
                 embed_dim: int = 128, num_layers: int = 6, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        width = 3 * embed_dim  # d_model is accepted and never read, as in the JAX demo
        for part in PARTS:
            self.add_module(f"{part}_embed", nn.Embedding(len(vocab[part]), embed_dim,
                                                          device=device, dtype=dtype))
        for i in range(num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(width, device=device, dtype=dtype))
        self.layers = [getattr(self, f"layer_{i}") for i in range(num_layers)]
        for part in PARTS:
            self.add_module(f"{part}_ln", LayerNorm(width, LN_EPS, dtype, device))
            self.add_module(f"{part}_head", nn.Linear(width, len(vocab[part]), device=device,
                                                      dtype=dtype))
        self.register_buffer("pe", torch.tensor(sinusoidal_table(MAX_LEN, width), device=device,
                                                dtype=dtype), persistent=False)

    def forward(self, triples: torch.Tensor) -> Dict[str, torch.Tensor]:
        t = triples.shape[1]
        if t > MAX_LEN:
            raise ValueError(f"MultiTokensPredictor: {t} tokens, at most {MAX_LEN} (the "
                             "positional table's length)")
        x = torch.cat([getattr(self, f"{part}_embed")(triples[..., i])
                       for i, part in enumerate(PARTS)], dim=-1)
        x = x + self.pe[None, :t]
        for layer in self.layers:
            x = layer(x)
        return {part: F.log_softmax(getattr(self, f"{part}_head")(
            getattr(self, f"{part}_ln")(x)).float(), dim=-1) for part in PARTS}


@torch.no_grad()
def init_weights(model: MultiTokensPredictor, generator: torch.Generator) -> MultiTokensPredictor:
    """A seeded random init at flax's scales (the demo's ``PRNGKey(0)`` draws
    cannot be reproduced): Linear weights N(0, 1/fan_in) and zero biases
    (lecun normal), embeddings N(0, 1/dim), LayerNorms one and zero. Drawn
    on the CPU from ``generator`` in module order, so a seed gives the same
    weights on every device."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):  # fan in: the weight's last axis
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * m.weight.shape[-1] ** -0.5)
        if isinstance(m, nn.Linear):
            m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model


def phoneme_predictor_from_flax(params, vocab: Dict[str, Dict[str, int]], device="cpu",
                                dtype: torch.dtype = torch.float32) -> MultiTokensPredictor:
    """The port's predictor holding the weights of a flax
    ``MultiTokensPredictor`` tree (``{"params": ...}`` or the tree itself):
    the embedding width and depth read off the tree, every leaf mapped by
    ``models/bridge.py``, which raises on a flax leaf with no counterpart
    and on a parameter that no leaf fills."""
    tree = params["params"] if "params" in params and len(params) == 1 else params
    embed_dim = int(np.shape(tree["onset_embed"]["embedding"])[1])
    num_layers = sum(1 for k in tree if k.startswith("layer_"))
    model = MultiTokensPredictor(vocab, embed_dim=embed_dim, num_layers=num_layers,
                                 device=device, dtype=dtype)
    return load_flax_params(model, tree)


def encode_sentence(vocab: Dict[str, Dict[str, int]], sentence: str) -> np.ndarray:
    """(1, T, 3) int32 ids: a Vietnamese word is one (onset, rhyme, tone)
    triple ("none" for an empty part, id 0 for an unknown one); any other
    word is one triple a character, (its onset id, 0, 0)."""
    triples = []
    for word in sentence.lower().split():
        ok, (onset, rhyme, tone) = is_vietnamese_3(word)
        if ok:
            triples.append((vocab["onset"].get(onset or "none", 0),
                            vocab["rhyme"].get(rhyme or "none", 0),
                            vocab["tone"].get(tone or "none", 0)))
        else:
            for ch in word:
                triples.append((vocab["onset"].get(ch, 0), 0, 0))
    return np.asarray([triples], np.int32)


def argmax_parts(vocab: Dict[str, Dict[str, int]], heads: Dict[str, torch.Tensor],
                 row: int = 0) -> list:
    """Each token's argmax (onset, rhyme, tone) names in batch row ``row``."""
    inv = {p: {i: t for t, i in vocab[p].items()} for p in PARTS}
    ids = {p: heads[p][row].argmax(-1).tolist() for p in PARTS}
    return [tuple(inv[p][ids[p][i]] for p in PARTS) for i in range(len(ids["onset"]))]
