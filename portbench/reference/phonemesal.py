"""Plain float32 PhonemeSaL as the port configures it: SaL's encoder
(Fang et al., "Separate and Locate: Rethink the Text in Text-based Visual
Question Answering", ACM MM 2023) and a post-LN transformer decoder over the
flat phoneme vocabulary.

* question tokens embedded by T5's table; each OCR and object token by
  T5's table plus RMSNorm(feature projection) plus RMSNorm(box projection),
  one norm per stream applied to both projections;
* one T5 encoder over [question | OCR | objects] whose attention bias is
  SaL's 2D bias: a bucketed 1D sequence-distance bias everywhere, plus,
  between two OCR tokens, a bias bucketed from the distance of their box
  centres on an 11 x 11 grid (x5);
* the decoder: token embedding x sqrt(d_model) plus the sinusoidal table,
  post-LN layers (causal self-attention, cross-attention, a ReLU FFN,
  LayerNorm eps 1e-5), attention scaled by (d_model / heads)^-0.5, and a
  biased LM head.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from . import nn

GRID = 11


def param_spec(c) -> "OrderedDict[str, tuple]":
    """name -> (shape, init), each part's published initialisation, as
    :func:`reference.latr.param_spec`: T5's for the encoder and the shared
    table; a plain ``torch.nn.Linear`` (std (3 fan_in)^-1/2) for the SaL
    projections, the decoder's FFN, output projections and LM head; Xavier
    (std (2 / (in + out))^1/2) for the decoder's q, k, v (``nn.MultiheadAttention``'s
    in-projection); the 2D-bias tables as T5's relative bias,
    N(0, d_model^-1/2); the token tables (T5's and the decoder's) N(0,
    d_model^-1/2), for the reason given there."""
    d, h, dk, ff, v = c["d_model"], c["num_heads"], c["d_kv"], c["d_ff"], c["t5_vocab_size"]
    spec = OrderedDict()

    def mat(name, rows, cols, std, bias=False):
        spec[f"{name}.weight"] = ((rows, cols), std)
        if bias:
            spec[f"{name}.bias"] = ((rows,), "zero")

    def plain(name, rows, cols):
        mat(name, rows, cols, (3 * cols) ** -0.5, bias=True)

    def norm(name, n, with_bias=False):
        spec[f"{name}.weight"] = ((n,), "one")
        if with_bias:
            spec[f"{name}.bias"] = ((n,), "zero")

    spec["t5.shared.weight"] = ((v, d), d ** -0.5)
    for i in range(c["num_encoder_layers"]):
        b = f"t5.encoder.block_{i}"
        norm(f"{b}.ln0", d)
        mat(f"{b}.attn.q", h * dk, d, (d * dk) ** -0.5)
        mat(f"{b}.attn.k", h * dk, d, d ** -0.5)
        mat(f"{b}.attn.v", h * dk, d, d ** -0.5)
        mat(f"{b}.attn.o", d, h * dk, (h * dk) ** -0.5)
        norm(f"{b}.ln1", d)
        mat(f"{b}.ffn.wi_0", ff, d, d ** -0.5)
        mat(f"{b}.ffn.wi_1", ff, d, d ** -0.5)
        mat(f"{b}.ffn.wo", d, ff, ff ** -0.5)
    norm("t5.encoder.final_ln", d)
    spec["rel2d.rel1d.weight"] = ((32, h), d ** -0.5)
    spec["rel2d.scp.weight"] = ((32, h), d ** -0.5)
    for stream, width in (("ocr", c["ocr_hidden"]), ("obj", c["obj_hidden"])):
        plain(f"{stream}_feature_projector", d, width)
        plain(f"{stream}_bbox_projector", d, 4)
        norm(f"{stream}_norm", d)
    va, dh = c["answer_vocab_size"], c["decoder_d_ff"]
    spec["decoder.embed.weight"] = ((va, d), d ** -0.5)
    for i in range(c["num_decoder_layers"]):
        b = f"decoder.layer_{i}"
        for kind in ("self_attn", "cross_attn"):
            for proj in ("q", "k", "v"):
                mat(f"{b}.{kind}.{proj}", d, d, (2 / (d + d)) ** 0.5, bias=True)
            plain(f"{b}.{kind}.out", d, d)
        for ln in ("ln1", "ln2", "ln3"):
            norm(f"{b}.{ln}", d, with_bias=True)
        plain(f"{b}.fc1", dh, d)
        plain(f"{b}.fc2", d, dh)
    plain("decoder.lm_head", va, d)
    return spec


def trainable(name: str) -> bool:
    return True


def _grid_distance() -> np.ndarray:
    xs, ys = np.mgrid[0:GRID, 0:GRID]
    cells = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float64)
    return (np.sqrt(((cells[:, None] - cells[None]) ** 2).sum(-1)) * 5).astype(np.int32)


def sal_bias(p, ocr_coords, seq_len, c):
    """(B, H, L, L) 2D bias: the 1D bias everywhere plus the grid-distance
    bias between positions of the OCR block [max_q, max_q + max_ocr). Each
    OCR position's cell is its box centre on the grid, padding included
    (box zeros: cell 0)."""
    dev = ocr_coords.device
    pos = torch.arange(seq_len, device=dev)
    b1 = p["rel2d.rel1d.weight"][nn.relative_bucket(pos[None] - pos[:, None], True)]
    bias = b1.permute(2, 0, 1)[None].repeat(ocr_coords.shape[0], 1, 1, 1)
    table = torch.from_numpy(_grid_distance()).to(dev).long()
    cell_bias = p["rel2d.scp.weight"][nn.relative_bucket(table, True, 32, 100)]  # (121, 121, H)
    cx = (ocr_coords[..., 0] + ocr_coords[..., 2]) / 2
    cy = (ocr_coords[..., 1] + ocr_coords[..., 3]) / 2
    cell = (torch.floor(cx * GRID).long().clamp(0, GRID - 1) * GRID
            + torch.floor(cy * GRID).long().clamp(0, GRID - 1))  # (B, Lo)
    lo, q0 = ocr_coords.shape[1], c["max_q_length"]
    scp = cell_bias[cell[:, :, None], cell[:, None, :]].permute(0, 3, 1, 2)  # (B, H, Lo, Lo)
    bias[:, :, q0:q0 + lo, q0:q0 + lo] += scp
    return bias


def encode(p, batch, c, quant=None):
    emb = p["t5.shared.weight"]

    def stream(name, ids, coords, feats):
        return (nn.rms_norm(p, f"{name}_norm", nn.linear(p, f"{name}_feature_projector", feats,
                                                         quant))
                + nn.rms_norm(p, f"{name}_norm", nn.linear(p, f"{name}_bbox_projector", coords,
                                                           quant))
                + emb[ids])

    x = torch.cat([emb[batch["input_ids"]],
                   stream("ocr", batch["tokenized_ocr"], batch["ocr_coordinates"],
                          batch["ocr_features"]),
                   stream("obj", batch["tokenized_obj"], batch["obj_coordinates"],
                          batch["obj_features"])], 1)
    mask = torch.cat([batch["src_attention_mask"], batch["ocr_attention_mask"],
                      batch["obj_attention_mask"]], 1)
    bias = sal_bias(p, batch["ocr_coordinates"], x.shape[1], c)
    return nn.t5_encoder(p, x, mask, bias, c, quant), mask


def sinusoid(n, d, device):
    pos = np.arange(n)[:, None].astype(np.float64)
    div = np.exp(-np.arange(0, d, 2) * (np.log(10000.0) / d))
    table = np.zeros((n, d), np.float32)
    table[:, 0::2], table[:, 1::2] = np.sin(pos * div), np.cos(pos * div)
    return torch.from_numpy(table).to(device)


def decoder_logits(p, labels, label_mask, enc, enc_mask, c, quant=None):
    d, h = c["d_model"], c["n_head"]
    hd, scale = d // h, (d // h) ** -0.5
    x = p["decoder.embed.weight"][labels] * math.sqrt(d) + sinusoid(labels.shape[1], d,
                                                                     labels.device)[None]

    def mha(name, q_in, kv, **kw):
        q, k, v = (nn.split_heads(nn.linear(p, f"{name}.{n}", t, quant), hd)
                   for n, t in (("q", q_in), ("k", kv), ("v", kv)))
        return nn.linear(p, f"{name}.out", nn.merge_heads(
            nn.attention(q, k, v, scale=scale, quant=quant, **kw)), quant)

    for i in range(c["num_decoder_layers"]):
        b = f"decoder.layer_{i}"
        x = nn.layer_norm(p, f"{b}.ln1", x + mha(f"{b}.self_attn", x, x, key_mask=label_mask,
                                                 causal=True), 1e-5)
        x = nn.layer_norm(p, f"{b}.ln2", x + mha(f"{b}.cross_attn", x, enc, key_mask=enc_mask),
                          1e-5)
        ffn = nn.linear(p, f"{b}.fc2", F.relu(nn.linear(p, f"{b}.fc1", x, quant)), quant)
        x = nn.layer_norm(p, f"{b}.ln3", x + ffn, 1e-5)
    return nn.linear(p, "decoder.lm_head", x, quant)


def logits(p, batch, labels, label_mask, c, quant=None):
    enc, mask = encode(p, batch, c, quant)
    return decoder_logits(p, labels, label_mask, enc, mask, c, quant)


def loss(p, batch, c, quant=None):
    labels, mask = batch["label_ids"], batch["label_attention_mask"]
    out = logits(p, batch, labels[:, :-1], mask[:, :-1], c, quant)
    return nn.cross_entropy(out, labels[:, 1:], c["answer_pad_id"])
