"""Plain float32 LaTr (Biten et al., "LaTr: Layout-Aware Transformer for
Scene-Text VQA", CVPR 2022) as the port configures it: a frozen ViT-base
over the pixels, projected to the T5 width; OCR tokens embedded by T5's
table plus six 2D position tables (x0, y0, x1, y1, w, h); the question
embedded by T5's table; one T5 encoder over [image | OCR | question]; the
T5 decoder and the tied LM head (hidden scaled by d_model^-0.5).
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F

from . import nn


def param_spec(c) -> "OrderedDict[str, tuple]":
    """name -> (shape, init): ``init`` is "one", "zero", or the standard
    deviation of a normal draw, as each part's published initialisation
    gives it: T5's (HF ``T5PreTrainedModel._init_weights``, factor 1:
    q N(0, (d_model d_kv)^-1/2), k and v N(0, d_model^-1/2), o
    N(0, (heads d_kv)^-1/2), wi N(0, d_model^-1/2), wo N(0, d_ff^-1/2),
    relative-bias tables N(0, d_model^-1/2)); ViT's (``initializer_range``
    0.02 for every matrix, the CLS token and the position table); a plain
    ``torch.nn.Linear`` for the projector (std (3 fan_in)^-1/2); norm scales
    1, biases 0. The token and 2D tables are N(0, d_model^-1/2), not T5's
    N(0, 1): with the tied head a unit table makes the decoder's own input
    token dominate every position's logits, so that no rounding, float8's
    included, changes a greedy token, and the output check could tell
    nothing apart (PERF.md, section 4)."""
    d, h, dk, ff, v = c["d_model"], c["num_heads"], c["d_kv"], c["d_ff"], c["t5_vocab_size"]
    hv, mlp, ps = c["vit_hidden_size"], c["vit_mlp_dim"], c["vit_patch_size"]
    tokens = (c["vit_image_size"] // ps) ** 2 + 1
    spec = OrderedDict()

    def mat(name, rows, cols, std, bias=False):
        spec[f"{name}.weight"] = ((rows, cols), std)
        if bias:
            spec[f"{name}.bias"] = ((rows,), "zero")

    def vec(name, n, init="one"):
        spec[name] = ((n,), init)

    spec["t5.shared.weight"] = ((v, d), d ** -0.5)
    for stack, n, kinds in (("encoder", c["num_encoder_layers"], ("attn",)),
                            ("decoder", c["num_t5_decoder_layers"], ("self_attn", "cross_attn"))):
        spec[f"t5.{stack}.rel_bias.rel_embedding.weight"] = ((32, h), d ** -0.5)
        for i in range(n):
            b = f"t5.{stack}.block_{i}"
            for j, kind in enumerate(kinds):
                vec(f"{b}.ln{j}.weight", d)
                mat(f"{b}.{kind}.q", h * dk, d, (d * dk) ** -0.5)
                mat(f"{b}.{kind}.k", h * dk, d, d ** -0.5)
                mat(f"{b}.{kind}.v", h * dk, d, d ** -0.5)
                mat(f"{b}.{kind}.o", d, h * dk, (h * dk) ** -0.5)
            vec(f"{b}.ln{len(kinds)}.weight", d)
            mat(f"{b}.ffn.wi_0", ff, d, d ** -0.5)
            mat(f"{b}.ffn.wi_1", ff, d, d ** -0.5)
            mat(f"{b}.ffn.wo", d, ff, ff ** -0.5)
        vec(f"t5.{stack}.final_ln.weight", d)
    spec["vit.patch_embed.weight"] = ((hv, 3, ps, ps), 0.02)
    vec("vit.patch_embed.bias", hv, "zero")
    spec["vit.cls_token"] = ((1, 1, hv), 0.02)
    spec["vit.position_embeddings"] = ((1, tokens, hv), 0.02)
    for i in range(c["vit_num_layers"]):
        b = f"vit.block_{i}"
        for ln in ("ln_before", "ln_after"):
            vec(f"{b}.{ln}.weight", hv)
            vec(f"{b}.{ln}.bias", hv, "zero")
        for proj in ("query", "key", "value", "out"):
            mat(f"{b}.attention.{proj}", hv, hv, 0.02, bias=True)
        mat(f"{b}.fc1", mlp, hv, 0.02, bias=True)
        mat(f"{b}.fc2", hv, mlp, 0.02, bias=True)
    vec("vit.final_ln.weight", hv)
    vec("vit.final_ln.bias", hv, "zero")
    mat("visual_projector", d, hv, (3 * hv) ** -0.5, bias=True)
    spec["spatial.tables"] = ((6, c["max_2d_position_embeddings"], d), d ** -0.5)
    return spec


def trainable(name: str) -> bool:
    """The ViT is frozen: it takes no gradient and no update."""
    return not name.startswith("vit.")


def vit(p, pixels, c, quant=None):
    """Pre-LN ViT: (B, 3, H, W) -> (B, 1 + patches, hidden)."""
    hv, ps = c["vit_hidden_size"], c["vit_patch_size"]
    w = p["vit.patch_embed.weight"]
    if quant is not None:
        pixels, w = quant(pixels), quant(w)
    x = F.conv2d(pixels, w, p["vit.patch_embed.bias"], stride=ps).flatten(2).transpose(1, 2)
    x = torch.cat([p["vit.cls_token"].expand(x.shape[0], -1, -1), x], 1)
    x = x + p["vit.position_embeddings"]
    hd = hv // c["vit_num_heads"]
    for i in range(c["vit_num_layers"]):
        b = f"vit.block_{i}"
        y = nn.layer_norm(p, f"{b}.ln_before", x, 1e-12)
        q, k, v = (nn.split_heads(nn.linear(p, f"{b}.attention.{n}", y, quant), hd)
                   for n in ("query", "key", "value"))
        a = nn.merge_heads(nn.attention(q, k, v, scale=hd ** -0.5, quant=quant))
        x = x + nn.linear(p, f"{b}.attention.out", a, quant)
        y = nn.layer_norm(p, f"{b}.ln_after", x, 1e-12)
        x = x + nn.linear(p, f"{b}.fc2", F.gelu(nn.linear(p, f"{b}.fc1", y, quant)), quant)
    return nn.layer_norm(p, "vit.final_ln", x, 1e-12)


def encode(p, batch, c, quant=None):
    """(encoder output, encoder mask) of a batch of input tensors."""
    with torch.no_grad():
        img = vit(p, batch["pixel_values"], c, quant)
    img = nn.linear(p, "visual_projector", img, quant)
    emb = p["t5.shared.weight"]
    coords = batch["coordinates"].long().clamp(0, c["max_2d_position_embeddings"] - 1)
    spatial = p["spatial.tables"][torch.arange(6, device=coords.device), coords].sum(2)
    x = torch.cat([img, emb[batch["tokenized_ocr"]] + spatial, emb[batch["input_ids"]]], 1)
    mask = torch.cat([torch.ones(img.shape[:2], dtype=torch.long, device=img.device),
                      batch["ocr_attention_mask"], batch["src_attention_mask"]], 1)
    bias = nn.t5_bias(p, "t5.encoder.rel_bias.rel_embedding", x.shape[1], x.shape[1], True,
                      x.device)
    return nn.t5_encoder(p, x, mask, bias, c, quant), mask


def logits(p, batch, labels, label_mask, c, quant=None):
    """Teacher-forced (B, T, V) logits for decoder inputs ``labels``."""
    enc, mask = encode(p, batch, c, quant)
    return nn.t5_decoder_logits(p, labels, label_mask, enc, mask, c, quant)


def loss(p, batch, c, quant=None):
    """The training loss: labels[:, :-1] in, labels[:, 1:] scored, pad 0
    ignored."""
    labels, mask = batch["label_ids"], batch["label_attention_mask"]
    out = logits(p, batch, labels[:, :-1], mask[:, :-1], c, quant)
    return nn.cross_entropy(out, labels[:, 1:], 0)
