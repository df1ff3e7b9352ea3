"""The counted work: operations and bytes of each attention-kernel call, and
the matrix-product operations of a whole train step or a served row, from
the configuration's widths and the cell's shapes alone, so that they read
the same whatever implements them.

* Operations are 2 per multiply-add of every matrix product: the linear
  layers (2 x in x out a token), attention (4 x B x H x Lq x Lk x D; a
  causal call its lower triangle, Lq (Lq + 1) / 2 pairs), the LM head.
  Embedding lookups, norms and softmax are not counted.
* A train step is the forward plus a backward of twice the forward's
  operations for everything that trains; a frozen part (LaTr's ViT) runs
  its forward only.
* A kernel call's bound is the larger of its operations at the bf16 peak
  and its bytes at the HBM bandwidth, each input read once and each output
  written once (bf16 q, k, v and output; the T5 bias (1, H, Lq, Lk) in
  float32; SaL's 1D bias (H, L, L) and cell bias (H, 122, 122) in bf16 and
  its (B, L) int32 cells; key masks as int32).
"""

from __future__ import annotations

from typing import List, NamedTuple

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth
BF16_PEAK_FLOP_S = 989e12
HBM_BYTES_S = 3.35e12


class Call(NamedTuple):
    """One attention-kernel call: its kernel ("flash" or "sal"), shapes and
    options, and how many of it a step (or a served batch) makes."""
    kernel: str
    b: int
    h: int
    lq: int
    lk: int
    d: int
    causal: bool = False
    bias: str = ""  # "", "t5" (1, H, Lq, Lk) f32, or "sal"
    mask: bool = False
    count: int = 1


def call_flops(c: Call) -> float:
    pairs = c.lq * (c.lq + 1) // 2 if c.causal else c.lq * c.lk
    return 4.0 * c.b * c.h * pairs * c.d


def call_bytes(c: Call) -> float:
    n = 2 * c.b * c.h * (c.lq + c.lk) * c.d * 2  # q and out, k and v: bf16
    if c.bias == "t5":
        n += c.h * c.lq * c.lk * 4
    elif c.bias == "sal":
        n += c.h * c.lq * c.lk * 2 + c.h * 122 * 122 * 2 + c.b * c.lq * 4
    if c.mask:
        n += c.b * c.lk * 4
    return float(n)


def call_bound_s(c: Call) -> float:
    return max(call_flops(c) / BF16_PEAK_FLOP_S, call_bytes(c) / HBM_BYTES_S)


def bound_s(calls: List[Call], kernel: str) -> float:
    """The least time the card could take for ``kernel``'s calls."""
    return sum(c.count * call_bound_s(c) for c in calls if c.kernel == kernel)


def _attn(b, h, lq, lk, d, causal=False):
    return 4.0 * b * h * d * (lq * (lq + 1) // 2 if causal else lq * lk)


def _t5_block(c, tokens):
    d, ff = c["d_model"], c["d_ff"]
    return 2.0 * tokens * (4 * d * d + 3 * d * ff)


def _t5_decoder_step(c, b, t_dec, l_enc):
    """The T5 decoder over ``t_dec`` teacher-forced positions (or one
    position against a cache of ``t_dec``) and the tied head."""
    d, ff, h, dk, v = (c[k] for k in ("d_model", "d_ff", "num_heads", "d_kv", "t5_vocab_size"))
    n = c["num_t5_decoder_layers"]
    lin = 2.0 * b * n * (t_dec * (6 * d * d + 3 * d * ff) + l_enc * 2 * d * d)
    att = n * (_attn(b, h, t_dec, t_dec, dk, True) + _attn(b, h, t_dec, l_enc, dk))
    return lin + att + 2.0 * b * t_dec * d * v


def latr_enc_len(c) -> int:
    return (c["vit_image_size"] // c["vit_patch_size"]) ** 2 + 1 + c["max_ocr_length"] \
        + c["max_q_length"]


def latr_parts(c, b):
    """Forward operations of LaTr's ViT and of its encoder stack (projector
    included) for ``b`` rows."""
    hv, mlp, n_vit, ps = (c[k] for k in ("vit_hidden_size", "vit_mlp_dim", "vit_num_layers",
                                        "vit_patch_size"))
    patches = (c["vit_image_size"] // ps) ** 2
    lv, le, d = patches + 1, latr_enc_len(c), c["d_model"]
    vit = 2.0 * b * (patches * 3 * ps * ps * hv + lv * n_vit * (4 * hv * hv + 2 * hv * mlp))
    vit += n_vit * _attn(b, c["vit_num_heads"], lv, lv, hv // c["vit_num_heads"])
    enc = 2.0 * b * lv * hv * d + c["num_encoder_layers"] * (
        _t5_block(c, b * le) + _attn(b, c["num_heads"], le, le, c["d_kv"]))
    return vit, enc


def latr_train_step_flops(c, b) -> float:
    """LaTr-base train step: the frozen ViT forward only; answers of
    ``max_a_length`` ids, so the decoder reads ``max_a_length - 1``."""
    vit, enc = latr_parts(c, b)
    dec = _t5_decoder_step(c, b, c["max_a_length"] - 1, latr_enc_len(c))
    return vit + 3 * (enc + dec)


def latr_served_row_flops(c, steps: int) -> float:
    """One served LaTr row: the encode, the cross K/V, and ``steps`` decode
    steps, step t attending t + 1 cached positions."""
    vit, enc = latr_parts(c, 1)
    d, ff, h, dk, v = (c[k] for k in ("d_model", "d_ff", "num_heads", "d_kv", "t5_vocab_size"))
    n, le = c["num_t5_decoder_layers"], latr_enc_len(c)
    total = vit + enc + 2.0 * n * le * 2 * d * d
    for t in range(steps):
        total += 2.0 * n * (6 * d * d + 3 * d * ff) + 2.0 * d * v
        total += n * (_attn(1, h, 1, t + 1, dk) + _attn(1, h, 1, le, dk))
    return total


def latr_train_calls(c, b) -> List[Call]:
    lv = (c["vit_image_size"] // c["vit_patch_size"]) ** 2 + 1
    le, t = latr_enc_len(c), c["max_a_length"] - 1
    h, dk = c["num_heads"], c["d_kv"]
    vh = c["vit_num_heads"]
    return [Call("flash", b, vh, lv, lv, c["vit_hidden_size"] // vh, count=c["vit_num_layers"]),
            Call("flash", b, h, le, le, dk, bias="t5", mask=True, count=c["num_encoder_layers"]),
            Call("flash", b, h, t, t, dk, causal=True, bias="t5", mask=True,
                 count=c["num_t5_decoder_layers"]),
            Call("flash", b, h, t, le, dk, mask=True, count=c["num_t5_decoder_layers"])]


def latr_serve_calls(c, b) -> List[Call]:
    """The attention-kernel calls of one served batch of ``b`` rows: the
    ViT's and the encoder's (the one-token decode steps stay plain)."""
    return latr_train_calls(c, b)[:2]


def sal_enc_len(c) -> int:
    return c["max_q_length"] + c["max_ocr_length"] + c["max_obj_length"]


def phonemesal_encode(c, b) -> float:
    """Forward operations of PhonemeSaL's feature projections and its
    encoder stack for ``b`` rows."""
    d, h, dk = c["d_model"], c["num_heads"], c["d_kv"]
    le, lo, lb = sal_enc_len(c), c["max_ocr_length"], c["max_obj_length"]
    front = 2.0 * b * (lo * (c["ocr_hidden"] + 4) * d + lb * (c["obj_hidden"] + 4) * d)
    return front + c["num_encoder_layers"] * (_t5_block(c, b * le) + _attn(b, h, le, le, dk))


def phonemesal_train_step_flops(c, b) -> float:
    """PhonemeSaL-base train step: every part trains (3 x the forward)."""
    d = c["d_model"]
    le, t = sal_enc_len(c), c["max_a_length"] - 1
    nd, dh, hd = c["num_decoder_layers"], c["decoder_d_ff"], d // c["n_head"]
    dec = 2.0 * b * nd * (t * (6 * d * d + 2 * d * dh) + le * 2 * d * d)
    dec += nd * (_attn(b, c["n_head"], t, t, hd, True) + _attn(b, c["n_head"], t, le, hd))
    dec += 2.0 * b * t * d * c["answer_vocab_size"]
    return 3 * (phonemesal_encode(c, b) + dec)


def phonemesal_served_row_flops(c, steps: int) -> float:
    """One served PhonemeSaL row: the encode, the cross K/V, and ``steps``
    decode steps of the custom decoder, step t attending t + 1 cached
    positions."""
    d, le = c["d_model"], sal_enc_len(c)
    nd, dh, hn = c["num_decoder_layers"], c["decoder_d_ff"], c["n_head"]
    total = phonemesal_encode(c, 1) + 2.0 * nd * le * 2 * d * d
    for t in range(steps):
        total += 2.0 * nd * (6 * d * d + 2 * d * dh) + 2.0 * d * c["answer_vocab_size"]
        total += nd * (_attn(1, hn, 1, t + 1, d // hn) + _attn(1, hn, 1, le, d // hn))
    return total


def phonemesal_train_calls(c, b) -> List[Call]:
    le, t = sal_enc_len(c), c["max_a_length"] - 1
    nd, hd = c["num_decoder_layers"], c["d_model"] // c["n_head"]
    return [Call("sal", b, c["num_heads"], le, le, c["d_kv"], bias="sal", mask=True,
                 count=c["num_encoder_layers"]),
            Call("flash", b, c["n_head"], t, t, hd, causal=True, mask=True, count=nd),
            Call("flash", b, c["n_head"], t, le, hd, mask=True, count=nd)]


def phonemesal_serve_calls(c, b) -> List[Call]:
    """The attention-kernel calls of one served batch of ``b`` rows: the
    encoder's through the SaL kernel (the one-token decode steps stay
    plain)."""
    return phonemesal_train_calls(c, b)[:1]
