"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried past):
1.  the card's name and power limit; TF32 off for f32 matmuls and convolutions
2.  build both CUDA kernels from csrc/ with nvcc, one process each, started
    together (prints -Xptxas -v; fails if a bf16 TMA + wgmma kernel spills)
3.  the attention kernel against its plain PyTorch version over dtypes,
    options, lengths and head dims (32, 64, 128), and at the two shapes the
    LaTr serving path gives it; q, k, v as (B, H, L, D) views of (B, L, H, D)
    storage (the models' layout) give bit for bit what contiguous copies give
3b. the SaL kernel against its plain version (materialize the bias, then
    plain attention) over dtypes, table types, lengths, head dims, masks and
    cells, and at the SaL serving shape; views bit-equal as in phase 3
4.  full-width LaTr-base (seeded random weights) answers synthetic requests
    through ServingEngine at batch 32 in bf16; the attention kernel must
    launch 24 times per batch (12 ViT + 12 T5 encoder layers), the SaL one 0
4b. full-width SaL-base (seeded random weights) answers synthetic requests
    the same way; the SaL kernel must launch 12 times per batch (every
    encoder layer), the attention kernel 0
5.  LaTr in f32 on one batch: teacher-forced logits and greedy tokens
    through the kernels against the same model with plain attention
5b. the same for SaL; its plain attention materializes the 2D bias
6.  attention kernel, plain and library (SDPA) times at the LaTr serving
    shapes, CUDA events
6b. SaL kernel, plain and library times at the SaL serving shape
6c. ablations: the kernels at the serving shapes with part of their work
    taken away (the T5 encoder without its bias, its mask or both, with
    contiguous q, k, v; the SaL shape with f32 tables, and through the
    attention kernel with its key mask only, i.e. without the SaL policy)

Prints a {"kernels": [...]} line, the card line, and last
{"ok": true, "device": {...}}. Needs the repo's phoneme_vqa_torch package;
imports no JAX.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA card is available")

from phoneme_vqa_torch.data import synthetic  # noqa: E402
from phoneme_vqa_torch.data.adapters import textlayout_obj_adapt  # noqa: E402
from phoneme_vqa_torch.data.adapters import textlayout_ocr_adapt  # noqa: E402
from phoneme_vqa_torch.data.loader import batch_iterator  # noqa: E402
from phoneme_vqa_torch.decode.greedy import greedy_decode  # noqa: E402
from phoneme_vqa_torch.models import latr as latr_mod  # noqa: E402
from phoneme_vqa_torch.models import sal as sal_mod  # noqa: E402
from phoneme_vqa_torch.models import t5 as t5_mod  # noqa: E402
from phoneme_vqa_torch.models import vit as vit_mod  # noqa: E402
from phoneme_vqa_torch.ops import _build  # noqa: E402
from phoneme_vqa_torch.ops import attention as attn_mod  # noqa: E402
from phoneme_vqa_torch.ops import flash_attention as fa  # noqa: E402
from phoneme_vqa_torch.ops import layout  # noqa: E402
from phoneme_vqa_torch.ops import sal_fused_attention as sfa  # noqa: E402
from phoneme_vqa_torch.serving import SaLInputs, ServingEngine, featurize_requests  # noqa: E402
from phoneme_vqa_torch.tokenizers.backbone import FallbackSubwordTokenizer  # noqa: E402

DEVICE = torch.device("cuda")
BATCH = 32
N_REQUESTS = 64
MAX_ANSWER = 20
SEED = 0
# vit5-base: T5 768/12 heads/d_kv 64/d_ff 3072/12+12 layers/vocab 36096
T5_BASE = {
    "t5_vocab_size": 36096, "d_model": 768, "d_kv": 64, "num_heads": 12, "d_ff": 3072,
    "num_encoder_layers": 12, "num_t5_decoder_layers": 12,
}
# LaTr-base at full width: vit5-base + ViT-base 224/16; OCR 100, question 30
# -> encoder 327
FULL = dict(
    T5_BASE, vit_image_size=224, vit_patch_size=16, vit_hidden_size=768, vit_num_layers=12,
    vit_num_heads=12, vit_mlp_dim=3072, max_2d_position_embeddings=1024,
)
OCR_ELEMENTS, OCR_LEN, Q_LEN = 50, 100, 30
# SaL-base at full width (configs/sal.yaml): vit5-base; question 80, OCR 128,
# objects 128 -> encoder 336; OCR features 512, region features 2048; up to
# 32 OCR words and 32 objects per image
SAL_FULL = dict(T5_BASE, ocr_hidden=512, obj_hidden=2048, max_q_length=80, max_ocr_length=128)
SAL_OCR_ELEMENTS, SAL_OBJ_ELEMENTS, SAL_OBJ_LEN = 32, 32, 128
SAL_L = SAL_FULL["max_q_length"] + SAL_FULL["max_ocr_length"] + SAL_OBJ_LEN
# f32: the kernels sum q·k and P·v in another order than cuBLAS; rounding is
# ~1e-6 relative and the softmax's exp scales it by the logit size. bf16: a
# kernel's output is rounded to bf16 (2^-8 relative); the plain result is f32
# on the same bf16 inputs.
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# end to end in f32 the per-layer differences above pass through 24 layers and
# the LM head; logits are O(1)
LOGITS_TOL = 2e-3
TIE_MARGIN = 1e-4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak
KERNELS = {"flash_attention": fa, "sal_fused_attention": sfa}  # name -> wrapper module
# csrc/attention_core.cuh; the ring depth is what shared memory leaves for 2
# blocks an SM
DESIGN = ("bf16: TMA + wgmma; 1 producer warp + 1 consumer warpgroup (64 query rows) a block, "
          "2 blocks an SM, persistent grid; a K ring (K, the bias or bias1d tile, the key "
          "fix-ups) and a V ring of 3 stages each (2 when a tile carries a bias tile) on their "
          "own full/empty mbarriers; S = QK^T and O += PV on wgmma, P from registers, V read "
          "MN-major; tiles without masked keys skip the fix-ups; q/k/v/out by strides. "
          "f32: CUDA-core FMAs")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def reset_launches() -> None:
    for mod in KERNELS.values():
        mod.LAUNCHES = 0


def launches() -> dict:
    return {name: mod.LAUNCHES for name, mod in KERNELS.items()}


def check_launches(phase: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{phase}: kernel launches {got}, want {want}")


# -- phase 3 ------------------------------------------------------------------


def _attn_inputs(b, h, lq, lk, d, dtype, seed=0):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device=DEVICE)
    q, k, v = rnd(b, h, lq, d).to(dtype), rnd(b, h, lk, d).to(dtype), rnd(b, h, lk, d).to(dtype)
    bias = rnd(b, h, lq, lk)
    mask = (torch.rand(b, lk, generator=g, device=DEVICE) > 0.3).to(torch.int32)
    mask[0, 0] = 1
    mask[-1] = 0  # a row that attends nowhere averages v over the Lk keys
    return q, k, v, bias, mask


def _compare(q, k, v, bias, mask, causal, scale) -> float:
    got = fa.fused_attention(q, k, v, bias, mask, causal, scale)
    torch.cuda.synchronize()
    want = attn_mod.reference_attention(q.float(), k.float(), v.float(), bias, mask, causal, scale)
    err = float((got.float() - want).abs().max())
    tol = TOL[q.dtype]
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
    return err


def check_kernel_grid() -> dict:
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for dtype, length, d in itertools.product(worst, (16, 37, 131, 197, 327, 512), (64, 32, 128)):
        q, k, v, bias_full, mask = _attn_inputs(2, 3, length, length, d, dtype)
        for bias_kind, use_mask, causal, scale in itertools.product(
            ("none", "one", "batch"), (False, True), (False, True), (None, d**-0.5)
        ):
            bias = {"none": None, "one": bias_full[:1].contiguous(), "batch": bias_full}[bias_kind]
            err = _compare(q, k, v, bias, mask if use_mask else None, causal, scale)
            worst[dtype] = max(worst[dtype], err)
            n += 1
    # decoder cross-attention lengths (teacher forced): Lq 20 over Lk 327
    for dtype, causal in itertools.product(worst, (False, True)):
        q, k, v, _, mask = _attn_inputs(2, 4, 20, 327, 64, dtype, seed=1)
        worst[dtype] = max(worst[dtype], _compare(q, k, v, None, mask, causal, None))
        n += 1
    # the two serving-path shapes, in the serving dtype
    for args in serving_shapes():
        worst[torch.bfloat16] = max(worst[torch.bfloat16], _compare(*args))
        n += 1
    def attn_calls(q, k, v, seed):
        b, h, lq, d = q.shape
        _, _, _, bias, mask = _attn_inputs(b, h, lq, k.shape[2], d, q.dtype, seed)
        return [(fa.fused_attention, (q, k, v, bias_, mask, causal, scale))
                for bias_, causal, scale in ((None, False, d**-0.5),
                                             (bias[:1].contiguous(), True, None),
                                             (bias, False, None))]

    n_views = check_views(attn_calls, [(37, 37), (131, 131), (20, 327)])
    log(f"phase 3: kernel == plain over {n} cases; max |err| f32 {worst[torch.float32]:.3e} "
        f"(tol {TOL[torch.float32]}), bf16 {worst[torch.bfloat16]:.3e} "
        f"(tol {TOL[torch.bfloat16]}); views of (B, L, H, D) storage == contiguous bit for "
        f"bit in {n_views} cases")
    return worst


def check_views(calls, lengths) -> int:
    """For f32 and bf16, head dims 32, 64, 128 and each (Lq, Lk) in
    ``lengths``: every (kernel, args) of ``calls(q, k, v, seed)`` on q, k, v
    in the models' layout must equal the same call on contiguous copies bit
    for bit, output strides included."""
    n = 0
    for dtype, d, (lq, lk) in itertools.product((torch.float32, torch.bfloat16), (32, 64, 128),
                                                lengths):
        q, k, v, _, _ = _attn_inputs(2, 3, lq, lk, d, dtype, seed=7)
        views = model_layout(q, k, v)
        for (kernel, args), (_, view_args) in zip(calls(q, k, v, 7), calls(*views, 7)):
            want, got = kernel(*args), kernel(*view_args)
            torch.cuda.synchronize()
            if got.stride() != want.stride() or not torch.equal(got, want):
                raise AssertionError(f"views != contiguous: {dtype} d={d} Lq={lq} Lk={lk}")
            n += 1
    return n


def model_layout(*xs):
    """(B, H, L, D) views of (B, L, H, D) storage, as the models hand q, k
    and v to the kernels (``T5Attention._split``, the ViT ``split``)."""
    return tuple(x.transpose(1, 2).contiguous().transpose(1, 2) for x in xs)


def serving_shapes():
    """(q, k, v, bias, mask, causal, scale) at B=32, H=12, D=64, bf16, q, k, v
    in the models' layout: the ViT self-attention (L=197) and the T5 encoder
    self-attention (L=327)."""
    q, k, v, _, _ = _attn_inputs(BATCH, 12, 197, 197, 64, torch.bfloat16, seed=2)
    vit = (*model_layout(q, k, v), None, None, False, 64**-0.5)
    q, k, v, _, mask = _attn_inputs(BATCH, 12, 327, 327, 64, torch.bfloat16, seed=3)
    q, k, v = model_layout(q, k, v)
    mask[-1] = 1
    g = torch.Generator(device=DEVICE).manual_seed(4)
    # rows 16 bytes apart, as the T5 encoder's RelativeBias builds it
    bias, _ = layout.kernel_operand(torch.randn(1, 12, 327, 327, generator=g, device=DEVICE))
    enc = (q, k, v, bias, mask, False, None)
    return vit, enc


# -- phase 3b -----------------------------------------------------------------


def _sal_inputs(b, h, l, d, dtype, table_dtype, seed=0, all_sentinel=False):
    """q, k, v, bias1d, cell_bias, cell, key mask. The cells hold a question
    block and a tail of sentinels, cells 0 and 120, and one id past the
    sentinel; the mask a masked tail (row 1) and a fully masked row (last)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device=DEVICE)
    q, k, v = (rnd(b, h, l, d).to(dtype) for _ in range(3))
    bias1d = (rnd(h, l, l) * 0.5).to(table_dtype)
    cb = torch.zeros(h, 122, 122, device=DEVICE)
    cb[:, :121, :121] = rnd(h, 121, 121) * 0.3
    cell = torch.randint(0, 121, (b, l), generator=g, device=DEVICE, dtype=torch.int32)
    n_q = min(5, l // 3)
    cell[:, :n_q] = sfa.SENTINEL
    cell[:, l - max(1, l // 8):] = sfa.SENTINEL
    cell[0, n_q], cell[0, n_q + 1] = 0, 120
    if b > 1:
        cell[1, n_q] = 300  # read as the sentinel
    if all_sentinel:
        cell[:] = sfa.SENTINEL
    mask = torch.ones(b, l, dtype=torch.int32, device=DEVICE)
    if b > 1:
        mask[1, (3 * l) // 4:] = 0
    mask[-1] = 0
    return q, k, v, bias1d, cb.to(table_dtype), cell, mask


def _compare_sal(q, k, v, bias1d, cb, cell, mask) -> float:
    got = sfa.sal_fused_attention(q, k, v, bias1d, cb, cell, mask)
    torch.cuda.synchronize()
    want = sfa.sal_reference_attention(q.float(), k.float(), v.float(), bias1d, cb, cell, mask)
    tol = TOL[q.dtype]
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
    return float((got.float() - want).abs().max())


def check_sal_kernel_grid() -> dict:
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for dtype, length, d, table_dtype, use_mask, all_sentinel in itertools.product(
        worst, (8, 37, 131, 336, 512), (64, 32, 128), (torch.float32, torch.bfloat16),
        (True, False), (False, True),
    ):
        q, k, v, bias1d, cb, cell, mask = _sal_inputs(3, 3, length, d, dtype, table_dtype,
                                                      all_sentinel=all_sentinel)
        err = _compare_sal(q, k, v, bias1d, cb, cell, mask if use_mask else None)
        worst[dtype] = max(worst[dtype], err)
        n += 1
    worst[torch.bfloat16] = max(worst[torch.bfloat16], _compare_sal(*sal_serving_shape()))
    n += 1

    def sal_calls(q, k, v, seed):
        calls = []
        for table_dtype in (torch.float32, torch.bfloat16):
            _, _, _, bias1d, cb, cell, mask = _sal_inputs(*q.shape[:3], q.shape[3], q.dtype,
                                                          table_dtype, seed=seed)
            calls.append((sfa.sal_fused_attention, (q, k, v, bias1d, cb, cell, mask)))
        return calls

    n_views = check_views(sal_calls, [(37, 37), (131, 131), (336, 336)])
    log(f"phase 3b: SaL kernel == plain over {n} cases; max |err| f32 "
        f"{worst[torch.float32]:.3e} (tol {TOL[torch.float32]}), bf16 "
        f"{worst[torch.bfloat16]:.3e} (tol {TOL[torch.bfloat16]}); views == contiguous bit "
        f"for bit in {n_views} cases")
    return worst


def sal_serving_shape():
    """The SaL encoder self-attention at B=32, H=12, L=336, D=64, bf16 with
    bf16 tables, q, k, v in the models' layout: sentinel cells outside the
    OCR block, a key mask."""
    q, k, v, bias1d, cb, cell, mask = _sal_inputs(BATCH, 12, SAL_L, 64, torch.bfloat16,
                                                  torch.bfloat16, seed=5)
    q, k, v = model_layout(q, k, v)
    ocr = slice(SAL_FULL["max_q_length"], SAL_FULL["max_q_length"] + SAL_FULL["max_ocr_length"])
    g = torch.Generator(device=DEVICE).manual_seed(6)
    cell[:] = sfa.SENTINEL
    cell[:, ocr] = torch.randint(0, 121, cell[:, ocr].shape, generator=g, device=DEVICE,
                                 dtype=torch.int32)
    mask[-1] = 1
    return q, k, v, bias1d, cb, cell, mask


# -- phases 4 and 4b ----------------------------------------------------------


def latr_fixture(root):
    return synthetic.make_latr_fixture(root, n_images=8, n_rows=12,
                                       image_hw=FULL["vit_image_size"])


def latr_engine(model, tokenizer, paths):
    return ServingEngine(
        model, tokenizer, textlayout_ocr_adapt(paths["ocr"]), paths["img"],
        batch_size=BATCH, max_answer_length=MAX_ANSWER, max_ocr_element=OCR_ELEMENTS,
        max_ocr_length=OCR_LEN, max_q_length=Q_LEN,
    )


def sal_fixture(root):
    return synthetic.make_sal_fixture(root, n_images=8, n_rows=12, n_ocr_words=SAL_OCR_ELEMENTS,
                                      region_hidden=SAL_FULL["obj_hidden"])


def sal_engine(model, tokenizer, paths):
    # the SaL executor adapts both feature stores with scale 1 (boxes in [0, 1])
    sal = SaLInputs(
        textlayout_obj_adapt(paths["obj_features"], 1, 1), paths["ocr_features"],
        paths["obj_features"], ocr_hidden=SAL_FULL["ocr_hidden"],
        obj_hidden=SAL_FULL["obj_hidden"], max_obj_element=SAL_OBJ_ELEMENTS,
        max_obj_length=SAL_OBJ_LEN,
    )
    return ServingEngine(
        model, tokenizer, textlayout_ocr_adapt(paths["ocr_features"], 1, 1), None,
        batch_size=BATCH, max_answer_length=MAX_ANSWER, max_ocr_element=SAL_OCR_ELEMENTS,
        max_ocr_length=SAL_FULL["max_ocr_length"], max_q_length=SAL_FULL["max_q_length"],
        sal=sal,
    )


def requests():
    return [(float(i % 8), synthetic.QUESTIONS[i % len(synthetic.QUESTIONS)])
            for i in range(N_REQUESTS)]


def first_batch(engine, reqs):
    """The first serving batch of ``reqs``, featurized and on the card."""
    dataset = featurize_requests(engine.tokenizer, engine.ocr_store, engine.base_img_path,
                                 reqs[:BATCH], **engine.featurize_args)
    batch, _ = next(batch_iterator(dataset, BATCH))
    return latr_mod.to_device_batch(batch, DEVICE, engine.batch_keys)


def serve(phase, title, engine, reqs, per_batch: dict) -> dict:
    """``engine`` answers ``reqs``; ``per_batch`` is each kernel's launches
    per batch."""
    model = engine.model
    engine.answer(reqs[:BATCH])  # warm-up: cuBLAS handles, allocator pools
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    answers = engine.answer(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launches()

    n_batches = -(-len(reqs) // BATCH)
    if len(answers) != len(reqs) or not all(isinstance(a, str) for a in answers):
        raise AssertionError(f"{phase}: {len(answers)} answers for {len(reqs)} requests")
    check_launches(phase, got, {k: n * n_batches for k, n in per_batch.items()})
    ms_per_batch = 1e3 * wall / n_batches

    # split one batch's time: featurize on the host, encode (fuse, encoders,
    # cache), decode loop
    t0 = time.perf_counter()
    tb = first_batch(engine, reqs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.inference_mode():
        model.encode_for_generate(tb, MAX_ANSWER)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = engine.generate(tb)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    eos = model.cfg.t5.eos_token_id
    steps = max(row.index(eos) if eos in row else MAX_ANSWER - 1 for row in out.tolist())
    split = {
        "featurize_ms": 1e3 * (t1 - t0), "encode_ms": 1e3 * (t2 - t1),
        "generate_ms": 1e3 * (t3 - t2), "decode_ms": 1e3 * ((t3 - t2) - (t2 - t1)),
        "decode_steps_max": steps,
    }
    split.update(profile_generate(engine.generate, tb, split["generate_ms"]))
    log(f"{phase}: {len(answers)} answers in {n_batches} batches of {BATCH} (bf16, full-width "
        f"{title}): {ms_per_batch:.3f} ms/batch, {len(answers) / wall:.3f} answers/s; kernel "
        f"launches {got} = {per_batch} x {n_batches}; device kernel launches per batch "
        f"(profiler, one generate) {split['device_kernel_launches']}; one batch split "
        f"{json.dumps(split)}; "
        f"sample answers {answers[:3]}")
    return {"launches": got, "ms_per_batch": ms_per_batch,
            "answers_per_s": len(answers) / wall, "n_answers": len(answers), **split}


def profile_generate(generate, tb, wall_ms: float) -> dict:
    """One batch's generate (encode + decode loop) under torch.profiler:
    device busy time (sum of CUDA kernel times), kernel launches, the busy
    share of ``wall_ms`` (the same call's host-clock time without the
    profiler, whose own overhead stretches the traced wall), and the five
    kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(tb)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    ours = [e for e in kernels if "attn::attention_" in e.key]  # both ported kernels
    return {
        "profiled_wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / (1e3 * wall_ms),
        "device_kernel_launches": sum(e.count for e in kernels),
        "attention_kernels_ms": sum(e.self_device_time_total for e in ours) / 1e3,
        "attention_kernel_launches": sum(e.count for e in ours),
        "top_kernels_ms": {e.key[:90]: e.self_device_time_total / 1e3 for e in top},
    }


# -- phases 5 and 5b ----------------------------------------------------------


def plain_attention(q, k, v, bias=None, key_mask=None, causal=False, scale=None):
    """``dot_product_attention`` with every kernel replaced by its plain
    version: a ``FusedSalBias`` is materialized."""
    if isinstance(bias, sfa.FusedSalBias):
        bias = bias.materialize()
    return attn_mod.reference_attention(q, k, v, bias, key_mask, causal, scale)


def _greedy_with_logits(model, tb):
    cache, full_bias, enc_mask = model.encode_for_generate(tb, MAX_ANSWER)
    seen = []

    def step(tokens, cache, i):
        logits, cache = model.decode_step(tokens, cache, i, full_bias, enc_mask)
        seen.append(logits)
        return logits, cache

    out = greedy_decode(step, cache, enc_mask.shape[0], MAX_ANSWER, 0, 1, 0, DEVICE)
    return out, seen


def check_end_to_end_f32(phase, model, tb, want_launches: dict) -> dict:
    """Teacher-forced logits and greedy tokens through the kernels against
    the same model with ``plain_attention``."""
    g = np.random.RandomState(SEED)
    labels = torch.from_numpy(g.randint(3, T5_BASE["t5_vocab_size"], (BATCH, MAX_ANSWER)))
    labels = labels.to(DEVICE)
    label_mask = torch.ones_like(labels, dtype=torch.int32)
    label_mask[: BATCH // 2, MAX_ANSWER // 2 :] = 0

    def run():
        with torch.inference_mode():
            logits = model(tb, labels, label_mask)
            out, seen = _greedy_with_logits(model, tb)
        torch.cuda.synchronize()
        return logits, out, seen

    reset_launches()
    k_logits, k_out, _ = run()
    check_launches(phase, launches(), want_launches)
    saved = (t5_mod.dot_product_attention, vit_mod.dot_product_attention)
    t5_mod.dot_product_attention = vit_mod.dot_product_attention = plain_attention
    try:
        reset_launches()
        p_logits, p_out, p_seen = run()
        check_launches(phase, launches(), {name: 0 for name in KERNELS})
    finally:
        t5_mod.dot_product_attention, vit_mod.dot_product_attention = saved
    if not torch.isfinite(k_logits).all():
        raise AssertionError(f"{phase}: non-finite logits")
    logits_err = float((k_logits - p_logits).abs().max())
    torch.testing.assert_close(k_logits, p_logits, atol=LOGITS_TOL, rtol=LOGITS_TOL)

    # tokens identical; a row may part only where the plain path's top-2
    # logits at that step lie within TIE_MARGIN
    k_rows, p_rows = k_out.tolist(), p_out.tolist()
    parted, worst_margin = 0, 0.0
    for r, (kr, pr) in enumerate(zip(k_rows, p_rows)):
        for i, (a, b) in enumerate(zip(kr, pr)):
            if a != b:
                top2 = torch.topk(p_seen[i - 1][r], 2).values
                margin = float(top2[0] - top2[1])
                if margin > TIE_MARGIN:
                    raise AssertionError(
                        f"{phase}: row {r} step {i} token {a} != {b}, plain top-2 margin {margin}")
                parted += 1
                worst_margin = max(worst_margin, margin)
                break
    log(f"{phase}: f32 teacher-forced logits kernels vs plain max |err| {logits_err:.3e} "
        f"(tol {LOGITS_TOL}); greedy rows identical {BATCH - parted}/{BATCH}, parted rows "
        f"{parted} (largest plain top-2 margin at a parting {worst_margin:.3e}, allowed "
        f"{TIE_MARGIN}); tokens[0] {k_rows[0]}")
    return {"logits_max_abs_err": logits_err, "greedy_rows_parted": parted}


def run_family(phase, title, build, fixture, make_engine, tokenizer, per_batch, e2e_launches,
               root):
    """Serve at bf16 (phase ``phase``), then check f32 end to end (the next
    phase) on the first serving batch."""
    reqs = requests()
    paths = fixture(root)
    engine = make_engine(build(dtype="bfloat16"), tokenizer, paths)
    served = serve(f"phase {phase}", title, engine, reqs, per_batch)
    del engine
    torch.cuda.empty_cache()
    model = build(dtype="float32")
    engine = make_engine(model, tokenizer, paths)
    e2e = check_end_to_end_f32(f"phase {phase.replace('4', '5')}", model,
                               first_batch(engine, reqs), e2e_launches)
    del model, engine
    torch.cuda.empty_cache()
    return served, e2e


# -- phases 6 and 6b ----------------------------------------------------------


def _time(key: str, fn, iters=20, repeats=5) -> dict:
    """ms per launch of ``fn`` by CUDA events: the median of ``repeats`` runs
    of ``iters`` warmed launches under ``key``, their min and max beside it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    runs.sort()
    return {key: runs[len(runs) // 2], f"{key}_min_max": [runs[0], runs[-1]]}


def _split_time(prefix: str, fn, iters=20, host_iters=200) -> dict:
    """Where ``_time``'s ms per call goes: ``<prefix>device_ms``, the CUDA
    kernel time per call that torch.profiler records over ``iters`` warmed
    calls, and ``<prefix>host_ms``, the host-clock time per call to issue
    ``host_iters`` of them (no synchronize inside). Back-to-back event times
    near the host time are set by the host, not the kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(host_iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {f"{prefix}device_ms": sum(e.self_device_time_total for e in kernels) / iters / 1e3,
            f"{prefix}host_ms": 1e3 * host_s / host_iters}


def _bound(moved_bytes, flops):
    t_bytes, t_ops = moved_bytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _qkvo_bytes_flops(q, k):
    b, h, lq, d = q.shape
    lk = k.shape[2]
    return q.element_size() * (2 * b * h * lq * d + 2 * b * h * lk * d), 4 * b * h * lq * lk * d


def _sdpa(q, k, v, bias, mask, scale):
    """The library yardstick: SDPA on the same inputs, with the key mask
    folded into the additive mask beforehand (timed here, used nowhere in the
    port)."""
    add = torch.zeros(1, 1, 1, k.shape[2], device=DEVICE)
    if bias is not None:
        add = add + bias
    if mask is not None:
        add = add + torch.where(mask.bool(), 0.0, -1e9)[:, None, None, :]
    sdpa_mask = None if bias is None and mask is None else add.to(q.dtype)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=sdpa_mask, scale=1.0 if scale is None else scale)


def time_kernel() -> list:
    rows = []
    for name, (q, k, v, bias, mask, causal, scale) in zip(("vit", "t5_encoder"), serving_shapes()):
        kernel = lambda: fa.fused_attention(q, k, v, bias, mask, causal, scale)
        plain = lambda: attn_mod.reference_attention(q, k, v, bias, mask, causal, scale)
        moved, flops = _qkvo_bytes_flops(q, k)
        moved += sum(0 if t is None else t.numel() * 4 for t in (bias, mask))
        bound_ms, bound_by = _bound(moved, flops)
        library = _sdpa(q, k, v, bias, mask, scale)
        row = {"shape": name, "q": list(q.shape), "dtype": str(q.dtype).replace("torch.", ""),
               **_time("ms", kernel), **_time("plain_ms", plain), **_time("library_ms", library),
               **_split_time("", kernel), **_split_time("library_", library),
               "bound_ms": bound_ms, "bound_by": bound_by}
        rows.append(row)
        log(f"phase 6: {json.dumps(row)}")
    return rows


def time_sal_kernel() -> dict:
    q, k, v, bias1d, cb, cell, mask = sal_serving_shape()
    kernel = lambda: sfa.sal_fused_attention(q, k, v, bias1d, cb, cell, mask)
    # the plain version materializes the (B, H, L, L) f32 bias on every call
    plain = lambda: sfa.sal_reference_attention(q, k, v, bias1d, cb, cell, mask)
    # SDPA on the bias materialized once beforehand: the materialization is
    # not in the library time
    library = _sdpa(q, k, v, sfa.materialize_sal_bias(bias1d, cb, cell), mask, None)
    moved, flops = _qkvo_bytes_flops(q, k)
    moved += sum(t.numel() * t.element_size() for t in (bias1d, cb, cell, mask))
    bound_ms, bound_by = _bound(moved, flops)
    row = {"shape": "sal_encoder", "q": list(q.shape), "dtype": "bfloat16",
           "tables": str(bias1d.dtype).replace("torch.", ""), **_time("ms", kernel),
           **_time("plain_ms", plain), **_time("library_ms", library),
           **_split_time("", kernel), **_split_time("library_", library),
           "library_excludes": "bias materialization", "bound_ms": bound_ms,
           "bound_by": bound_by}
    log(f"phase 6b: {json.dumps(row)}")
    return row


def time_ablations() -> dict:
    """Event and device ms per call of the kernels at the serving shapes
    with part of their work taken away, each beside the full call in
    phases 6 / 6b: what the logit policy, the mask and the models' layout
    cost. Kernel name -> rows."""
    _, (q, k, v, bias, mask, _, _) = serving_shapes()
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    sq, sk, sv, bias1d, cb, cell, smask = sal_serving_shape()
    cases = [
        ("flash_attention", "t5_encoder_no_bias", fa.fused_attention, (q, k, v, None, mask)),
        ("flash_attention", "t5_encoder_no_bias_no_mask", fa.fused_attention, (q, k, v)),
        ("flash_attention", "t5_encoder_contiguous_qkv", fa.fused_attention,
         (qc, kc, vc, bias, mask)),
        ("sal_fused_attention", "sal_encoder_f32_tables", sfa.sal_fused_attention,
         (sq, sk, sv, bias1d.float(), cb.float(), cell, smask)),
        # the same q, k, v and mask through the attention kernel: the core
        # without the SaL policy
        ("sal_fused_attention", "sal_encoder_no_policy", fa.fused_attention,
         (sq, sk, sv, None, smask)),
    ]
    rows = {}
    for kernel_name, case, kernel, args in cases:
        call = lambda: kernel(*args)
        row = {"case": case, **_time("ms", call), **_split_time("", call)}
        rows.setdefault(kernel_name, []).append(row)
        log(f"phase 6c: {json.dumps(row)}")
    return rows


def bf16_spills(logs: dict) -> list:
    """[kernel, entry, report] for every bf16 entry (attention_tma_kernel)
    whose -Xptxas -v report shows spill stores or loads."""
    found, entry = [], ""
    for name, out in logs.items():
        for line in out.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill stores" in line and "attention_tma_kernel" in entry:
                if any(int(n) for n in re.findall(r"(\d+) bytes spill", line)):
                    found.append([name, entry, line.strip()])
    return found


def main() -> None:
    card = card_line()
    log(f"phase 1: card {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build(*KERNELS)
    log(f"phase 2: built {', '.join(m.SOURCE for m in KERNELS.values())} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc in parallel)")
    for name, out in _build.BUILD_LOGS.items():
        log(f"phase 2: {name} -Xptxas -v\n{out.strip()}")
    spills = bf16_spills(_build.BUILD_LOGS)
    if spills:
        raise AssertionError(f"phase 2: bf16 (TMA + wgmma) kernels spill: {spills}")
    log("phase 2: no bf16 (TMA + wgmma) kernel spills")

    worst = check_kernel_grid()
    sal_worst = check_sal_kernel_grid()
    tokenizer = FallbackSubwordTokenizer(T5_BASE["t5_vocab_size"])
    n_t5 = T5_BASE["num_encoder_layers"]
    n_dec = T5_BASE["num_t5_decoder_layers"]
    encode_launches = FULL["vit_num_layers"] + n_t5  # every ViT and T5 encoder layer
    with tempfile.TemporaryDirectory() as root:
        served, e2e = run_family(
            "4", "LaTr-base",
            lambda dtype: latr_mod.build_latr(dict(FULL, DTYPE=dtype), DEVICE, SEED),
            latr_fixture, latr_engine, tokenizer,
            {"flash_attention": encode_launches, "sal_fused_attention": 0},
            # teacher forcing at T=20 >= 16: ViT + encoder + decoder self + cross
            # layers; then generate's encode: ViT + encoder again
            {"flash_attention": 2 * encode_launches + 2 * n_dec, "sal_fused_attention": 0},
            os.path.join(root, "latr"),
        )
        sal_served, sal_e2e = run_family(
            "4b", "SaL-base",
            lambda dtype: sal_mod.build_sal(dict(SAL_FULL, DTYPE=dtype), DEVICE, SEED),
            sal_fixture, sal_engine, tokenizer,
            {"flash_attention": 0, "sal_fused_attention": n_t5},
            # teacher forcing: the encoder through the SaL kernel, decoder self
            # and cross layers through the attention kernel; then generate's
            # encode through the SaL kernel again
            {"flash_attention": 2 * n_dec, "sal_fused_attention": 2 * n_t5},
            os.path.join(root, "sal"),
        )
    shapes = time_kernel()
    sal_shape = time_sal_kernel()
    ablations = time_ablations()

    per_batch = lambda key: 12 * shapes[0][key] + 12 * shapes[1][key]
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "phoneme_vqa_torch/csrc/flash_attention.cu",
        "replaces": "phoneme_vqa_tpu/ops/flash_attention.py:71",
        "design": DESIGN,
        "launches": served["launches"]["flash_attention"],
        "max_abs_err": max(worst.values()),
        "max_err_f32": worst[torch.float32],
        "max_err_bf16": worst[torch.bfloat16],
        # per LaTr serving batch: 12 launches at each of the two shapes
        "ms": per_batch("ms"),
        "plain_ms": per_batch("plain_ms"),
        "bound_ms": per_batch("bound_ms"),
        "bound_by": "bytes" if all(s["bound_by"] == "bytes" for s in shapes) else "operations",
        "library_ms": per_batch("library_ms"),
        "shapes": shapes,
        "ablations": ablations["flash_attention"],
    }, {
        "name": "sal_fused_attention",
        "route": "cuda",
        "source": "phoneme_vqa_torch/csrc/sal_fused_attention.cu",
        "replaces": "phoneme_vqa_tpu/ops/sal_fused_attention.py:133",
        "design": DESIGN,
        "launches": sal_served["launches"]["sal_fused_attention"],
        "max_abs_err": max(sal_worst.values()),
        "max_err_f32": sal_worst[torch.float32],
        "max_err_bf16": sal_worst[torch.bfloat16],
        # per SaL serving batch: 12 launches at the encoder shape
        "ms": n_t5 * sal_shape["ms"],
        "plain_ms": n_t5 * sal_shape["plain_ms"],
        "bound_ms": n_t5 * sal_shape["bound_ms"],
        "bound_by": sal_shape["bound_by"],
        "library_ms": n_t5 * sal_shape["library_ms"],
        "shapes": [sal_shape],
        "ablations": ablations["sal_fused_attention"],
    }]
    log(json.dumps({"serving": {"latr": served, "sal": sal_served},
                    "end_to_end_f32": {"latr": e2e, "sal": sal_e2e}, "card": card}))
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
