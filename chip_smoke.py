"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried past):
1. the card's name and power limit; TF32 off for f32 matmuls and convolutions
2. build the CUDA attention kernel from csrc/ with nvcc (prints -Xptxas -v)
3. the kernel against its plain PyTorch version over dtypes, options and lengths,
   and at the two shapes the serving path gives it
4. full-width LaTr-base (seeded random weights) answers synthetic requests
   through ServingEngine at batch 32 in bf16; the kernel must launch 24 times
   per batch (12 ViT + 12 T5 encoder layers)
5. in f32 on one batch: teacher-forced logits and greedy tokens through the
   kernel against the same model with plain attention
6. kernel, plain and library (SDPA) times at the serving shapes, CUDA events

Prints a {"kernels": [...]} line, the card line, and last
{"ok": true, "device": {...}}. Needs the repo's phoneme_vqa_torch package;
imports no JAX.
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA card is available")

from phoneme_vqa_torch.data import synthetic  # noqa: E402
from phoneme_vqa_torch.data.adapters import textlayout_ocr_adapt  # noqa: E402
from phoneme_vqa_torch.data.latr import LaTrDataset  # noqa: E402
from phoneme_vqa_torch.data.loader import batch_iterator  # noqa: E402
from phoneme_vqa_torch.decode.greedy import greedy_decode  # noqa: E402
from phoneme_vqa_torch.models import latr as latr_mod  # noqa: E402
from phoneme_vqa_torch.models import t5 as t5_mod  # noqa: E402
from phoneme_vqa_torch.models import vit as vit_mod  # noqa: E402
from phoneme_vqa_torch.ops import attention as attn_mod  # noqa: E402
from phoneme_vqa_torch.ops import flash_attention as fa  # noqa: E402
from phoneme_vqa_torch.serving import ServingEngine  # noqa: E402
from phoneme_vqa_torch.tokenizers.backbone import FallbackSubwordTokenizer  # noqa: E402

DEVICE = torch.device("cuda")
BATCH = 32
N_REQUESTS = 64
MAX_ANSWER = 20
SEED = 0
# LaTr-base at full width: vit5-base (T5 768/12 heads/d_kv 64/d_ff 3072/12+12
# layers/vocab 36096) + ViT-base 224/16; OCR 100, question 30 -> encoder 327
FULL = {
    "t5_vocab_size": 36096, "d_model": 768, "d_kv": 64, "num_heads": 12, "d_ff": 3072,
    "num_encoder_layers": 12, "num_t5_decoder_layers": 12,
    "vit_image_size": 224, "vit_patch_size": 16, "vit_hidden_size": 768,
    "vit_num_layers": 12, "vit_num_heads": 12, "vit_mlp_dim": 3072,
    "max_2d_position_embeddings": 1024,
}
OCR_ELEMENTS, OCR_LEN, Q_LEN = 50, 100, 30
# kernel launches per encode: every ViT and T5 encoder layer (Lq >= 16)
ENCODE_LAUNCHES = FULL["vit_num_layers"] + FULL["num_encoder_layers"]
# f32: the kernel sums q·k and P·v in another order than cuBLAS; rounding is
# ~1e-6 relative and the softmax's exp scales it by the logit size. bf16: the
# kernel's output is rounded to bf16 (2^-8 relative); the plain result is f32
# on the same bf16 inputs.
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# end to end in f32 the per-layer differences above pass through 24 layers and
# the LM head; logits are O(1)
LOGITS_TOL = 2e-3
TIE_MARGIN = 1e-4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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
    for dtype, length, d in itertools.product(worst, (16, 197, 327, 131, 512), (64, 32)):
        q, k, v, bias_full, mask = _attn_inputs(2, 3, length, length, d, dtype)
        for bias_kind, use_mask, causal, scale in itertools.product(
            ("none", "one", "batch"), (False, True), (False, True), (None, d**-0.5)
        ):
            bias = {"none": None, "one": bias_full[:1].contiguous(), "batch": bias_full}[bias_kind]
            err = _compare(q, k, v, bias, mask if use_mask else None, causal, scale)
            worst[dtype] = max(worst[dtype], err)
            n += 1
    # decoder cross-attention lengths (teacher forced): Lq 20 over Lk 327
    for dtype in worst:
        q, k, v, _, mask = _attn_inputs(2, 4, 20, 327, 64, dtype, seed=1)
        worst[dtype] = max(worst[dtype], _compare(q, k, v, None, mask, False, None))
        n += 1
    # the two serving-path shapes, in the serving dtype
    for args in serving_shapes():
        worst[torch.bfloat16] = max(worst[torch.bfloat16], _compare(*args))
        n += 1
    log(f"phase 3: kernel == plain over {n} cases; max |err| f32 {worst[torch.float32]:.3e} "
        f"(tol {TOL[torch.float32]}), bf16 {worst[torch.bfloat16]:.3e} "
        f"(tol {TOL[torch.bfloat16]})")
    return worst


def serving_shapes():
    """(q, k, v, bias, mask, causal, scale) at B=32, H=12, D=64, bf16:
    the ViT self-attention (L=197) and the T5 encoder self-attention (L=327)."""
    q, k, v, _, _ = _attn_inputs(BATCH, 12, 197, 197, 64, torch.bfloat16, seed=2)
    vit = (q, k, v, None, None, False, 64**-0.5)
    q, k, v, _, mask = _attn_inputs(BATCH, 12, 327, 327, 64, torch.bfloat16, seed=3)
    mask[-1] = 1
    g = torch.Generator(device=DEVICE).manual_seed(4)
    bias = torch.randn(1, 12, 327, 327, generator=g, device=DEVICE)
    enc = (q, k, v, bias, mask, False, None)
    return vit, enc


# -- phase 4 ------------------------------------------------------------------


def make_requests(root):
    paths = synthetic.make_latr_fixture(root, n_images=8, n_rows=12,
                                        image_hw=FULL["vit_image_size"])
    reqs = [
        (float(i % 8), synthetic.QUESTIONS[i % len(synthetic.QUESTIONS)])
        for i in range(N_REQUESTS)
    ]
    return paths, reqs


def serve(paths, reqs, tokenizer) -> dict:
    model = latr_mod.build_latr(dict(FULL, DTYPE="bfloat16"), device=DEVICE, seed=SEED)
    engine = ServingEngine(
        model, tokenizer, textlayout_ocr_adapt(paths["ocr"]), paths["img"],
        batch_size=BATCH, max_answer_length=MAX_ANSWER, max_ocr_element=OCR_ELEMENTS,
        max_ocr_length=OCR_LEN, max_q_length=Q_LEN,
    )
    engine.answer(reqs[:BATCH])  # warm-up: cuBLAS handles, allocator pools
    torch.cuda.synchronize()

    fa.LAUNCHES = 0
    t0 = time.perf_counter()
    answers = engine.answer(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.LAUNCHES

    n_batches = -(-len(reqs) // BATCH)
    if len(answers) != len(reqs) or not all(isinstance(a, str) for a in answers):
        raise AssertionError(f"phase 4: {len(answers)} answers for {len(reqs)} requests")
    if launches != ENCODE_LAUNCHES * n_batches:
        raise AssertionError(
            f"phase 4: {launches} kernel launches, want {ENCODE_LAUNCHES} x {n_batches}")
    ms_per_batch = 1e3 * wall / n_batches

    # split one batch's time: featurize on the host, encode (ViT + fuse + T5
    # encoder + cache), decode loop
    t0 = time.perf_counter()
    dataset = LaTrDataset(
        [{"image_id": i, "question": q, "answer": ""} for i, q in reqs[:BATCH]],
        engine.ocr_store, tokenizer, paths["img"], OCR_ELEMENTS, OCR_LEN, Q_LEN, MAX_ANSWER,
    ).dataset
    batch, _ = next(batch_iterator(dataset, BATCH))
    tb = latr_mod.to_device_batch(batch, DEVICE)
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
    log(f"phase 4: {len(answers)} answers in {n_batches} batches of {BATCH} (bf16, full-width "
        f"LaTr-base): {ms_per_batch:.3f} ms/batch, {len(answers) / wall:.3f} answers/s; "
        f"kernel launches {launches} = {ENCODE_LAUNCHES} x {n_batches}; one batch split "
        f"{json.dumps(split)}; sample answers {answers[:3]}")
    del model, engine
    torch.cuda.empty_cache()
    return {"launches": launches, "ms_per_batch": ms_per_batch,
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
    return {
        "profiled_wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / (1e3 * wall_ms),
        "device_kernel_launches": sum(e.count for e in kernels),
        "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
    }


# -- phase 5 ------------------------------------------------------------------


def _greedy_with_logits(model, tb):
    cache, full_bias, enc_mask = model.encode_for_generate(tb, MAX_ANSWER)
    seen = []

    def step(tokens, cache, i):
        logits, cache = model.decode_step(tokens, cache, i, full_bias, enc_mask)
        seen.append(logits)
        return logits, cache

    out = greedy_decode(step, cache, enc_mask.shape[0], MAX_ANSWER, 0, 1, 0, DEVICE)
    return out, seen


def check_end_to_end_f32(paths, reqs, tokenizer) -> dict:
    model = latr_mod.build_latr(dict(FULL, DTYPE="float32"), device=DEVICE, seed=SEED)
    dataset = LaTrDataset(
        [{"image_id": i, "question": q, "answer": ""} for i, q in reqs[:BATCH]],
        textlayout_ocr_adapt(paths["ocr"]), tokenizer, paths["img"],
        OCR_ELEMENTS, OCR_LEN, Q_LEN, MAX_ANSWER,
    ).dataset
    batch, _ = next(batch_iterator(dataset, BATCH))
    tb = latr_mod.to_device_batch(batch, DEVICE)
    g = np.random.RandomState(SEED)
    labels = torch.from_numpy(g.randint(3, FULL["t5_vocab_size"], (BATCH, MAX_ANSWER))).to(DEVICE)
    label_mask = torch.ones_like(labels, dtype=torch.int32)
    label_mask[: BATCH // 2, MAX_ANSWER // 2 :] = 0

    def run():
        with torch.inference_mode():
            logits = model(tb, labels, label_mask)
            out, seen = _greedy_with_logits(model, tb)
        torch.cuda.synchronize()
        return logits, out, seen

    fa.LAUNCHES = 0
    k_logits, k_out, _ = run()
    kernel_launches = fa.LAUNCHES
    # teacher forcing at T=20 >= 16: ViT + encoder + decoder self + cross
    # layers; then generate's encode: ViT + encoder again
    want = 2 * ENCODE_LAUNCHES + 2 * FULL["num_t5_decoder_layers"]
    if kernel_launches != want:
        raise AssertionError(f"phase 5: {kernel_launches} kernel launches, want {want}")
    saved = (t5_mod.dot_product_attention, vit_mod.dot_product_attention)
    # the same model with every attention in the plain version (same signature)
    t5_mod.dot_product_attention = vit_mod.dot_product_attention = attn_mod.reference_attention
    try:
        p_logits, p_out, p_seen = run()
    finally:
        t5_mod.dot_product_attention, vit_mod.dot_product_attention = saved
    if not torch.isfinite(k_logits).all():
        raise AssertionError("phase 5: non-finite logits")
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
                        f"phase 5: row {r} step {i} token {a} != {b}, plain top-2 margin {margin}")
                parted += 1
                worst_margin = max(worst_margin, margin)
                break
    log(f"phase 5: f32 teacher-forced logits kernel vs plain max |err| {logits_err:.3e} "
        f"(tol {LOGITS_TOL}); greedy rows identical {BATCH - parted}/{BATCH}, parted rows "
        f"{parted} (largest plain top-2 margin at a parting {worst_margin:.3e}, allowed "
        f"{TIE_MARGIN}); tokens[0] {k_rows[0]}")
    del model
    torch.cuda.empty_cache()
    return {"logits_max_abs_err": logits_err, "greedy_rows_parted": parted}


# -- phase 6 ------------------------------------------------------------------


def _time(fn, iters=20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(q, k, bias, mask):
    b, h, lq, d = q.shape
    lk = k.shape[2]
    elt = q.element_size()
    moved = elt * (2 * b * h * lq * d + 2 * b * h * lk * d)  # q, out, k, v
    moved += 0 if bias is None else bias.numel() * 4
    moved += 0 if mask is None else mask.numel() * 4
    flops = 4 * b * h * lq * lk * d
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_kernel() -> list:
    rows = []
    for name, (q, k, v, bias, mask, causal, scale) in zip(("vit", "t5_encoder"), serving_shapes()):
        kernel = lambda: fa.fused_attention(q, k, v, bias, mask, causal, scale)
        plain = lambda: attn_mod.reference_attention(q, k, v, bias, mask, causal, scale)
        # the library yardstick: SDPA on the same inputs, the key mask folded
        # into the additive mask beforehand (timed here, used nowhere in the port)
        add = torch.zeros(1, 1, 1, k.shape[2], device=DEVICE)
        if bias is not None:
            add = add + bias
        if mask is not None:
            add = add + torch.where(mask.bool(), 0.0, -1e9)[:, None, None, :]
        sdpa_mask = None if bias is None and mask is None else add.to(q.dtype)
        library = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=sdpa_mask, scale=1.0 if scale is None else scale)
        bound_ms, bound_by = _bound(q, k, bias, mask)
        row = {"shape": name, "q": list(q.shape), "dtype": str(q.dtype).replace("torch.", ""),
               "ms": _time(kernel), "plain_ms": _time(plain), "library_ms": _time(library),
               "bound_ms": bound_ms, "bound_by": bound_by}
        rows.append(row)
        log(f"phase 6: {json.dumps(row)}")
    return rows


def main() -> None:
    card = card_line()
    log(f"phase 1: card {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    fa.build()
    log(f"phase 2: built {fa.SOURCE} in {time.perf_counter() - t0:.1f} s\n{fa.BUILD_LOG.strip()}")

    worst = check_kernel_grid()
    tokenizer = FallbackSubwordTokenizer(FULL["t5_vocab_size"])
    with tempfile.TemporaryDirectory() as root:
        paths, reqs = make_requests(root)
        served = serve(paths, reqs, tokenizer)
        e2e = check_end_to_end_f32(paths, reqs, tokenizer)
    shapes = time_kernel()

    per_batch = lambda key: 12 * shapes[0][key] + 12 * shapes[1][key]
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "phoneme_vqa_torch/csrc/flash_attention.cu",
        "replaces": "phoneme_vqa_tpu/ops/flash_attention.py:71",
        "launches": served["launches"],
        "max_abs_err": max(worst.values()),
        "max_err_f32": worst[torch.float32],
        "max_err_bf16": worst[torch.bfloat16],
        # per serving batch: 12 launches at each of the two shapes
        "ms": per_batch("ms"),
        "kernel_ms": per_batch("ms"),
        "plain_ms": per_batch("plain_ms"),
        "bound_ms": per_batch("bound_ms"),
        "bound_by": "bytes" if all(s["bound_by"] == "bytes" for s in shapes) else "operations",
        "library_ms": per_batch("library_ms"),
        "shapes": shapes,
    }]
    log(json.dumps({"serving": served, "end_to_end_f32": e2e, "card": card}))
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
