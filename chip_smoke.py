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
3c. gradients through the kernels' autograd.Functions (kernel forward,
    plain recompute backward) against the plain path's: over the phase-3
    option grid, at the four attention roles of a LaTr-base train step (ViT,
    T5 encoder, decoder self-attention 127 x 127 causal + bias + mask,
    cross-attention 127 x 327 + mask; B=16) and the three attention-kernel
    roles of a PhonemeSaL-base train step (custom decoder self-attention
    39 x 39 causal + scale + mask, cross-attention 39 x 336 + scale + mask,
    the SaL encoder with SAL_FUSED off: the materialized (16, 12, 336, 336)
    f32 bias + mask), and the three that the PhonemeLaTr / PreSTU family
    adds (the triple decoder's self-attention 127 x 127 causal + scale +
    mask, its cross-attention 127 x 327 + scale + mask, the ViT under
    gradients 197 x 197 + scale) in bf16 and f32, and the SaL Function at the SaL
    serving shape and at its training shape (B=16) in both types; every
    input that requires grad gets a finite, nonzero gradient
4.  full-width LaTr-base (a serve-mode executor, seeded random weights)
    answers 64 synthetic requests through the gathered ServingEngine at batch
    32 in bf16, its decode replayed from the bucket's CUDA graphs; the
    attention kernel must launch 24 times per decoded batch (12 ViT + 12 T5
    encoder layers), the SaL one 0; one batch's time split on the eager path
4b. full-width SaL-base (seeded random weights) answers synthetic requests
    the same way; the SaL kernel must launch 12 times per batch (every
    encoder layer), the attention kernel 0
4c. full-width PhonemeSaL-base (configs/phonemesal.yaml: the SaL-base
    encoder, a 4-layer custom decoder over the 253-id flat phoneme
    vocabulary) answers synthetic requests at batch 32, 40 answer tokens,
    decoded by the phoneme tokenizer; 12 SaL-kernel launches per batch, 0
    attention-kernel launches (the decode steps have one query row)
4d. full-width PhonemeLaTr-base (configs/phonemelatr.yaml: the LaTr-base
    encoder, a 4-layer triple decoder over a structured vocabulary built from
    an annotation file that covers every onset, rhyme and tone of the
    phonology tables) answers synthetic requests at batch 32, 20 answer
    triples, recomposed by the structured tokenizer; 24 attention-kernel
    launches per batch, 0 SaL
4e. full-width PreSTU-base (configs/prestu.yaml: question and OCR fused
    into one stream, the stock T5 decoder) the same way; 24 launches a batch
5.  LaTr in f32 on one batch: teacher-forced logits and greedy tokens
    through the kernels against the same model with plain attention
5b. the same for SaL; its plain attention materializes the 2D bias
5c. the same for PhonemeSaL (answer vocabulary, 40 tokens)
5d. the same for PhonemeLaTr: all three heads' logits, greedy triples
5e. the same for PreSTU
6.  attention kernel, plain and library (SDPA) times at the LaTr serving
    shapes, CUDA events
6b. SaL kernel, plain and library times at the SaL serving shape; the
    SAL_FUSED choice per SaL-base batch: 12 SaL-kernel launches against one
    bias materialization + 12 attention-kernel launches on it (interleaved
    on, off, off, on), printed beside the port's default
6c. ablations: the kernels at the serving shapes with part of their work
    taken away (the T5 encoder without its bias, its mask or both, with
    contiguous q, k, v; the SaL shape with f32 tables, and through the
    attention kernel with its key mask only, i.e. without the SaL policy)
6d. attention kernel, plain and library times at the four roles of a
    LaTr-base train step (B=16), and the plain backward recompute of the
    three roles that carry gradients; the same at the three attention-kernel
    roles of a PhonemeSaL-base train step, at the three new roles of the
    PhonemeLaTr / PreSTU family and for the SaL kernel at its training
    shape (B=16)
7.  full-width LaTr-base (bf16 compute, f32 masters, dropout 0.1, the LaTr
    preset's adam at LR 5e-5, batch 16, decoder length 127) trains one epoch
    of 20 steps through LaTrExecutor on a synthetic fixture, evaluates,
    saves last/best, restores, and predicts into results.json; every loss
    finite, 48 attention-kernel launches per train step and 24 per eval or
    predict batch; one batch repeated for 10 steps lowers its loss; ms per
    step, samples/s, the forward / backward / optimizer split, the device
    busy share and kernel ms (profiler), peak memory
7b. one f32 train step at full width (batch 4): loss, every gradient and the
    parameters after the step through the kernels against the same model
    with plain attention, each attention output of the step's forward within
    1e-6 of the plain path's (relative, in norm)
8.  full-width PhonemeSaL-base (bf16 compute, f32 masters, dropout 0.1, the
    preset's adam at LR 5e-5 with its LinearLR warmup, batch 16, answers of
    40 phoneme ids) trains one epoch of 20 steps through PhonemeSaLExecutor
    on a synthetic SaL fixture with Vietnamese answers, evaluates, saves
    last/best, restores, and predicts; 12 SaL-kernel + 8 attention-kernel
    launches per train step, 12 SaL per eval or predict batch; a repeated
    batch's loss falls; ms per step, the split, busy share, peak memory;
    then 5 steps with SAL_FUSED off (0 SaL + 20 attention launches a step)
8b. one f32 PhonemeSaL train step (batch 4) kernels vs plain, as 7b
8c. 6 train steps of the stock SaLExecutor (configs/sal.yaml widths, batch
    16, answers of 40): 12 SaL + 24 attention launches a step
9.  full-width PhonemeLaTr-base (configs/phonemelatr.yaml: bf16 compute, f32
    masters, dropout 0.1, adam at LR 5e-5 with the LinearLR warmup, batch
    16, answers of 128 triples) trains one epoch of 20 steps through
    PhonemeLaTrExecutor on phase 7's fixture, evaluates, saves last/best,
    restores, and predicts; 32 attention-kernel launches per train step
    (12 ViT without gradient, 12 encoder, 4 decoder self, 4 cross), 24 per
    eval or predict batch; a repeated batch's loss falls; ms per step, the
    split, busy share, peak memory, checkpoint size
9b. one f32 PhonemeLaTr train step (batch 4) kernels vs plain, as 7b, with
    dropout off; then with the preset's dropout 0.1, its gradient gaps
    printed beside the yardstick's and not held to it
9c. 6 train steps each of CustomizedLaTrExecutor, PreSTUExecutor (48
    launches a step, 12 of them the ViT's FusedAttentionFn calls; every ViT
    parameter gets a finite, nonzero gradient and moves),
    CustomizedPreSTUExecutor and PhonemePreSTUExecutor (32 each, the ViT
    frozen: no optimizer state, unmoved): the first counted, 5 timed
9d. one f32 PreSTU train step (batch 4) kernels vs plain, ViT gradients
    included
10. beam search (num_beam 4) through the executors' generate, on the
    fixture's first 32 rows: PhonemeLaTr-base (20 answer triples, 24
    attention launches a batch) and PhonemeSaL-base (40 ids, 12 SaL
    launches); a beam of one gives greedy's rows; in f32 the beam through
    the kernels gives the plain path's rows (but at the beam's near-ties)
    and scores within 1e-4; ms a batch and peak memory against greedy's,
    the rows whose score beats greedy's, the profiler's busy share; C1: the
    bf16 beam executor serves 32 requests through the gathered engine (its
    eager decode, as stats() names it), rows equal to its infer's, one
    batch, 24 launches
11. LaTr-base with SPEC_DECODE 4 (B=32): in f32 one decode_step_k window
    equals four one-token steps (1e-4 relative); oracle drafts (greedy's
    own rows) take one trip a window; prompt-lookup speculative decoding
    through the executor gives greedy's rows in f32 and in bf16 (but at
    near-ties), 24 launches a batch; trips, acceptance, ms a batch against
    greedy's
12. EVAL_CONTINUOUS (the slot-refill pool decode, EVAL_SLOTS 32) through
    the LaTr-base and PhonemeLaTr-base executors' infer over 64 rows:
    answers identical to the batch decode's in f32, rows in bf16 (but at
    near-ties), 24 launches a prefilled batch; ms against the batch path
13. LaTr-base SAMPLE: TEMPERATURE 0 and TOP_K 1 give greedy's tokens, one
    SEED draws the same tokens, two calls draw others, TOP_K 5 draws lie in
    each step's five highest logits; C1: the SAMPLE executor serves 32
    requests through the gathered engine, rows equal to its infer's at the
    same call counter; PREDICT_SCORES through predict() gives confidences
    within 1e-6 of exp(greedy's scores)
14. the gathered ServingEngine (buckets 1, 4, 32) over LaTr-base and
    PhonemeLaTr-base: every bucket's replayed rows bit for bit the eager
    generate's, and 128 requests from 8 client threads answered as
    executor.infer answers them, in bf16 and f32; 24 attention launches per
    decoded batch; the capture time and peak memory per bucket, answers/s
    under the flood (beside the eager infer's), p50 / p99 latency alone and
    under the flood, the device busy share of a flood window (profiler)
15. the ContinuousEngine (32 slots, one CUDA graph replay a dispatch) over
    LaTr-base on a grid of horizon 4 and 8 at prefill chunk 16 (the CLI's
    defaults: 4 x 16), then PhonemeSaL-base (12 SaL launches a prefill) at the
    grid's best point: launches per prefill chunk, the phase-14 timings, f32
    answers equal infer's, bf16 rows equal greedy's but at near-ties (twice
    the measured window-step logit gap), a mid-stream join
16. faults, both engines (LaTr-base widths, 2 layers each): a hung dispatch
    fails the in-flight futures within the 2 s stall timeout and stop()
    returns; an expired request resolves TimeoutError; reload then answer
    equals a fresh engine on the new weights
17. python -m phoneme_vqa_torch.serve at full width (LaTr-base, a JSON
    config): --prime with a kernel store (--aot) exits 0; a stdin/stdout
    round trip loads the store; an HTTP server answers /answer, /stats,
    /metrics, /healthz, then drains on SIGTERM and exits 0

18. weight import at full width: a LaTr-base T5 as t5/model.safetensors and a
    ViT-base as vit/pytorch_model.bin, written with seeded values from the
    committed manifest of transformers' layout (tests/data), imported through
    pretrained_weights_path: every manifest key mapped, 0 failed; the f32
    logits and greedy rows pass phase 5's gates; bf16 requests through the
    gathered engine; load seconds and peak memory
19. a full-width PhonemeSaL-base reference .pth converted by python -m
    phoneme_vqa_torch.import_reference_ckpt and evaluated by python -m
    phoneme_vqa_torch.run --mode eval; the converted checkpoint's answers
    equal those of the in-process import
20. LaTr-base with LORA_RANK 8, 20 steps at batch 16: optimizer state for the
    adapters only, the base bit for bit unchanged, 48 launches a step, ms a
    step and peak beside phase 7's; one f32 step kernels vs plain (7b's
    yardstick); two serving adapters through one gathered engine, every
    route's answers equal to an engine over its merged weights, the base
    restored bit for bit, the switch ms
21. REMAT on LaTr-base and SaL-base with dropout 0.1: an f32 step on vs off
    within 7b's yardstick, the launches counted (84 and 24 SaL + 48 a step),
    ms a step and peak in interleaved turns; GRAD_ACCUM_STEPS 4 against four
    hand-run microbatches; a few steps of EMA_DECAY, adafactor and
    OPT_MU_DTYPE bfloat16 with their optimizer-state bytes
22. VIT_CACHE: LaTr-base eval over 64 questions on 16 images, answers equal
    the uncached run's with 12 launches a batch (24 uncached); the serving
    encoding cache hits, answers as an uncached engine, flushes on reload

24. (run first, after phase 2, while torch.profiler still records every
    CUDA kernel; 23 too but its NUMWORKERS) both kernels at the head slices
    a tensor-parallel rank gives them (tp 2 and 4: the ViT and T5 encoder serving shapes, the SaL
    serving shape with head slices of bias1d and cell_bias), q/k/v as head
    slices of (B, L, H, D) storage: every rank's call equals the full call's
    heads bit for bit; kernel, plain and SDPA times on the slice, device
    time, the bound
23. the last A12 knobs on full-width LaTr-base (phase 7's config):
    FEATURE_CACHE a miss then a hit (featurize against load seconds; the
    arrays equal, the first-step loss bit-identical), PROFILE_DIR over 3
    steps (the trace's size and write seconds; the attention kernel named
    exactly 48 times a step), DEBUG_NANS on against off (ms a step) and a
    NaN injected into one T5 block's output raising FloatingPointError that
    names the block; NUMWORKERS 0 against 2, run before 25 (interleaved ms
    a step, losses bit-identical; a profiler session after its prefetch
    threads may record no CUDA kernel, and one such session is logged)
25. the mesh lifecycle at full width, 4 layers deep a stack
    (phoneme_vqa_torch.dryrun.run_mesh, f32, batch 4, 3 steps): (a) one
    NCCL process a card with MESH {data: -1} (on
    one card a world of one), (b) two gloo processes on one card with
    {model: 2} (beam search too), {data: 2} and {data: 2, zero1: true} (with
    2 or 4 cards, also NCCL
    across them at {model: 2} and {data: 2, model: 2, zero1: true}), and a
    SaL-base step at
    {model: 2} (4 SaL launches a rank, 6 heads each); against the same
    steps in this process: the loss within 1e-4, the masters after the
    first step within 2 lr (all but 0.1 % within rtol 1e-4 / atol 2e-5), the
    checkpoint written on the mesh read back on it and in one process bit
    for bit, greedy rows at the seeded init identical but at ties within
    1e-4, beam rows identical; per rank ms a step, peak GB, optimizer-state
    bytes
26. serving over a mesh, from phase 25's spawned processes once their steps
    are done (phoneme_vqa_torch.dryrun.run_mesh's serve mode): full-width,
    full-depth LaTr-base in f32, two gloo processes on the one card, the
    gathered engine at {model: 2} (32 requests in waves of 1, 3 and 28:
    buckets 1, 4, 32) and the continuous engine (32 slots), the gathered
    engine at {data: 2} (buckets 2, 4, 32), first through the executor's
    eager generate, then from each data rank's own CUDA graphs, in the same
    processes; SaL-base's gathered engine at {model: 2} (32 requests at
    bucket 32); with 2 cards the LaTr-base engines at {model: 2} over NCCL
    too (the gathered engine eager, then both from graphs that hold the
    model axis's collectives). Over gloo at model 2 nothing is captured.
    Rows equal this process's eager greedy rows on the same seeded weights
    but at top-2 ties within 1e-4; the decode each engine names; every
    rank's launches exact (24 a LaTr batch or prefill chunk at 6 heads or
    half the rows; 12 SaL, 0 attention a SaL batch); at model 2 every rank
    runs as many decode chunks; ms a batch and answers/s per rank, capture s
    and graph-decoder bytes per bucket, eager against graphs on one line

Prints the run's total seconds, a {"kernels": [...]} line, the card line, and last
{"ok": true, "device": {...}}. Needs the repo's phoneme_vqa_torch package;
imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA card is available")

from phoneme_vqa_torch.config import Config  # noqa: E402
from phoneme_vqa_torch.data import synthetic  # noqa: E402
from phoneme_vqa_torch.data.loader import batch_iterator  # noqa: E402
from phoneme_vqa_torch.decode import beam as beam_mod  # noqa: E402
from phoneme_vqa_torch.decode.greedy import greedy_decode, multi_head_greedy_decode  # noqa: E402
from phoneme_vqa_torch.decode.speculative import speculative_greedy_decode  # noqa: E402
from phoneme_vqa_torch.models import custom_decoder as custom_decoder_mod  # noqa: E402
from phoneme_vqa_torch.models import hf_import  # noqa: E402
from phoneme_vqa_torch.models import t5 as t5_mod  # noqa: E402
from phoneme_vqa_torch.models import vit as vit_mod  # noqa: E402
from phoneme_vqa_torch.ops import _build  # noqa: E402
from phoneme_vqa_torch.ops import attention as attn_mod  # noqa: E402
from phoneme_vqa_torch.ops import flash_attention as fa  # noqa: E402
from phoneme_vqa_torch.ops import layout  # noqa: E402
from phoneme_vqa_torch.ops import sal_fused_attention as sfa  # noqa: E402
from phoneme_vqa_torch.serving import ContinuousEngine, GraphDecoder, ServingEngine  # noqa: E402
from phoneme_vqa_torch.serving.graphs import decoder_bytes  # noqa: E402
from phoneme_vqa_torch.models.generate import build_generate_fn, decode_token_ids  # noqa: E402
from phoneme_vqa_torch.models.generate import make_beam_generate_fn  # noqa: E402
from phoneme_vqa_torch.models.generate import make_multi_head_beam_generate_fn  # noqa: E402
from phoneme_vqa_torch.phonology.analyze import CODAS, NUCLEI, ONSETS, TONE_VI  # noqa: E402
from phoneme_vqa_torch.phonology.analyze import is_vietnamese_3  # noqa: E402
from phoneme_vqa_torch.phonology.compose import compose_word  # noqa: E402
from phoneme_vqa_torch.tokenizers import PhonemeTokenizer, StructuredPhonemeTokenizer  # noqa: E402
from phoneme_vqa_torch.train import (  # noqa: E402
    CustomizedLaTrExecutor,
    CustomizedPreSTUExecutor,
    LaTrExecutor,
    PhonemeLaTrExecutor,
    PhonemePreSTUExecutor,
    PhonemeSaLExecutor,
    PreSTUExecutor,
    SaLExecutor,
)
from phoneme_vqa_torch.train import lora as lora_mod  # noqa: E402
from phoneme_vqa_torch.train import state as train_state  # noqa: E402
from phoneme_vqa_torch.utils.registry import EXECUTORS  # noqa: E402

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
# PhonemeSaL-base (configs/phonemesal.yaml): the SaL-base encoder and a
# 4-layer custom decoder (12 heads, d_ff 2048) over the flat phoneme
# vocabulary (253 ids); answers of 40 ids, so the decoder reads 39 positions
# in training
PSAL_FULL = dict(SAL_FULL, n_head=12, num_decoder_layers=4)
PSAL_ANSWER = 40
PSAL_DEC_L = PSAL_ANSWER - 1
# PhonemeLaTr-base and CustomizedLaTr-base (configs/phonemelatr.yaml,
# customizedlatr.yaml): the LaTr-base encoder under a 4-layer decoder (12
# heads, d_ff 2048); the PreSTU family (configs/prestu.yaml,
# customizedprestu.yaml, phonemeprestu.yaml) the same widths over [ViT patches
# | question + OCR] (30 + 100 tokens): encoder 327 again, no spatial stream
LATR_CUSTOM_FULL = dict(FULL, n_head=12, num_decoder_layers=4)
# f32: the kernels sum q·k and P·v in another order than cuBLAS; rounding is
# ~1e-6 relative and the softmax's exp scales it by the logit size. bf16: a
# kernel's output is rounded to bf16 (2^-8 relative); the plain result is f32
# on the same bf16 inputs.
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# end to end in f32 the per-layer differences above pass through 24 layers and
# the LM head; logits are O(1)
LOGITS_TOL = 2e-3
TIE_MARGIN = 1e-4
# phase 7b, one f32 train step kernels vs plain. The f32 kernel parts from
# cuBLAS by ~2e-6 a call (phase 3: 1.7e-6); through the 48 attention layers
# of the random-init model that grows to ~4e-4 in the logits (phase 5) and
# to ~1e-2 of the norm of the most sensitive gradients (the decoder's self-
# attention q/k, where a softmax over near-uniform weights cancels). So the
# yardstick is the plain path disturbed by as much (NOISE, relative, on
# every attention output): a tensor's kernel-vs-plain gradient gap may be at
# most GRAD_NOISE_FACTOR times its noisy-vs-plain gap (plus GRAD_FLOOR, the
# run-to-run spread of the gradients summed with atomics). A broken
# gradient path parts by O(1). A first adam step moves a parameter by ~lr *
# sign(g), so where |g| is near those differences it parts by up to 2 lr.
# In the step's own forward every attention call's kernel output must lie
# within KERNEL_CALL_RTOL of the plain output on the same inputs (the norm
# of the difference over the norm; f32 rounding gives ~1.5e-7).
LOSS_RTOL = 1e-4
NOISE = 2e-6
GRAD_NOISE_FACTOR = 3.0
GRAD_FLOOR = 1e-6
KERNEL_CALL_RTOL = 1e-6
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


# a special or tone token's name in a decoded answer ("<pad>", "<eos>",
# "<huyền>", ...): an answer tokenizer must drop or recompose them. Single
# characters such as "<" are answer text (both phoneme vocabularies hold
# punctuation).
SPECIAL_TOKEN = re.compile(r"<[^\W\d_]{2,}>")


def has_special_tokens(answers) -> bool:
    return any(SPECIAL_TOKEN.search(a) for a in answers)


_T0 = time.perf_counter()
PHASE_DONE_S: dict = {}  # "phase N" -> seconds into the run of its last line


def log(msg: str) -> None:
    print(msg, flush=True)
    m = re.match(r"phase [0-9]+[a-z]?", msg)
    if m:
        PHASE_DONE_S[m.group(0)] = time.perf_counter() - _T0


def phase_seconds() -> dict:
    """Each phase's seconds from the last line of the phase logged before
    it to its own last line, in the order the phases ended."""
    out, prev = {}, 0.0
    for key, t in sorted(PHASE_DONE_S.items(), key=lambda kv: kv[1]):
        out[key], prev = round(t - prev, 1), t
    return out


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


def sal_serving_shape(batch=BATCH, dtype=torch.bfloat16, seed=5):
    """The SaL encoder self-attention at B=32 (or ``batch``), H=12, L=336,
    D=64, bf16 (or ``dtype``) with tables in the same type, q, k, v in the
    models' layout: sentinel cells outside the OCR block, a key mask."""
    q, k, v, bias1d, cb, cell, mask = _sal_inputs(batch, 12, SAL_L, 64, dtype, dtype, seed=seed)
    q, k, v = model_layout(q, k, v)
    ocr = slice(SAL_FULL["max_q_length"], SAL_FULL["max_q_length"] + SAL_FULL["max_ocr_length"])
    g = torch.Generator(device=DEVICE).manual_seed(6)
    cell[:] = sfa.SENTINEL
    cell[:, ocr] = torch.randint(0, 121, cell[:, ocr].shape, generator=g, device=DEVICE,
                                 dtype=torch.int32)
    mask[-1] = 1
    return q, k, v, bias1d, cb, cell, mask


# -- phase 3c -----------------------------------------------------------------

TRAIN_BATCH = 16  # configs/latr.yaml TRAIN_BATCH_SIZE
ANSWER_LEN = 128  # configs/latr.yaml max_a_length: the decoder reads 127 positions
DEC_L = ANSWER_LEN - 1
ENC_L = 197 + OCR_LEN + Q_LEN  # ViT patches + CLS, OCR, question: 327


def padded_bias(lq, lk, seed):
    """A (1, 12, Lq, Lk) f32 bias with rows 16 bytes apart, as the T5
    RelativeBias builds it."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return layout.kernel_operand(torch.randn(1, 12, lq, lk, generator=g, device=DEVICE))[0]


def training_shapes(dtype, batch=TRAIN_BATCH):
    """(role, q, k, v, bias, mask, causal, scale) for the four attention roles
    of a LaTr-base train step, q, k, v in the models' layout: the ViT (no
    gradient in training: it is frozen), the T5 encoder, the decoder
    self-attention and the cross-attention."""
    q, k, v, _, _ = _attn_inputs(batch, 12, 197, 197, 64, dtype, seed=20)
    vit = ("vit", *model_layout(q, k, v), None, None, False, 64**-0.5)
    q, k, v, _, mask = _attn_inputs(batch, 12, ENC_L, ENC_L, 64, dtype, seed=21)
    mask[-1] = 1
    enc = ("t5_encoder", *model_layout(q, k, v), padded_bias(ENC_L, ENC_L, 22), mask, False, None)
    q, k, v, _, _ = _attn_inputs(batch, 12, DEC_L, DEC_L, 64, dtype, seed=23)
    lens = torch.randint(2, DEC_L, (batch,), generator=torch.Generator().manual_seed(24))
    dec_mask = (torch.arange(DEC_L)[None] < lens[:, None]).to(torch.int32).to(DEVICE)  # answers
    dec = ("t5_decoder_self", *model_layout(q, k, v), padded_bias(DEC_L, DEC_L, 25), dec_mask,
           True, None)
    q, _, _, _, _ = _attn_inputs(batch, 12, DEC_L, 1, 64, dtype, seed=26)
    _, k, v, _, _ = _attn_inputs(batch, 12, 1, ENC_L, 64, dtype, seed=27)
    cross = ("t5_cross", *model_layout(q, k, v), None, mask, False, None)
    return [vit, enc, dec, cross]


def phoneme_training_shapes(dtype, batch=TRAIN_BATCH):
    """(role, q, k, v, bias, mask, causal, scale) for the attention-kernel
    roles of a PhonemeSaL-base train step, q, k, v in the models' layout: the
    custom decoder's self-attention (39 x 39, causal, scale 1/8, the
    answers' key mask) and cross-attention (39 x 336, scale 1/8, the encoder
    mask), and the SaL encoder with SAL_FUSED off (the materialized (B, 12,
    336, 336) f32 bias, key mask)."""
    scale = 64**-0.5
    q, k, v, _, _ = _attn_inputs(batch, 12, PSAL_DEC_L, PSAL_DEC_L, 64, dtype, seed=30)
    lens = torch.randint(2, PSAL_DEC_L, (batch,), generator=torch.Generator().manual_seed(31))
    dec_mask = (torch.arange(PSAL_DEC_L)[None] < lens[:, None]).to(torch.int32).to(DEVICE)
    dec = ("custom_decoder_self", *model_layout(q, k, v), None, dec_mask, True, scale)
    q, _, _, _, _ = _attn_inputs(batch, 12, PSAL_DEC_L, 1, 64, dtype, seed=32)
    _, k, v, _, mask = _attn_inputs(batch, 12, 1, SAL_L, 64, dtype, seed=33)
    mask[-1] = 1
    cross = ("custom_decoder_cross", *model_layout(q, k, v), None, mask, False, scale)
    q, k, v, bias1d, cb, cell, mask = sal_serving_shape(batch, dtype, seed=34)
    enc = ("sal_encoder_materialized", q, k, v, sfa.materialize_sal_bias(bias1d, cb, cell), mask,
           False, None)
    return [dec, cross, enc]


def latr_family_training_shapes(dtype, batch=TRAIN_BATCH):
    """(role, q, k, v, bias, mask, causal, scale) for the attention-kernel
    roles that the PhonemeLaTr / PreSTU family's train steps add, q, k, v in
    the models' layout: the triple (or custom) decoder's self-attention (127
    x 127, causal, scale 1/8, the answers' key mask) and cross-attention (127
    x 327, scale 1/8, the encoder mask), and the ViT under gradients (197 x
    197, scale 1/8, no mask: PreSTU trains its ViT)."""
    scale = 64**-0.5
    q, k, v, _, _ = _attn_inputs(batch, 12, DEC_L, DEC_L, 64, dtype, seed=40)
    lens = torch.randint(2, DEC_L, (batch,), generator=torch.Generator().manual_seed(41))
    dec_mask = (torch.arange(DEC_L)[None] < lens[:, None]).to(torch.int32).to(DEVICE)
    dec = ("triple_decoder_self", *model_layout(q, k, v), None, dec_mask, True, scale)
    q, _, _, _, _ = _attn_inputs(batch, 12, DEC_L, 1, 64, dtype, seed=42)
    _, k, v, _, mask = _attn_inputs(batch, 12, 1, ENC_L, 64, dtype, seed=43)
    mask[-1] = 1
    cross = ("triple_decoder_cross", *model_layout(q, k, v), None, mask, False, scale)
    q, k, v, _, _ = _attn_inputs(batch, 12, 197, 197, 64, dtype, seed=44)
    vit = ("vit_train", *model_layout(q, k, v), None, None, False, scale)
    return [dec, cross, vit]


def _grads(fn, tensors, w):
    """(output, gradient of sum(out * w) for every tensor input) of
    ``fn(*tensors)``, each tensor a fresh leaf in its own layout."""
    leaves = [t if t is None else t.detach().requires_grad_() for t in tensors]
    out = fn(*leaves)
    wanted = [t for t in leaves if t is not None]
    return out, torch.autograd.grad((out.float() * w).sum(), wanted)


def _check_grads(kernel_fn, plain_fn, tensors, tol, what) -> float:
    """Gradients through ``kernel_fn`` (an autograd.Function on the kernel)
    against ``plain_fn``'s on the same inputs: every input that requires
    grad gets a finite, nonzero gradient, each within ``tol`` of the plain
    one (the backward is the same plain recompute on the same inputs and
    upstream gradient, so they agree to the bit unless cuBLAS picks another
    algorithm); the kernel's forward within ``tol`` of the f32 plain result.
    Returns the largest gradient difference."""
    shape = tensors[0].shape[:3] + (tensors[2].shape[3],)
    w = torch.randn(shape, generator=torch.Generator(device=DEVICE).manual_seed(9), device=DEVICE)
    k_out, k_grads = _grads(kernel_fn, tensors, w)
    _, p_grads = _grads(plain_fn, tensors, w)
    with torch.no_grad():  # the forward against the f32 plain result, as in phase 3
        want = plain_fn(*(t if t is None else t.float() for t in tensors))
    torch.cuda.synchronize()
    torch.testing.assert_close(k_out.float(), want, atol=tol, rtol=tol)
    worst = 0.0
    for i, (g, ref) in enumerate(zip(k_grads, p_grads)):
        if g is None or not torch.isfinite(g).all() or not g.abs().max() > 0:
            raise AssertionError(f"phase 3c: {what}: input {i} got no usable gradient")
        worst = max(worst, float((g.float() - ref.float()).abs().max()))
        torch.testing.assert_close(g.float(), ref.float(), atol=tol, rtol=tol)
    return worst


def check_kernel_grads() -> dict:
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    reset_launches()
    n = 0
    fn = attn_mod.FusedAttentionFn.apply
    for dtype, length, d in itertools.product(worst, (16, 37, 131, 327), (64, 32, 128)):
        q, k, v, bias_full, mask = _attn_inputs(2, 3, length, length, d, dtype)
        mask[-1] = 1
        for bias_kind, use_mask, causal, scale in itertools.product(
            ("none", "one", "batch"), (False, True), (False, True), (None, d**-0.5)
        ):
            bias = {"none": None, "one": bias_full[:1].contiguous(), "batch": bias_full}[bias_kind]
            m = mask if use_mask else None
            err = _check_grads(
                lambda q_, k_, v_, b_: fn(q_, k_, v_, b_, m, causal, scale),
                lambda q_, k_, v_, b_: attn_mod.reference_attention(q_, k_, v_, b_, m, causal,
                                                                    scale),
                (q, k, v, bias), TOL[dtype], f"{dtype} L={length} d={d} {bias_kind}")
            worst[dtype] = max(worst[dtype], err)
            n += 1
    roles = {}
    for dtype in worst:
        for role, q, k, v, bias, mask, causal, scale in (
                training_shapes(dtype) + phoneme_training_shapes(dtype)
                + latr_family_training_shapes(dtype)):
            err = _check_grads(
                lambda q_, k_, v_, b_: fn(q_, k_, v_, b_, mask, causal, scale),
                lambda q_, k_, v_, b_: attn_mod.reference_attention(q_, k_, v_, b_, mask, causal,
                                                                    scale),
                (q, k, v, bias), TOL[dtype], f"{dtype} {role}")
            worst[dtype] = max(worst[dtype], err)
            roles[f"{role}_{str(dtype).replace('torch.', '')}"] = err
            n += 1
    check_launches("phase 3c", launches(), {"flash_attention": n, "sal_fused_attention": 0})
    q, k, v, bias1d, cb, cell, mask = sal_serving_shape()
    sal_err = _check_grads(
        lambda *a: sfa.SalAttentionFn.apply(*a, cell, mask),
        lambda *a: sfa.sal_reference_attention(*a, cell, mask),
        (q, k, v, bias1d, cb), TOL[torch.bfloat16], "SaL serving shape")
    sal_train = {}
    for dtype in worst:  # the SaL encoder of a SaL-family train step (SAL_FUSED on)
        q, k, v, bias1d, cb, cell, mask = sal_serving_shape(TRAIN_BATCH, dtype, seed=35)
        sal_train[str(dtype).replace("torch.", "")] = _check_grads(
            lambda *a: sfa.SalAttentionFn.apply(*a, cell, mask),
            lambda *a: sfa.sal_reference_attention(*a, cell, mask),
            (q, k, v, bias1d, cb), TOL[dtype], f"SaL training shape {dtype}")
    check_launches("phase 3c", launches(), {"flash_attention": n, "sal_fused_attention": 3})
    log(f"phase 3c: gradients through FusedAttentionFn == plain over {n} cases (the phase-3 "
        f"grid, the four LaTr-base, three PhonemeSaL-base and three PhonemeLaTr / PreSTU "
        f"training roles at B={TRAIN_BATCH}); max |grad err| f32 {worst[torch.float32]:.3e}, bf16 "
        f"{worst[torch.bfloat16]:.3e} (tol {TOL}); by role {json.dumps(roles)}; SalAttentionFn "
        f"at the SaL serving shape {sal_err:.3e}, at the training shape (B={TRAIN_BATCH}) "
        f"{json.dumps(sal_train)}; one kernel launch per forward, none in a backward")
    return {"max_grad_err_f32": worst[torch.float32], "max_grad_err_bf16": worst[torch.bfloat16],
            "train_roles": roles, "sal_max_grad_err": max(sal_err, *sal_train.values()),
            "sal_train_grad_err": sal_train, "cases": n + 3}


# -- phases 4 and 4b ----------------------------------------------------------


def latr_fixture(root):
    return synthetic.make_latr_fixture(root, n_images=8, n_rows=12,
                                       image_hw=FULL["vit_image_size"])


def sal_fixture(root):
    return synthetic.make_sal_fixture(root, n_images=8, n_rows=12, n_ocr_words=SAL_OCR_ELEMENTS,
                                      region_hidden=SAL_FULL["obj_hidden"])


def serve_executor(config):
    """``config``'s executor in serve mode on the card (no QA CSV read), its
    random init drawn from ``SEED``: the values ``build_latr`` and
    ``build_sal`` give."""
    ex = EXECUTORS.get(config.EXECUTOR)(config, "serve", device=DEVICE)
    ex._ensure_params()
    ex.model.eval()  # no dropout in the phases' own forwards either
    return ex


def requests(n=N_REQUESTS):
    return [(float(i % 8), synthetic.QUESTIONS[i % len(synthetic.QUESTIONS)])
            for i in range(n)]


def request_dataset(ex, reqs):
    """``reqs`` featurized by the executor against its feature stores."""
    rows = [{"image_id": i, "question": q, "answer": ""} for i, q in reqs]
    return ex._make_dataset(rows, *[s for s in ex.serve_frames if s is not None])


def first_batch(ex, reqs, n=BATCH):
    """The first ``n`` requests of ``reqs``, featurized and on the card."""
    batch, _ = next(batch_iterator(request_dataset(ex, reqs[:n]), n))
    return ex._device_batch(batch)


def answer_all(engine, reqs):
    futures = [engine.submit(i, q) for i, q in reqs]
    return [f.result(timeout=FUTURE_TIMEOUT) for f in futures]


def serve(phase, title, engine, reqs, per_batch: dict) -> dict:
    """The gathered engine (``ServingEngine``, its decode replayed from the
    bucket's CUDA graphs) answers ``reqs``; ``per_batch`` is each kernel's
    launches per decoded batch. An executor with an answer tokenizer (the
    phoneme decoders) must answer recomposed words, never phoneme or tone
    tokens. Then one batch's time split on the eager path (featurize,
    encode, the eager generate), as the synchronous engine ran it."""
    ex = engine.executor
    model = ex.model
    max_answer = engine.max_answer_length
    answer_all(engine, reqs[:BATCH])  # warm-up: cuBLAS handles, allocator pools
    torch.cuda.synchronize()

    batches0 = engine.stats()["batches"]
    reset_launches()
    t0 = time.perf_counter()
    answers = answer_all(engine, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launches()
    n_batches = engine.stats()["batches"] - batches0

    if len(answers) != len(reqs) or not all(isinstance(a, str) for a in answers):
        raise AssertionError(f"{phase}: {len(answers)} answers for {len(reqs)} requests")
    if hasattr(ex, "decode_tokenizer") and has_special_tokens(answers):
        raise AssertionError(f"{phase}: special tokens in the decoded answers {answers[:4]}")
    check_launches(phase, got, {k: n * n_batches for k, n in per_batch.items()})
    ms_per_batch = 1e3 * wall / n_batches

    # split one batch's time: featurize on the host, encode (fuse, encoders,
    # cache), the eager decode loop
    generate = ex._get_generate_fn(max_answer)
    t0 = time.perf_counter()
    tb = first_batch(ex, reqs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.inference_mode():
        model.encode_for_generate(tb, max_answer)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = generate(tb)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    eos = decode_token_ids(model)[1]
    # a triple decoder's row is done at its onset's EOS
    rows = out[..., 0].tolist() if out.dim() == 3 else out.tolist()
    steps = max(row.index(eos) if eos in row else max_answer - 1 for row in rows)
    split = {
        "featurize_ms": 1e3 * (t1 - t0), "encode_ms": 1e3 * (t2 - t1),
        "generate_ms": 1e3 * (t3 - t2), "decode_ms": 1e3 * ((t3 - t2) - (t2 - t1)),
        "decode_steps_max": steps,
    }
    split.update(profile_generate(generate, tb, split["generate_ms"]))
    log(f"{phase}: {len(answers)} answers in {n_batches} batches of {BATCH} through the gathered "
        f"engine's graphs (bf16, full-width {title}): {ms_per_batch:.3f} ms/batch, "
        f"{len(answers) / wall:.3f} answers/s; kernel launches {got} = {per_batch} x "
        f"{n_batches}; the eager generate's device kernel launches per batch (profiler) "
        f"{split['device_kernel_launches']}; one batch split on the eager path "
        f"{json.dumps(split)}; sample answers {answers[:3]}")
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
    # row gathers and index kernels: the beam reorder (index_select), take
    # and gather of the decode loops
    gathers = [e for e in kernels if re.search(r"index|gather", e.key, re.IGNORECASE)]
    return {
        "profiled_wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / (1e3 * wall_ms),
        "device_kernel_launches": sum(e.count for e in kernels),
        "attention_kernels_ms": sum(e.self_device_time_total for e in ours) / 1e3,
        "attention_kernel_launches": sum(e.count for e in ours),
        "gather_index_kernels_ms": sum(e.self_device_time_total for e in gathers) / 1e3,
        "gather_index_kernel_launches": sum(e.count for e in gathers),
        "top_kernels_ms": {e.key[:90]: e.self_device_time_total / 1e3 for e in top},
    }


# -- phases 5 and 5b ----------------------------------------------------------


def plain_attention(q, k, v, bias=None, key_mask=None, causal=False, scale=None):
    """``dot_product_attention`` with every kernel replaced by its plain
    version: a ``FusedSalBias`` is materialized."""
    if isinstance(bias, sfa.FusedSalBias):
        bias = bias.materialize()
    return attn_mod.reference_attention(q, k, v, bias, key_mask, causal, scale)


def _greedy_with_logits(model, tb, max_answer):
    """Greedy rows and every step's logits, as a tuple of heads (one head,
    or the triple decoder's onset, rhyme and tone)."""
    cache, full_bias, enc_mask = model.encode_for_generate(tb, max_answer)
    seen = []

    def step(tokens, cache, i):
        logits, cache = model.decode_step(tokens, cache, i, full_bias, enc_mask)
        seen.append(logits if isinstance(logits, tuple) else (logits,))
        return logits, cache

    components = getattr(model, "decode_components", 1)
    if components == 1:
        out = greedy_decode(step, cache, enc_mask.shape[0], max_answer,
                            *decode_token_ids(model), DEVICE)
    else:
        out = multi_head_greedy_decode(step, cache, enc_mask.shape[0], max_answer, components,
                                       *decode_token_ids(model), DEVICE)
    return out, seen


def tie_parted(phase, rows, ref_rows, ref_seen, offset=0, margin_allowed=TIE_MARGIN):
    """Greedy ``rows`` against ``ref_rows``: identical, except that a row may
    part where the reference's top-2 logits at that step lie within
    ``margin_allowed`` (in every head that parted). ``ref_seen[i]``: the
    reference step i's logits, a tuple of heads, for the rows from
    ``offset`` on. Returns (rows parted, the largest margin at a parting)."""
    parted, worst_margin = 0, 0.0
    for r, (kr, pr) in enumerate(zip(rows, ref_rows)):
        for i, (a, b) in enumerate(zip(kr, pr)):
            if a != b:
                heads = [c for c, (x, y) in enumerate(zip(a, b)) if x != y] \
                    if isinstance(a, list) else [0]
                margin = 0.0
                for c in heads:
                    top2 = torch.topk(ref_seen[i - 1][c][offset + r], 2).values
                    margin = max(margin, float(top2[0] - top2[1]))
                if margin > margin_allowed:
                    raise AssertionError(f"{phase}: row {offset + r} step {i} token {a} != {b}, "
                                         f"reference top-2 margin {margin} (allowed "
                                         f"{margin_allowed})")
                parted += 1
                worst_margin = max(worst_margin, margin)
                break
    return parted, worst_margin


ATTENTION_USERS = (t5_mod, vit_mod, custom_decoder_mod)  # modules that call the dispatch


class attention_replaced:
    """Within the block, every model's attention is ``attention`` (the plain
    path or the noisy yardstick) in place of the kernel dispatch."""

    def __init__(self, attention):
        self.attention = attention

    def __enter__(self):
        self.saved = [m.dot_product_attention for m in ATTENTION_USERS]
        for m in ATTENTION_USERS:
            m.dot_product_attention = self.attention

    def __exit__(self, *exc):
        for m, fn in zip(ATTENTION_USERS, self.saved):
            m.dot_product_attention = fn


def check_end_to_end_f32(phase, model, tb, want_launches: dict,
                         vocab=T5_BASE["t5_vocab_size"], max_answer=MAX_ANSWER) -> dict:
    """Teacher-forced logits and greedy tokens through the kernels against
    the same model with ``plain_attention``; labels from the decoder's
    ``vocab``, ``max_answer`` long. A triple decoder's ``vocab`` is its
    (onset, rhyme, tone) sizes: every head's logits are held, and its greedy
    rows are (onset, rhyme, tone) triples."""
    g = np.random.RandomState(SEED)
    vocabs = vocab if isinstance(vocab, tuple) else (vocab,)
    labels = np.stack([g.randint(3, v, (BATCH, max_answer)) for v in vocabs], -1)
    labels = torch.from_numpy(labels if len(vocabs) > 1 else labels[..., 0]).to(DEVICE)
    label_mask = torch.ones(labels.shape[:2], dtype=torch.int32, device=DEVICE)
    label_mask[: BATCH // 2, max_answer // 2 :] = 0

    def run():
        with torch.inference_mode():
            logits = model(tb, labels, label_mask)
            out, seen = _greedy_with_logits(model, tb, max_answer)
        torch.cuda.synchronize()
        return logits if isinstance(logits, tuple) else (logits,), out, seen

    reset_launches()
    k_logits, k_out, _ = run()
    check_launches(phase, launches(), want_launches)
    with attention_replaced(plain_attention):
        reset_launches()
        p_logits, p_out, p_seen = run()
        check_launches(phase, launches(), {name: 0 for name in KERNELS})
    if not all(torch.isfinite(h).all() for h in k_logits):
        raise AssertionError(f"{phase}: non-finite logits")
    logits_err = max(float((k - p).abs().max()) for k, p in zip(k_logits, p_logits))
    for k, p in zip(k_logits, p_logits):
        torch.testing.assert_close(k, p, atol=LOGITS_TOL, rtol=LOGITS_TOL)

    k_rows = k_out.tolist()
    parted, worst_margin = tie_parted(phase, k_rows, p_out.tolist(), p_seen)
    log(f"{phase}: f32 teacher-forced logits kernels vs plain max |err| {logits_err:.3e} "
        f"(tol {LOGITS_TOL}); greedy rows identical {BATCH - parted}/{BATCH}, parted rows "
        f"{parted} (largest plain top-2 margin at a parting {worst_margin:.3e}, allowed "
        f"{TIE_MARGIN}); tokens[0] {k_rows[0]}")
    return {"logits_max_abs_err": logits_err, "greedy_rows_parted": parted}


def run_family(phase, title, make_ex, fixture, per_batch, e2e_launches, root,
               max_answer=MAX_ANSWER, **e2e_kw):
    """Serve at bf16 through the gathered engine (phase ``phase``), then check
    f32 end to end (the next phase) on the first serving batch.
    ``make_ex(paths, dtype)``: the family's serve-mode executor on the
    fixture; ``e2e_kw``: the decoder's vocabulary."""
    reqs = requests()
    paths = fixture(root)
    ex = make_ex(paths, "bfloat16")
    with ServingEngine(ex, *ex.serve_frames, batch_size=BATCH, max_wait_ms=20,
                       max_answer_length=max_answer) as engine:
        served = serve(f"phase {phase}", title, engine, reqs, per_batch)
    del ex, engine
    torch.cuda.empty_cache()
    ex = make_ex(paths, "float32")
    e2e = check_end_to_end_f32(f"phase {phase.replace('4', '5')}", ex.model,
                               first_batch(ex, reqs), e2e_launches, max_answer=max_answer,
                               **e2e_kw)
    del ex
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
    near the host time are set by the host, not the kernel. ``device_ms`` is
    None (not measured) when the profiler recorded no CUDA kernel."""
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
    device_us = sum(e.self_device_time_total for e in kernels)
    return {f"{prefix}device_ms": device_us / iters / 1e3 if device_us > 0 else None,
            f"{prefix}host_ms": 1e3 * host_s / host_iters}


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def _bound(moved_bytes, flops):
    t_bytes, t_ops = moved_bytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _qkvo_bytes_flops(q, k):
    b, h, lq, d = q.shape
    lk = k.shape[2]
    return q.element_size() * (2 * b * h * lq * d + 2 * b * h * lk * d), 4 * b * h * lq * lk * d


def _sdpa(q, k, v, bias, mask, scale, causal=False):
    """The library yardstick: SDPA on the same inputs, with the key mask (and
    the causal mask) folded into the additive mask beforehand (timed here,
    used nowhere in the port)."""
    add = torch.zeros(1, 1, 1, k.shape[2], device=DEVICE)
    if bias is not None:
        add = add + bias
    if mask is not None:
        add = add + torch.where(mask.bool(), 0.0, -1e9)[:, None, None, :]
    if causal:
        add = add + torch.full((q.shape[2], k.shape[2]), -1e9, device=DEVICE).triu(1)
    sdpa_mask = None if bias is None and mask is None and not causal else add.to(q.dtype)
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


def time_sal_fused_choice() -> dict:
    """The SAL_FUSED choice per SaL-base serving batch (B=32, bf16): on, the
    12 encoder layers' SaL-kernel launches; off, one materialization of the
    (B, 12, 336, 336) f32 bias and 12 attention-kernel launches on it. By
    CUDA events, interleaved on, off, off, on; the device ms by the
    profiler. Prints the faster beside the port's default
    (``ops.attention.SAL_FUSED_ENABLED``)."""
    q, k, v, bias1d, cb, cell, mask = sal_serving_shape()
    n = T5_BASE["num_encoder_layers"]

    def on():
        for _ in range(n):
            sfa.sal_fused_attention(q, k, v, bias1d, cb, cell, mask)

    def off():
        bias = sfa.materialize_sal_bias(bias1d, cb, cell)
        for _ in range(n):
            fa.fused_attention(q, k, v, bias, mask, False, None)

    runs = [_time("ms", fn, iters=5)["ms"] for fn in (on, off, off, on)]
    row = {"on_ms_per_batch": (runs[0] + runs[3]) / 2, "off_ms_per_batch": (runs[1] + runs[2]) / 2,
           "on_off_off_on_ms": runs, **_split_time("on_", on, iters=5),
           **_split_time("off_", off, iters=5),
           **_time("materialize_ms", lambda: sfa.materialize_sal_bias(bias1d, cb, cell))}
    row["faster"] = "on" if row["on_ms_per_batch"] <= row["off_ms_per_batch"] else "off"
    row["default"] = "on" if attn_mod.SAL_FUSED_ENABLED else "off"
    log(f"phase 6b: SAL_FUSED per SaL-base batch: on {row['on_ms_per_batch']:.4f} ms "
        f"(device {_ms(row['on_device_ms'])}), off {row['off_ms_per_batch']:.4f} ms (device "
        f"{_ms(row['off_device_ms'])}, of it the materialization {row['materialize_ms']:.4f} ms "
        f"by events); faster: {row['faster']}; the port's default: {row['default']}; "
        f"{json.dumps(row)}")
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


def time_train_shapes(shapes) -> list:
    """Phase 6d: kernel, plain and SDPA ms per call at the attention roles
    of a train step (``training_shapes`` or ``phoneme_training_shapes``,
    B=16, bf16), each with its bound; and for the roles that carry
    gradients, the plain backward recompute (``reference_attention`` forward
    + autograd backward, what ``FusedAttentionFn.backward`` runs) per
    call."""
    rows = []
    for role, q, k, v, bias, mask, causal, scale in shapes:
        kernel = lambda: fa.fused_attention(q, k, v, bias, mask, causal, scale)
        plain = lambda: attn_mod.reference_attention(q, k, v, bias, mask, causal, scale)
        library = _sdpa(q, k, v, bias, mask, scale, causal)
        b, h, lq, d = q.shape
        lk = k.shape[2]
        # a causal call needs the lower triangle only
        pairs = lq * (lq + 1) // 2 if causal else lq * lk
        moved = q.element_size() * (2 * b * h * lq * d + 2 * b * h * lk * d)
        moved += sum(0 if t is None else t.numel() * 4 for t in (bias, mask))
        bound_ms, bound_by = _bound(moved, 4 * b * h * pairs * d)
        row = {"shape": role, "q": list(q.shape), "lk": lk, "causal": causal,
               "bias": None if bias is None else list(bias.shape), "mask": mask is not None,
               "dtype": "bfloat16", **_time("ms", kernel), **_time("plain_ms", plain),
               **_time("library_ms", library), **_split_time("", kernel),
               **_split_time("library_", library), "bound_ms": bound_ms, "bound_by": bound_by}
        if role != "vit":  # the frozen ViT runs under no_grad: no backward
            leaves = [t if t is None else t.detach().requires_grad_() for t in (q, k, v, bias)]
            wanted = [t for t in leaves if t is not None]
            g = torch.randn(b, h, lq, d, device=DEVICE).to(q.dtype)

            def recompute():
                out = attn_mod.reference_attention(*leaves, mask, causal, scale)
                torch.autograd.grad(out, wanted, g)

            row.update(_time("recompute_backward_ms", recompute, iters=10, repeats=3))
        rows.append(row)
        log(f"phase 6d: {json.dumps(row)}")
    return rows


def _recompute_backward(fn, tensors, g):
    """One plain forward of ``fn`` on fresh leaves and its autograd
    backward: what the kernels' autograd.Functions run in a backward."""
    leaves = [t.detach().requires_grad_() for t in tensors]

    def run():
        torch.autograd.grad(fn(*leaves), leaves, g)

    return run


def time_sal_train_shape() -> dict:
    """Phase 6d: the SaL kernel at the SaL encoder of a SaL-family train
    step (B=16, bf16, bf16 tables): kernel, plain, SDPA on the pre-built
    bias, its bound, and the plain recompute backward (what
    ``SalAttentionFn.backward`` runs) per call."""
    q, k, v, bias1d, cb, cell, mask = sal_serving_shape(TRAIN_BATCH, seed=36)
    kernel = lambda: sfa.sal_fused_attention(q, k, v, bias1d, cb, cell, mask)
    plain = lambda: sfa.sal_reference_attention(q, k, v, bias1d, cb, cell, mask)
    library = _sdpa(q, k, v, sfa.materialize_sal_bias(bias1d, cb, cell), mask, None)
    moved, flops = _qkvo_bytes_flops(q, k)
    moved += sum(t.numel() * t.element_size() for t in (bias1d, cb, cell, mask))
    bound_ms, bound_by = _bound(moved, flops)
    g = torch.randn(q.shape, device=DEVICE).to(q.dtype)
    recompute = _recompute_backward(
        lambda *a: sfa.sal_reference_attention(*a, cell, mask), (q, k, v, bias1d, cb), g)
    row = {"shape": "sal_encoder_train", "q": list(q.shape), "dtype": "bfloat16",
           "tables": "bfloat16", **_time("ms", kernel), **_time("plain_ms", plain),
           **_time("library_ms", library), **_split_time("", kernel),
           **_split_time("library_", library), "library_excludes": "bias materialization",
           "bound_ms": bound_ms, "bound_by": bound_by,
           **_time("recompute_backward_ms", recompute, iters=10, repeats=3)}
    log(f"phase 6d: {json.dumps(row)}")
    return row


# -- phases 7 and 7b ----------------------------------------------------------

TRAIN_STEPS = 20  # one epoch of the synthetic fixture at batch 16
REPEAT_STEPS = 10


def latr_train_config(paths, save_path, **over) -> Config:
    """The LaTr preset (configs/latr.yaml) at full width as a dict Config,
    on the synthetic fixture: adam (0.9, 0.98), eps 1e-9, LR 5e-5 decayed
    0.95 per epoch, batch 16, answers of 128 tokens, dropout 0.1, bf16."""
    return Config({**dict(
        FULL, EXECUTOR="LaTr_Executor", MODEL_CLASS="LaTr", MODEL_MOD_CONFIG_CLASS="LaTr_config",
        backbone_name="VietAI/vit5-base", SAVE=True, SAVE_PATH=save_path, LR=5e-5,
        BETAS=[0.9, 0.98], NUM_EPOCHS=1, TRAIN_BATCH_SIZE=TRAIN_BATCH, EVAL_BATCH_SIZE=BATCH,
        PREDICT_BATCH_SIZE=BATCH, max_eval_length=MAX_ANSWER, max_predict_length=ANSWER_LEN,
        get_predict_score=True, ocr_path=paths["ocr"], base_img_path=paths["img"],
        max_ocr_element=OCR_ELEMENTS, max_ocr_length=OCR_LEN, max_q_length=Q_LEN,
        max_a_length=ANSWER_LEN, qa_train_path=paths["train"], qa_val_path=paths["val"],
        qa_predict_path=paths["predict"], dropout_rate=0.1, DTYPE="bfloat16", SEED=SEED,
    ), **over})


def train_flops(batch) -> dict:
    """Matrix-product operations of one LaTr-base train step at ``batch``
    (2 per multiply-add): the forward's linear layers (2 x parameters x the
    tokens through them), attention (4 x B x H x Lq x Lk x D; a causal call
    its lower triangle) and the tied LM head; the backward twice the
    forward of everything but the frozen ViT. The yardstick of 'Where the
    time goes' in PERF.md."""
    d, ff, h, dk, vocab = (T5_BASE[k] for k in ("d_model", "d_ff", "num_heads", "d_kv",
                                                 "t5_vocab_size"))
    n_enc, n_dec = T5_BASE["num_encoder_layers"], T5_BASE["num_t5_decoder_layers"]
    hv, mlp, n_vit = FULL["vit_hidden_size"], FULL["vit_mlp_dim"], FULL["vit_num_layers"]
    lv, patches = 197, 196
    att = lambda lq, lk, causal=False: 4 * batch * h * dk * (lq * (lq + 1) // 2 if causal
                                                              else lq * lk)
    vit = 2 * batch * (patches * 3 * 16 * 16 * hv + lv * n_vit * (4 * hv * hv + 2 * hv * mlp))
    vit += n_vit * att(lv, lv)
    enc = 2 * batch * (lv * hv * d + ENC_L * n_enc * (4 * d * d + 3 * d * ff))
    enc += n_enc * att(ENC_L, ENC_L)
    dec = 2 * batch * n_dec * (DEC_L * (4 * d * d + 2 * d * d + 3 * d * ff) + ENC_L * 2 * d * d)
    dec += n_dec * (att(DEC_L, DEC_L, True) + att(DEC_L, ENC_L)) + 2 * batch * DEC_L * d * vocab
    forward = vit + enc + dec
    return {"forward_tflop": forward / 1e12, "vit_tflop": vit / 1e12,
            "step_tflop": (forward + 2 * (enc + dec)) / 1e12}


def profile_train(ex, batches) -> dict:
    """``ex.train_step`` over ``batches`` under torch.profiler: device busy
    ms per step (sum of CUDA kernel times), device kernel launches per step,
    the attention kernel's device ms and launches per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            ex.train_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = len(batches)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    ours = [e for e in kernels if "attn::attention_" in e.key]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "profiled_ms_per_step": 1e3 * wall / n,
        "device_busy_ms_per_step": sum(e.self_device_time_total for e in kernels) / 1e3 / n,
        "device_kernel_launches_per_step": sum(e.count for e in kernels) / n,
        "attention_kernel_ms_per_step": sum(e.self_device_time_total for e in ours) / 1e3 / n,
        "attention_kernel_launches_per_step": sum(e.count for e in ours) / n,
        "top_kernels_ms_per_step": {e.key[:90]: e.self_device_time_total / 1e3 / n for e in top},
    }


def check_losses(phase, losses) -> None:
    bad = [i for i, x in enumerate(losses) if not np.isfinite(x)]
    if bad:
        raise AssertionError(f"{phase}: non-finite loss at steps {bad}: {losses}")


@torch.no_grad()
def eval_loss(ex, batch) -> float:
    ex.model.eval()
    return float(ex._loss_from_batch(ex._to_device(batch)))


def train_fixture(root):
    """The synthetic LaTr fixture with one epoch of TRAIN_STEPS batches."""
    return synthetic.make_latr_fixture(os.path.join(root, "train"), n_images=8,
                                       n_rows=TRAIN_BATCH * TRAIN_STEPS,
                                       image_hw=FULL["vit_image_size"])


def timed_steps(ex, batches) -> float:
    """ms per step of ``ex.train_step`` over ``batches``, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches:
        check_losses("timed steps", [float(ex.train_step(batch))])
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / len(batches)


def train_and_predict(phase, title, ex_cls, config, per_step: dict, per_eval: dict,
                      extra=None) -> dict:
    """Phases 7, 8 and 9: one epoch of TRAIN_STEPS steps through ``ex_cls``
    (``train()``: the epoch, eval, last/best saves), the last checkpoint
    restored, predict into results.json (an answer tokenizer's answers free
    of special and tone tokens); then the step's cost on fixture batches: ms
    per step, the forward / backward / optimizer split, the profiler's busy
    share, peak memory; ``extra(ex, batches, out)`` adds a phase's own
    measurements; and one batch repeated REPEAT_STEPS times must lower its
    loss. ``per_step`` / ``per_eval``: each kernel's launches a train step /
    an eval or predict batch."""
    save = config.SAVE_PATH
    t0 = time.perf_counter()
    ex = ex_cls(config, "train", device=DEVICE)
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in ex.state.params.values())
    n_trainable = sum(ex.state.params[n].numel() for n in ex.state.opt_state["mu"])

    losses = []
    step = ex.train_step

    def recorded(batch):
        loss = step(batch)
        losses.append(float(loss))
        return loss

    ex.train_step = recorded
    reset_launches()
    t0 = time.perf_counter()
    ex.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    del ex.train_step
    n_eval = -(-len(ex.val_data) // BATCH)
    check_losses(phase, losses)
    if len(losses) != TRAIN_STEPS:
        raise AssertionError(f"{phase}: {len(losses)} steps, want {TRAIN_STEPS}")
    train_launches = launches()
    check_launches(f"{phase} train()", train_launches, {
        k: per_step[k] * TRAIN_STEPS + per_eval[k] * n_eval for k in KERNELS})

    restored = ex.ckpt.restore("last", DEVICE)
    if (restored["step"], restored["epoch"]) != (TRAIN_STEPS, 1) or any(
            not torch.equal(restored["params"][n], p) for n, p in ex.state.params.items()):
        raise AssertionError(f"{phase}: last_ckp does not hold the trained masters")
    if restored["opt_state"]["count"] != TRAIN_STEPS:
        raise AssertionError(f"{phase}: last_ckp's optimizer count is not the step")
    del restored
    ckpt_bytes = os.path.getsize(os.path.join(save, "last_ckp"))

    reset_launches()
    t0 = time.perf_counter()
    predictor = ex_cls(config, "predict", predicttype="best", device=DEVICE)
    results = predictor.run()
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    n_predict = -(-len(predictor.predict_data) // BATCH)
    check_launches(f"{phase} predict", launches(), {k: per_eval[k] * n_predict for k in KERNELS})
    with open(os.path.join(save, "results.json"), encoding="utf-8") as f:
        if json.load(f) != results or len(results) != len(predictor.predict_data):
            raise AssertionError(f"{phase}: results.json does not hold the predictions")
    gens = [r["gens"][0] for r in results]
    if hasattr(predictor, "decode_tokenizer") and has_special_tokens(gens):
        raise AssertionError(f"{phase}: phoneme or tone tokens in the answers {gens[:3]}")
    del predictor
    torch.cuda.empty_cache()

    batches = [b for b, _ in itertools.islice(
        batch_iterator(ex.train_data, TRAIN_BATCH, shuffle=True, seed=99, drop_last=True), 14)]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ex.train_step(batches[0])
    torch.cuda.synchronize()
    step_launches = launches()
    check_launches(f"{phase} one step", step_launches, per_step)
    step_ms = timed_steps(ex, batches[1:6])
    split = {"forward_ms": 0.0, "backward_ms": 0.0, "optimizer_ms": 0.0}
    for batch in batches[6:8]:
        tb = ex._to_device(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = ex.forward_loss(tb)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ex.apply_gradients()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[key] += 1e3 * dt / 2
        check_losses(f"{phase} split", [float(loss.detach())])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_train(ex, batches[:3])
    out = {
        "params_m": n_params / 1e6, "trainable_m": n_trainable / 1e6, "setup_s": setup_s,
        "train_epoch_s": train_s, "steps": TRAIN_STEPS, "losses": losses, "eval_batches": n_eval,
        "train_launches": train_launches, "predict_s": predict_s,
        "predict_answers": [g[:60] for g in gens[:3]], "checkpoint_gb": ckpt_bytes / 1e9,
        "launches_per_step": step_launches, "launches_per_eval_batch": per_eval, "ms_per_step": step_ms,
        "samples_per_s": 1e3 * TRAIN_BATCH / step_ms, **split, "peak_memory_gb": peak_gb, **prof,
        "device_busy_share": prof["device_busy_ms_per_step"] / step_ms,
    }
    if extra is not None:
        extra(ex, batches, out)

    batch = batches[0]
    lr = ex._lr_schedule(ex.state.step)
    before = eval_loss(ex, batch)
    repeat = [float(ex.train_step(batch)) for _ in range(REPEAT_STEPS)]
    after = eval_loss(ex, batch)
    check_losses(f"{phase} repeated batch", repeat)
    if not after < before:
        raise AssertionError(f"{phase}: {REPEAT_STEPS} steps on one batch at LR {lr} did not "
                             f"lower its loss: {before} -> {after} ({repeat})")
    out.update(repeat_lr=lr, repeat_eval_loss=[before, after], repeat_train_losses=repeat)
    log(f"{phase}: {title} trained {TRAIN_STEPS} steps at batch {TRAIN_BATCH} (bf16 compute, "
        f"f32 masters, {n_trainable / 1e6:.1f}M trainable of {n_params / 1e6:.1f}M): "
        f"{step_ms:.3f} ms/step, {out['samples_per_s']:.3f} samples/s; split {json.dumps(split)}; "
        f"busy share {out['device_busy_share']:.3f}; attention kernel "
        f"{prof['attention_kernel_ms_per_step']:.3f} ms/step in "
        f"{prof['attention_kernel_launches_per_step']:.0f} launches (counted {per_step}); peak "
        f"{peak_gb:.2f} GB; checkpoint {ckpt_bytes / 1e9:.2f} GB; one batch x {REPEAT_STEPS} at "
        f"LR {lr:.3e}: eval loss {before:.4f} -> {after:.4f}; answers {gens[:3]}")
    log(f"{phase}: {json.dumps(out)}")
    del ex
    torch.cuda.empty_cache()
    return out



def train_latr(paths, recompute_ms_per_step) -> dict:
    """Phase 7 (see the module docstring): ``train_and_predict`` with the
    step's matrix-product operations and its share of the bf16 peak."""
    # every ViT, T5 encoder, decoder self- and cross-attention layer: 48
    encode = FULL["vit_num_layers"] + T5_BASE["num_encoder_layers"]
    per_step = {"flash_attention": encode + 2 * T5_BASE["num_t5_decoder_layers"],
                "sal_fused_attention": 0}
    per_eval = {"flash_attention": encode, "sal_fused_attention": 0}  # 24

    def extra(ex, batches, out):
        flops = train_flops(TRAIN_BATCH)
        out.update(recompute_backward_ms_per_step=recompute_ms_per_step,
                   recompute_share_of_step=recompute_ms_per_step / out["ms_per_step"], **flops,
                   share_of_bf16_peak=flops["step_tflop"] / (out["ms_per_step"] * 1e-3
                                                             * BF16_FLOP_PER_S / 1e12))
        log(f"phase 7: plain backward recompute {recompute_ms_per_step:.3f} ms/step; "
            f"{flops['step_tflop']:.3f} TFLOP/step = {out['share_of_bf16_peak']:.4f} of the bf16 "
            f"peak")

    return train_and_predict("phase 7", "LaTr-base", LaTrExecutor,
                             latr_train_config(paths, os.path.join(paths["root"], "ckpts")),
                             per_step, per_eval, extra)


def noisy_attention(generator):
    """``plain_attention`` with every output scaled by (1 + NOISE x N(0, 1)):
    the plain path disturbed by as much as the f32 kernel parts from it."""

    def attention(q, k, v, bias=None, key_mask=None, causal=False, scale=None):
        out = plain_attention(q, k, v, bias, key_mask, causal, scale)
        return out * (1 + NOISE * torch.randn(out.shape, generator=generator, device=out.device))

    return attention


class attention_error_measured:
    """Within the block every model's attention runs as usual (the kernel
    dispatch), and each call's output is also held against the plain path on
    the same inputs: ``worst`` maps each attention-using module to the
    largest relative difference ||kernel - plain|| / ||plain|| of a call."""

    def __enter__(self):
        self.worst, self.saved = {}, [m.dot_product_attention for m in ATTENTION_USERS]
        for m, fn in zip(ATTENTION_USERS, self.saved):
            name = m.__name__.rsplit(".", 1)[-1]

            def measured(*args, fn=fn, name=name, **kw):
                out = fn(*args, **kw)
                with torch.no_grad():
                    want = plain_attention(*args, **kw).float()
                    err = float((out.float() - want).norm() / want.norm().clamp_min(1e-30))
                self.worst[name] = max(self.worst.get(name, 0.0), err)
                return out

            m.dot_product_attention = measured
        return self

    def __exit__(self, *exc):
        for m, fn in zip(ATTENTION_USERS, self.saved):
            m.dot_product_attention = fn


def check_train_f32(phase, ex, per_step: dict, gate_grads: bool = True) -> dict:
    """Phases 7b, 8b, 9b and 9d: one f32 train step of ``ex`` (an executor
    at full width, batch 4) through the kernels (``per_step`` launches),
    then from the same state with ``plain_attention``, then with
    ``noisy_attention`` (the yardstick). Each kernel call of the step's
    forward must part from the plain path by at most KERNEL_CALL_RTOL. With
    ``gate_grads`` off the gradients' and parameters' gaps against the
    yardstick are measured and printed but not held to it; the loss, the
    per-call bound and the 2-lr bound still are."""
    # what the optimizer updates (the masters, or a LoRA run's adapters) and
    # what it holds fixed (a frozen ViT, a LoRA run's base)
    lora = ex.state.lora is not None
    start = train_state.tree_map(lambda t: t.detach().clone(), ex._ckpt_params())
    base = start["base"] if lora else start
    frozen = set(base) - set(ex._trainable)
    batch, _ = next(batch_iterator(ex.train_data, 4))
    lr = ex._lr_schedule(0)

    def restore():
        ex.load_params(base, **({"lora": start["lora"]} if lora else {}))
        ex.state.step = 0

    def one_step(attention=None):
        if attention is None:
            return _one_step()
        with attention_replaced(attention):
            return _one_step()

    def _one_step():
        restore()
        loss = ex.forward_loss(ex._to_device(batch))
        loss.backward()
        grads = ex._collect_grads()
        kept = {n: g.clone() for n, g in grads.items()}
        ex.apply_gradients(grads)
        torch.cuda.synchronize()
        for n in frozen:
            if not torch.equal(ex.state.params[n], base[n]):
                raise AssertionError(f"{phase}: the frozen {n} moved")
        return (float(loss.detach()), kept,
                {n: p.detach().clone() for n, p in ex._opt_params().items()})

    # how far the kernels part from the plain path in this step's own forward
    # (the same inputs and dropout masks)
    with attention_error_measured() as measured, torch.no_grad():
        restore()
        ex.forward_loss(ex._to_device(batch))
    loose = {m: e for m, e in measured.worst.items() if not e <= KERNEL_CALL_RTOL}
    if not measured.worst or loose:
        raise AssertionError(f"{phase}: kernel calls part from the plain path by {loose} of "
                             f"their norm (at most {KERNEL_CALL_RTOL}; by module {measured.worst})")
    reset_launches()
    k_loss, k_grads, k_params = one_step()
    check_launches(phase, launches(), per_step)
    reset_launches()
    p_loss, p_grads, p_params = one_step(plain_attention)
    n_loss, n_grads, n_params = one_step(
        noisy_attention(torch.Generator(device=DEVICE).manual_seed(SEED)))
    check_launches(phase, launches(), {name: 0 for name in KERNELS})
    loss_err = abs(k_loss - p_loss) / abs(p_loss)
    if not loss_err <= LOSS_RTOL:
        raise AssertionError(f"{phase}: loss {k_loss} vs plain {p_loss}")

    def gap(grads):  # a gradient that is 0 on every path (a LoRA run's a at b = 0) gaps 0
        return {n: float((grads[n] - g).norm() / g.norm().clamp_min(1e-30))
                for n, g in p_grads.items()}

    rel, noise = gap(k_grads), gap(n_grads)
    for n in rel:
        if gate_grads and not rel[n] <= GRAD_NOISE_FACTOR * noise[n] + GRAD_FLOOR:
            raise AssertionError(f"{phase}: the gradient of {n} parts from the plain path by "
                                 f"{rel[n]:.3e} of its norm, the noisy plain path by {noise[n]:.3e} "
                                 f"(kernel error by module {measured.worst})")
    far, n_entries = {"kernel": 0, "noisy": 0}, 0
    for n, p in p_params.items():
        # p +- lr rounds to f32: up to an ulp of p on each side
        bound = 2 * lr + 2 * torch.finfo(torch.float32).eps * p.abs()
        for key, params in (("kernel", k_params), ("noisy", n_params)):
            diff = (params[n] - p).abs()
            if not bool((diff <= bound).all()):
                raise AssertionError(f"{phase}: {key} {n} parts by {float(diff.max())} > 2 lr")
            far[key] += int((diff > 0.01 * lr).sum())
        n_entries += p.numel()
    if gate_grads and not far["kernel"] <= GRAD_NOISE_FACTOR * far["noisy"] + 100:
        raise AssertionError(f"{phase}: {far} of {n_entries} parameters part by > lr/100")
    ratio = {n: rel[n] / max(noise[n], 1e-12) for n in rel}
    worst, worst_ratio = max(rel, key=rel.get), max(ratio, key=ratio.get)
    out = {"loss_kernel": k_loss, "loss_plain": p_loss, "loss_noisy": n_loss,
           "loss_rel_err": loss_err, "grads_gated": gate_grads,
           "dropout_rate": float(ex.config.dropout_rate),
           "worst_grad_gap": [worst, rel[worst], noise[worst]],
           "worst_grad_gap_over_noise": [worst_ratio, ratio[worst_ratio], rel[worst_ratio],
                                         noise[worst_ratio]],
           "params_parted_over_lr_100": far, "param_entries": n_entries, "lr": lr,
           "kernel_rel_err_by_module": measured.worst, "noise": NOISE,
           "grads_compared": len(rel), "vit_grads_compared": sum(n.startswith("vit.") for n in rel),
           "frozen_tensors": len(frozen), "lora": lora}
    allowed = f"allowed {GRAD_NOISE_FACTOR}" if gate_grads else "measured, not gated"
    log(f"{phase}: f32 train step (batch 4, dropout {out['dropout_rate']}) kernels vs plain "
        f"(kernel calls part from the plain path by at most {json.dumps(measured.worst)} of "
        f"their norm, allowed {KERNEL_CALL_RTOL}; yardstick noise {NOISE:.0e}): "
        f"loss {k_loss:.6f} vs {p_loss:.6f} "
        f"(rel err {loss_err:.2e}, tol {LOSS_RTOL}; noisy plain {n_loss:.6f}); the widest "
        f"gradient gap {worst} {rel[worst]:.2e} of its norm (noisy plain {noise[worst]:.2e}); "
        f"kernel gap over noisy gap at most {ratio[worst_ratio]:.3f} ({worst_ratio}; {allowed}); "
        f"after the adam step at LR {lr:.1e} every parameter within 2 lr, "
        f"{far['kernel']} of {n_entries} entries part by more than lr/100 ({far['noisy']} for "
        f"the noisy plain path); {len(rel)} gradients compared ({out['vit_grads_compared']} of "
        f"the ViT), {len(frozen)} frozen tensors unmoved")
    log(f"{phase}: {json.dumps(out)}")
    del ex
    torch.cuda.empty_cache()
    return out


# -- phases 8, 8b and 8c ------------------------------------------------------


def phoneme_train_config(paths, save_path, **over) -> Config:
    """The PhonemeSaL preset (configs/phonemesal.yaml) at full width as a dict
    Config, on the synthetic SaL fixture: adam (0.9, 0.98), eps 1e-9, LR 5e-5
    with the LinearLR warmup over 2000 steps, batch 16, answers of 40
    phoneme ids, eval 80 and predict 128 ids, dropout 0.1, bf16."""
    return Config({**dict(
        PSAL_FULL, EXECUTOR="PhonemeSaL_Executor", MODEL_CLASS="PhonemeSaL",
        MODEL_MOD_CONFIG_CLASS="CustomizedSaL_config", backbone_name="VietAI/vit5-base",
        SAVE=True, SAVE_PATH=save_path, LR=5e-5, BETAS=[0.9, 0.98], warmup_step=2000,
        NUM_EPOCHS=1, NUM_FREEZE_EPOCH=0, TRAIN_BATCH_SIZE=TRAIN_BATCH, EVAL_BATCH_SIZE=BATCH,
        PREDICT_BATCH_SIZE=BATCH, max_eval_length=80, max_predict_length=128,
        get_predict_score=True, max_ocr_element=SAL_OCR_ELEMENTS,
        max_ocr_length=SAL_FULL["max_ocr_length"], max_obj_element=SAL_OBJ_ELEMENTS,
        max_obj_length=SAL_OBJ_LEN, max_q_length=SAL_FULL["max_q_length"],
        max_a_length=PSAL_ANSWER, base_ocr_feature_path=paths["ocr_features"],
        base_obj_feature_path=paths["obj_features"], qa_train_path=paths["train"],
        qa_val_path=paths["val"], qa_predict_path=paths["predict"], context_token="<c>",
        dropout_rate=0.1, DTYPE="bfloat16", SEED=SEED,
    ), **over})


def sal_train_fixture(root):
    """The synthetic SaL fixture (its answers are the Vietnamese ones of
    ``data/synthetic.py``) with one epoch of TRAIN_STEPS batches."""
    return synthetic.make_sal_fixture(os.path.join(root, "sal_train"), n_images=8,
                                      n_rows=TRAIN_BATCH * TRAIN_STEPS,
                                      n_ocr_words=SAL_OCR_ELEMENTS,
                                      region_hidden=SAL_FULL["obj_hidden"])


def train_phoneme_sal(paths) -> dict:
    """Phase 8 (see the module docstring): ``train_and_predict``, the
    parameters by part, then 5 steps with SAL_FUSED off."""
    n_enc = T5_BASE["num_encoder_layers"]
    per_step = {"flash_attention": 2 * PSAL_FULL["num_decoder_layers"],
                "sal_fused_attention": n_enc}  # decoder self + cross; every encoder layer
    per_eval = {"flash_attention": 0, "sal_fused_attention": n_enc}

    def extra(ex, batches, out):
        parts = {}
        for name, p in ex.state.params.items():
            key = name.split(".")[0] if not name.startswith("t5.") else ".".join(
                name.split(".")[:2])
            parts[key] = parts.get(key, 0) + p.numel() / 1e6
        # SAL_FUSED off: the bias materialized once a forward, every encoder
        # layer through the attention kernel
        attn_mod.enable_sal_fused(False)
        try:
            reset_launches()
            ex.train_step(batches[8])
            torch.cuda.synchronize()
            off_launches = launches()
            check_launches("phase 8 SAL_FUSED off", off_launches, {
                "flash_attention": per_step["flash_attention"] + n_enc, "sal_fused_attention": 0})
            off_ms = timed_steps(ex, batches[9:14])
        finally:
            attn_mod.enable_sal_fused(True)
        on_ms = timed_steps(ex, batches[1:6])  # on again, after off: drift shows in the pair
        out.update(params_m_by_part=parts, sal_fused_off_launches_per_step=off_launches,
                   sal_fused_off_ms_per_step=off_ms, sal_fused_on_ms_per_step_after=on_ms)
        log(f"phase 8: SAL_FUSED off {off_ms:.3f} ms/step vs on {out['ms_per_step']:.3f} / "
            f"{on_ms:.3f} (before / after)")

    return train_and_predict("phase 8", "PhonemeSaL-base", PhonemeSaLExecutor,
                             phoneme_train_config(paths, os.path.join(paths["root"], "psal_ckpts")),
                             per_step, per_eval, extra)


# -- phases 4d, 4e, 5d, 5e and 9-9d: the PhonemeLaTr and PreSTU families ---------


def phonology_annotations(path) -> str:
    """Writes an annotation file whose words cover every onset, rhyme and
    tone that the phonology tables enumerate (every composition of onset,
    medial, nucleus, coda and tone that ``is_vietnamese_3`` accepts), beside
    the fixture's questions and answers: the structured vocabulary built
    from it gives the three heads their realistic widths."""
    words = set()
    for onset, medial, nucleus, coda, tone in itertools.product(
            (None,) + ONSETS, (None, "o", "u"), NUCLEI, (None,) + CODAS,
            (None,) + tuple(TONE_VI.values())):
        word = compose_word(onset, medial, nucleus, coda, tone)
        if word and is_vietnamese_3(word)[0]:
            words.add(word)
    words = sorted(words)
    texts = [" ".join(words[i:i + 64]) for i in range(0, len(words), 64)]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"annotations": [{"question": t} for t in
                                   texts + synthetic.QUESTIONS + synthetic.ANSWERS]},
                  f, ensure_ascii=False)
    return path


def structured_tokenizer(root):
    """(tokenizer, its vocabulary file, the annotation file): the structured
    phoneme vocabulary of phases 4d-9d, built once from
    ``phonology_annotations`` and saved (the executors load it)."""
    ann = phonology_annotations(os.path.join(root, "phonology_annotations.json"))
    vocab_path = os.path.join(root, "phoneme_vocab.json")
    tok = StructuredPhonemeTokenizer(vocab_path=vocab_path, annotation_paths=[ann])
    return tok, vocab_path, ann


def family_train_config(paths, save_path, kind, **over) -> Config:
    """The presets of the LaTr family at full width on the synthetic LaTr
    fixture (``latr_train_config``'s keys): ``kind`` "phoneme_latr"
    (configs/phonemelatr.yaml: LR 5e-5 with the LinearLR warmup over 2000
    steps, the structured vocabulary), "customized_latr"
    (customizedlatr.yaml: LR 1e-4, an answer tokenizer of up to 3000 ids),
    "prestu" (prestu.yaml), "customized_prestu" or "phoneme_prestu"."""
    decoder = dict(LATR_CUSTOM_FULL, warmup_step=2000, NUM_FREEZE_EPOCH=0)
    keys = {
        "phoneme_latr": dict(decoder, EXECUTOR="PhonemeLaTr_Executor", MODEL_CLASS="PhonemeLaTr",
                             MODEL_MOD_CONFIG_CLASS="CustomizedLaTr_config"),
        "customized_latr": dict(decoder, EXECUTOR="CustomizedLaTr_Executor",
                                MODEL_CLASS="CustomizedLaTr",
                                MODEL_MOD_CONFIG_CLASS="CustomizedLaTr_config", LR=1e-4),
        "prestu": dict(EXECUTOR="PreSTU_Executor", MODEL_CLASS="PreSTU",
                       MODEL_MOD_CONFIG_CLASS="PreSTU_config"),
        "customized_prestu": dict(decoder, EXECUTOR="CustomizedPreSTU_Executor",
                                  MODEL_CLASS="CustomizedPreSTU",
                                  MODEL_MOD_CONFIG_CLASS="CustomizedPreSTU_config", LR=1e-4),
        "phoneme_prestu": dict(decoder, EXECUTOR="PhonemePreSTU_Executor",
                               MODEL_CLASS="PhonemePreSTU",
                               MODEL_MOD_CONFIG_CLASS="CustomizedPreSTU_config"),
    }[kind]
    return latr_train_config(paths, save_path, **{**keys, **over})


class vit_grad_calls:
    """Within the block, counts the ViT's attention calls that need
    gradients (grad mode on and q requiring grad): on the card the dispatch
    sends exactly these through ``FusedAttentionFn``."""

    def __enter__(self):
        self.n, self.saved = 0, vit_mod.dot_product_attention

        def counted(q, *args, **kw):
            self.n += int(torch.is_grad_enabled() and q.requires_grad)
            return self.saved(q, *args, **kw)

        vit_mod.dot_product_attention = counted
        return self

    def __exit__(self, *exc):
        vit_mod.dot_product_attention = self.saved


def train_steps(phase, title, ex_cls, config, per_step: dict, vit_trains: bool) -> dict:
    """Phases 8c and 9c: 6 train steps of ``ex_cls`` at full width, batch 16. The
    first step's kernel launches and the ViT's ``FusedAttentionFn`` calls are
    counted; a model that trains its ViT (PreSTU) must give every ViT
    parameter optimizer state, a finite, nonzero gradient and a move, any
    other must keep its ViT without state and unmoved; ms per step of the
    other five."""
    t0 = time.perf_counter()
    ex = ex_cls(config, "train", device=DEVICE)
    setup_s = time.perf_counter() - t0
    vit = [n for n in ex.state.params if n.startswith("vit.")]
    start = {n: ex.state.params[n].clone() for n in vit}
    with_state = [n for n in vit if n in ex.state.opt_state["mu"]]
    if len(with_state) != (len(vit) if vit_trains else 0):
        raise AssertionError(f"{phase}: {len(with_state)} of {len(vit)} ViT tensors hold "
                             f"optimizer state")
    batches = [b for b, _ in itertools.islice(
        batch_iterator(ex.train_data, TRAIN_BATCH, shuffle=True, seed=97, drop_last=True), 6)]
    reset_launches()
    with vit_grad_calls() as calls:
        loss = ex.forward_loss(ex._to_device(batches[0]))
        loss.backward()
    torch.cuda.synchronize()
    step_launches = launches()
    check_launches(f"{phase} one step", step_launches, per_step)
    want_calls = FULL["vit_num_layers"] if vit_trains else 0
    if calls.n != want_calls:
        raise AssertionError(f"{phase}: {calls.n} ViT FusedAttentionFn calls, want {want_calls}")
    grads = {n: p.grad for n, p in ex.model.named_parameters() if n in start}
    bad = [n for n, g in grads.items()
           if g is None or not torch.isfinite(g).all() or not g.abs().max() > 0]
    if vit_trains and bad or not vit_trains and len(bad) != len(vit):
        raise AssertionError(f"{phase}: ViT gradients {bad[:4]} ({len(bad)} of {len(vit)})")
    ex.apply_gradients()
    losses = [float(loss.detach())]
    check_losses(phase, losses)
    ms = timed_steps(ex, batches[1:])
    moved = [n for n in vit if not torch.equal(ex.state.params[n], start[n])]
    if len(moved) != (len(vit) if vit_trains else 0):
        raise AssertionError(f"{phase}: {len(moved)} of {len(vit)} ViT tensors moved")
    n_params = sum(p.numel() for p in ex.state.params.values())
    out = {"params_m": n_params / 1e6,
           "trainable_m": sum(ex.state.params[n].numel() for n in ex.state.opt_state["mu"]) / 1e6,
           "setup_s": setup_s, "launches_per_step": step_launches, "vit_fn_calls_per_step": calls.n,
           "vit_tensors": len(vit), "vit_tensors_moved": len(moved), "ms_per_step": ms,
           "first_loss": losses[0]}
    log(f"{phase}: {title} {len(batches)} train steps at batch {TRAIN_BATCH}: {json.dumps(out)}")
    del ex
    torch.cuda.empty_cache()
    return out


# -- phases 10-13: the decode variants ----------------------------------------

SPEC_K = 4  # SPEC_DECODE of phase 11
NUM_BEAM = 4  # configs/phonemelatr.yaml, phonemesal.yaml num_beam
VARIANT_ROWS = 2 * BATCH  # phases 10-13 decode the fixture's first 64 training rows


def variant_rows(ex):
    """The first VARIANT_ROWS rows of the fixture's training split,
    featurized by the executor as its eval data is."""
    rows = synthetic.read_qa_csv(ex.config.qa_train_path)[:VARIANT_ROWS]
    return ex._make_dataset(rows, *ex._adapt_frames())


def first_device_batch(ex, dataset):
    batch, _ = next(batch_iterator(dataset, BATCH))
    return ex._device_batch(batch)


def paired_ms(fn, ref, *args, rounds=2):
    """Host-clock ms of ``fn(*args)`` and ``ref(*args)``, each ended by a
    synchronize, taken in turns (fn, ref, ref, fn) ``rounds`` times after a
    warm-up call of each, so host drift falls on both: (median ms of fn,
    median ms of ref)."""
    times = {fn: [], ref: []}
    for f in (fn, ref):
        f(*args)
    torch.cuda.synchronize()
    for _ in range(rounds):
        for f in (fn, ref, ref, fn):
            t0 = time.perf_counter()
            f(*args)
            torch.cuda.synchronize()
            times[f].append(1e3 * (time.perf_counter() - t0))
    return tuple(sorted(times[f])[len(times[f]) // 2] for f in (fn, ref))


def counted(phase, fn, *args, want: dict):
    """``fn(*args)`` with every kernel's launch count set to 0 just before
    and read, and held to ``want``, just after."""
    reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    check_launches(phase, launches(), want)
    return out


def greedy_recorded(model, tb, max_answer, with_scores=False):
    """Greedy rows (and scores) of ``tb`` and every step's logits, through
    ``build_generate_fn``."""
    seen = []
    step = model.decode_step

    def recording(tokens, cache, i, *args):
        logits, cache = step(tokens, cache, i, *args)
        seen.append(logits if isinstance(logits, tuple) else (logits,))
        return logits, cache

    model.decode_step = recording
    try:
        out = build_generate_fn(model, max_answer, with_scores)(tb)
    finally:
        del model.decode_step
    return out, seen


def step_k_logit_gap(model, tb, rows, seen, k) -> float:
    """The largest |logit| difference between ``decode_step_k`` windows of
    ``k`` tokens and the one-token steps (``seen``) on the same prefixes
    (greedy's ``rows``, teacher-forced): what rounding alone moves a logit
    by between the two step functions. In bf16 a greedy row may part from
    the other path's where its top-2 margin is within twice this gap."""
    n = rows.shape[1] - 1
    gap = 0.0
    with torch.inference_mode():
        cache, bias, mask = model.encode_for_generate(tb, rows.shape[1])
        for start in range(0, n, k):
            kk = min(k, n - start)
            pos = torch.full((rows.shape[0],), start, dtype=torch.long, device=rows.device)
            logits, cache = model.decode_step_k(rows[:, start:start + kk], cache, pos, bias, mask)
            heads = logits if isinstance(logits, tuple) else (logits,)
            for j in range(kk):
                for c, head in enumerate(heads):
                    gap = max(gap, float((head[:, j] - seen[start + j][c]).abs().max()))
    return gap


def beam_generate(model, max_answer, num_beams, with_scores=True):
    """The beam generate at any width, one included (``build_generate_fn``
    takes a width of one as greedy)."""
    if getattr(model, "decode_components", 1) == 1:
        return make_beam_generate_fn(model, max_answer, num_beams, with_scores)
    return make_multi_head_beam_generate_fn(model, max_answer, num_beams,
                                            *decode_token_ids(model), with_scores=with_scores)


class beam_gaps:
    """Within the block, the beam search's top-K choices record, for each
    batch row, the smallest gap between adjacent candidates among the top
    K+1 of every choice (both candidates finite, above NEG/2): the beam's
    near-ties."""

    def __enter__(self):
        self.saved, self.gap = beam_mod.top_k_stable, None

        def recorded(x, k):
            vals = torch.sort(x, dim=-1, descending=True, stable=True).values[..., : k + 1]
            finite = vals > beam_mod.NEG / 2
            d = torch.where(finite[..., 1:], vals[..., :-1] - vals[..., 1:], torch.inf)
            d = d.reshape(x.shape[0], -1).amin(dim=1)
            self.gap = d if self.gap is None else torch.minimum(self.gap, d)
            return self.saved(x, k)

        beam_mod.top_k_stable = recorded
        return self

    def __exit__(self, *exc):
        beam_mod.top_k_stable = self.saved


def c1_serving(phase, title, ex, max_answer, per_batch: dict, restart=None) -> dict:
    """C1: an executor whose decode is not greedy (beam search, SAMPLE)
    serves BATCH requests through the gathered engine on the card, one
    batch through its eager decode: the rows equal ``ex.infer``'s on the
    same requests (``restart()`` before each: a sampled decode's call
    counter starts again), ``per_batch`` launches counted; the decode that
    ``stats()`` names."""
    reqs = requests(BATCH)
    dataset = request_dataset(ex, reqs)
    ex._decode_rows = lambda rows: rows
    try:
        if restart:
            restart()
        want = ex.infer(dataset, BATCH, max_answer)
        if restart:
            restart()
        with ServingEngine(ex, *ex.serve_frames, batch_size=BATCH, max_wait_ms=50,
                           max_answer_length=max_answer, warmup=False) as engine:
            reset_launches()
            t0 = time.perf_counter()
            got = answer_all(engine, reqs)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            got_launches = launches()
            stats = engine.stats()
    finally:
        del ex._decode_rows
    check_launches(f"{phase} C1 {title}", got_launches, per_batch)
    if stats["batches"] != 1 or stats["decode"] != "eager":
        raise AssertionError(f"{phase} C1 {title}: {stats['batches']} batches, decode "
                             f"{stats['decode']!r} (want one eager batch)")
    if got != want:
        bad = sum(g != w for g, w in zip(got, want))
        raise AssertionError(f"{phase} C1 {title}: {bad} served rows differ from infer's")
    out = {"decode": stats["decode"], "decode_reason": stats["decode_reason"],
           "requests": BATCH, "rows_equal_infer": True, "ms_batch_served": ms,
           "launches": got_launches}
    log(f"{phase} C1: {title} served through the gathered engine on the card ({card_line()}): "
        f"decode {stats['decode_reason']!r}; {BATCH} rows equal executor.infer's, one batch, "
        f"{ms:.3f} ms submit to answer, launches {got_launches}")
    return out


def beam_phase(title, make_ex, max_answer, per_batch: dict, serve_c1: bool = False) -> dict:
    """Phase 10 for one model (see the module docstring). ``make_ex(dtype)``:
    the executor with ``isgreedy: false, num_beam: 4``; ``serve_c1``: then
    C1 on the bf16 executor."""
    phase = "phase 10"
    ex = make_ex("bfloat16")
    tb = first_device_batch(ex, variant_rows(ex))
    beam = ex._get_generate_fn(max_answer, True)
    rows, scores = counted(f"{phase} {title} beam", beam, tb, want=per_batch)
    if not torch.isfinite(scores).all():
        raise AssertionError(f"{phase}: {title}: non-finite beam scores")
    greedy_fn = build_generate_fn(ex.model, max_answer, True)
    beam_ms, greedy_ms = paired_ms(beam, greedy_fn, tb)
    torch.cuda.reset_peak_memory_stats()
    beam(tb)
    beam_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    greedy_fn(tb)
    greedy_peak = torch.cuda.max_memory_allocated() / 1e9
    (g_rows, g_scores), g_seen = greedy_recorded(ex.model, tb, max_answer, True)
    one_rows, _ = beam_generate(ex.model, max_answer, 1)(tb)
    one_parted, _ = tie_parted(f"{phase} {title} beam of one", one_rows.tolist(), g_rows.tolist(),
                               g_seen)
    beat = int((scores > g_scores).sum())
    profiled = profile_generate(beam, tb, beam_ms)
    c1 = c1_serving(phase, title, ex, max_answer, per_batch) if serve_c1 else None
    del ex
    torch.cuda.empty_cache()

    # f32: beam through the kernels against beam through the plain path
    ex = make_ex("float32")
    beam = ex._get_generate_fn(max_answer, True)
    tb = first_device_batch(ex, variant_rows(ex))
    k_rows, k_scores = counted(f"{phase} {title} f32 beam", beam, tb, want=per_batch)
    with attention_replaced(plain_attention), beam_gaps() as gaps:
        p_rows, p_scores = counted(f"{phase} {title} f32 plain beam", beam, tb,
                                   want={name: 0 for name in KERNELS})
    same = (k_rows == p_rows).reshape(BATCH, -1).all(dim=1)
    parted = int((~same).sum())
    if parted and float(gaps.gap[~same].max()) > TIE_MARGIN:
        raise AssertionError(f"{phase}: {title}: f32 beam rows part from the plain path's away "
                             f"from a near-tie (gaps {gaps.gap[~same].tolist()})")
    score_err = float((k_scores - p_scores)[same].abs().max())
    if score_err > 1e-4:
        raise AssertionError(f"{phase}: {title}: f32 beam scores {score_err:.3e} from plain")
    del ex
    torch.cuda.empty_cache()
    out = {"ms_per_batch": beam_ms, "greedy_ms_per_batch": greedy_ms,
           "peak_memory_gb": beam_peak, "greedy_peak_memory_gb": greedy_peak,
           "rows_beating_greedy_score": beat, "beam_of_one_rows_parted": one_parted,
           "f32_rows_parted": parted, "f32_score_max_abs_err": score_err,
           "launches_per_batch": per_batch, **profiled,
           **({"c1_served": c1} if c1 is not None else {})}
    log(f"{phase}: {title} beam {NUM_BEAM} at B={BATCH} (bf16, {card_line()}): {beam_ms:.3f} "
        f"ms/batch against "
        f"greedy {greedy_ms:.3f}; peak {beam_peak:.2f} GB against {greedy_peak:.2f}; "
        f"{beat}/{BATCH} rows beat greedy's score; launches {per_batch} a batch; a beam of one "
        f"parts from greedy in {one_parted} rows (near-ties); f32 kernels vs plain: "
        f"{BATCH - parted}/{BATCH} rows identical, scores within {score_err:.3e}; "
        f"{json.dumps(out)}")
    return out


def speculative_phase(paths, root) -> dict:
    """Phase 11 (see the module docstring): LaTr-base with SPEC_DECODE 4."""
    phase = "phase 11"
    encode = {"flash_attention": FULL["vit_num_layers"] + T5_BASE["num_encoder_layers"],
              "sal_fused_attention": 0}
    out = {}
    for dtype in ("float32", "bfloat16"):
        ex = LaTrExecutor(latr_train_config(paths, os.path.join(root, f"spec_{dtype}"),
                                            DTYPE=dtype, SAVE=False, SPEC_DECODE=SPEC_K),
                          "train", device=DEVICE)
        model = ex.model.eval()  # no dropout in the direct decode calls below
        tb = first_device_batch(ex, variant_rows(ex))
        with torch.inference_mode():
            g_rows, g_seen = greedy_recorded(model, tb, MAX_ANSWER)
        step_k = model.decode_step_k
        trips, positions = [], []

        def counting(tokens, cache, pos, *args):
            trips.append(1)
            positions.append(pos.clone())
            return step_k(tokens, cache, pos, *args)

        spec = ex._get_generate_fn(MAX_ANSWER)
        # f32: the near-tie rule; bf16: twice the measured gap between the
        # window step and the one-token step on greedy's prefixes
        gap = step_k_logit_gap(model, tb, g_rows, g_seen, SPEC_K)
        allowed = TIE_MARGIN if dtype == "float32" else max(TIE_MARGIN, 2 * gap)
        model.decode_step_k = counting
        try:
            s_rows = counted(f"{phase} {dtype} prompt lookup", spec, tb, want=encode)
            lookup_trips, lookup_pos = len(trips), positions[:]
            parted, margin = tie_parted(f"{phase} {dtype} prompt lookup", s_rows.tolist(),
                                        g_rows.tolist(), g_seen, margin_allowed=allowed)
            emitted = [(row.index(1) if 1 in row[1:] else MAX_ANSWER - 1) for row in
                       g_rows.tolist()]
            active = [sum(int(p[r]) < emitted[r] for p in lookup_pos) for r in range(BATCH)]
            accepted = sum(emitted) - sum(active)
            res = {"rows_parted_from_greedy": parted, "largest_margin_at_parting": margin,
                   "step_k_logit_gap": gap, "margin_allowed": allowed,
                   "trips": lookup_trips, "greedy_steps": max(emitted),
                   "drafts_accepted": accepted, "drafts_made": (SPEC_K - 1) * sum(active),
                   "acceptance": accepted / max((SPEC_K - 1) * sum(active), 1)}
            if dtype == "float32":
                # the oracle: drafts read from greedy's own rows, every one right
                oracle_rows = g_rows.clone()

                def oracle(rows, pos):
                    idx = (pos[:, None] + 1 + torch.arange(SPEC_K - 1, device=DEVICE)).clamp(
                        max=MAX_ANSWER - 1)
                    return oracle_rows.gather(1, idx)

                trips.clear()
                with torch.inference_mode():
                    cache, bias, mask = model.encode_for_generate(tb, MAX_ANSWER)
                    o_rows = speculative_greedy_decode(
                        lambda t, c, p: model.decode_step_k(t, c, p, bias, mask), oracle, cache,
                        BATCH, MAX_ANSWER, SPEC_K, *decode_token_ids(model), DEVICE)
                o_parted, _ = tie_parted(f"{phase} oracle", o_rows.tolist(), g_rows.tolist(),
                                         g_seen)
                want_trips = max(-(-n // SPEC_K) for n in emitted)
                if not o_parted and len(trips) != want_trips:
                    raise AssertionError(f"{phase}: oracle drafts took {len(trips)} trips for "
                                         f"{max(emitted)} tokens, want {want_trips}")
                res.update(oracle_trips=len(trips), oracle_want_trips=want_trips,
                           oracle_rows_parted=o_parted)
                # one window of SPEC_K tokens against SPEC_K one-token steps
                with torch.inference_mode():
                    cache, bias, mask = model.encode_for_generate(tb, MAX_ANSWER)
                    ones = {n: v.clone() for n, v in cache.items()}
                    steps = []
                    for i in range(SPEC_K):
                        logits, ones = model.decode_step(g_rows[:, i], ones, i, bias, mask)
                        steps.append(logits)
                    window, _ = step_k(g_rows[:, :SPEC_K], cache,
                                       torch.zeros(BATCH, dtype=torch.long, device=DEVICE), bias,
                                       mask)
                want = torch.stack(steps, 1)
                rel = float((window - want).norm() / want.norm())
                if rel > 1e-4:
                    raise AssertionError(f"{phase}: a {SPEC_K}-token window parts from its "
                                         f"one-token steps by {rel:.3e} (relative)")
                res["window_vs_steps_rel_err"] = rel
            else:
                greedy_fn = build_generate_fn(model, MAX_ANSWER)
                spec_ms, greedy_ms = paired_ms(spec, greedy_fn, tb)
                res.update(ms_per_batch=spec_ms, greedy_ms_per_batch=greedy_ms,
                           **profile_generate(spec, tb, spec_ms))
        finally:
            del model.decode_step_k
        out[dtype] = res
        del ex, model
        torch.cuda.empty_cache()
    log(f"{phase}: LaTr-base SPEC_DECODE {SPEC_K} at B={BATCH} ({card_line()}): f32 window vs "
        f"one-token steps "
        f"{out['float32']['window_vs_steps_rel_err']:.3e}; oracle drafts "
        f"{out['float32']['oracle_trips']} trips (want {out['float32']['oracle_want_trips']}); "
        f"prompt lookup identical to greedy in f32 but for {out['float32']['rows_parted_from_greedy']}"
        f" rows, in bf16 but for {out['bfloat16']['rows_parted_from_greedy']} (near-ties); bf16 "
        f"{out['bfloat16']['ms_per_batch']:.3f} ms/batch in {out['bfloat16']['trips']} trips "
        f"against greedy {out['bfloat16']['greedy_ms_per_batch']:.3f} in "
        f"{out['bfloat16']['greedy_steps']} steps, acceptance "
        f"{out['bfloat16']['acceptance']:.3f}; {json.dumps(out)}")
    return out


def pool_phase(title, make_ex, per_batch: dict) -> dict:
    """Phase 12 for one model (see the module docstring). ``make_ex(dtype)``:
    the executor with ``EVAL_SLOTS: 32``."""
    phase = "phase 12"
    out = {}
    for dtype in ("float32", "bfloat16"):
        ex = make_ex(dtype)
        dataset = variant_rows(ex)
        batch_answers = ex.infer(dataset, BATCH, MAX_ANSWER)
        seen, rows, gap = [], [], 0.0
        for batch, _ in batch_iterator(dataset, BATCH):
            tb = ex._device_batch(batch)
            with torch.inference_mode():
                r, s = greedy_recorded(ex.model, tb, MAX_ANSWER)
            gap = max(gap, step_k_logit_gap(ex.model.eval(), tb, r, s, 1))
            rows.append(r.tolist())
            seen.append(s)
        # f32: the near-tie rule; bf16: twice the measured gap between the
        # K=1 window step and the one-token step on greedy's prefixes
        allowed = TIE_MARGIN if dtype == "float32" else max(TIE_MARGIN, 2 * gap)
        ex.config.update(EVAL_CONTINUOUS=True, EVAL_SLOTS=BATCH)
        if not ex._use_pool_decode():
            raise AssertionError(f"{phase}: {title}: EVAL_CONTINUOUS did not route to the pool")
        n_batches = VARIANT_ROWS // BATCH
        pool_answers = counted(f"{phase} {title} {dtype}", ex.infer, dataset, BATCH, MAX_ANSWER,
                               want={k: n * n_batches for k, n in per_batch.items()})

        def infer_with(pool: bool):
            ex.config["EVAL_CONTINUOUS"] = pool
            return ex.infer(dataset, BATCH, MAX_ANSWER)

        pool_ms, batch_ms = paired_ms(lambda: infer_with(True), lambda: infer_with(False))
        ex.config["EVAL_CONTINUOUS"] = True
        pool_rows, _ = ex._infer_pool(dataset, BATCH, MAX_ANSWER, False)
        parted = sum(tie_parted(f"{phase} {title} {dtype}", pool_rows[j * BATCH:(j + 1) * BATCH],
                                rows[j], seen[j], margin_allowed=allowed)[0]
                     for j in range(n_batches))
        if dtype == "float32" and pool_answers != batch_answers:
            raise AssertionError(f"{phase}: {title}: f32 pool answers differ from the batch "
                                 f"decode's")
        out[dtype] = {"ms_per_batch": pool_ms * BATCH / VARIANT_ROWS,
                      "batch_path_ms_per_batch": batch_ms * BATCH / VARIANT_ROWS,
                      "rows_parted": parted, "answers_equal": pool_answers == batch_answers,
                      "step_k_logit_gap": gap, "margin_allowed": allowed}
        del ex
        torch.cuda.empty_cache()
    log(f"{phase}: {title} EVAL_CONTINUOUS over {VARIANT_ROWS} rows, EVAL_SLOTS {BATCH} "
        f"({card_line()}): bf16 "
        f"{out['bfloat16']['ms_per_batch']:.3f} ms a batch of {BATCH} against the batch path's "
        f"{out['bfloat16']['batch_path_ms_per_batch']:.3f} (random weights: every row runs "
        f"{MAX_ANSWER - 1} steps, so the pool saves no step); answers identical in f32, bf16 "
        f"rows parted {out['bfloat16']['rows_parted']} (near-ties); {json.dumps(out)}")
    return out


def sampling_phase(paths, root) -> dict:
    """Phase 13 (see the module docstring): LaTr-base sampling and
    PREDICT_SCORES through ``LaTrExecutor``."""
    phase = "phase 13"
    encode = {"flash_attention": FULL["vit_num_layers"] + T5_BASE["num_encoder_layers"],
              "sal_fused_attention": 0}
    save = os.path.join(root, "sample")
    ex = LaTrExecutor(latr_train_config(paths, save, SAVE=False, SAMPLE=True, TEMPERATURE=0.0),
                      "train", device=DEVICE)
    model = ex.model
    dataset = variant_rows(ex)
    tb = first_device_batch(ex, dataset)
    greedy = build_generate_fn(model, MAX_ANSWER)(tb)

    def sampled(**knobs):
        ex.config.update(knobs)
        ex._generate_fns.clear()
        return ex._get_generate_fn(MAX_ANSWER)

    for knobs in (dict(TEMPERATURE=0.0), dict(TEMPERATURE=1.0, TOP_K=1)):
        got = counted(f"{phase} {knobs}", sampled(**knobs), tb, want=encode)
        if not torch.equal(got, greedy):
            raise AssertionError(f"{phase}: SAMPLE with {knobs} is not greedy")
    generate = sampled(TEMPERATURE=1.0, TOP_K=5)
    steps = []
    step = model.decode_step

    def recording(tokens, cache, i, *args):
        logits, cache = step(tokens, cache, i, *args)
        steps.append(logits)
        return logits, cache

    model.decode_step = recording
    try:
        first = generate(tb)
        first_steps, steps[:] = steps[:], []
        second = generate(tb)
    finally:
        del model.decode_step
    again = sampled()(tb)  # a new generate: its call counter starts again from SEED
    if not torch.equal(again, first):
        raise AssertionError(f"{phase}: the same SEED drew other tokens")
    if torch.equal(second, first):
        raise AssertionError(f"{phase}: two calls drew the same tokens")
    outside = 0
    done = torch.zeros(BATCH, dtype=torch.bool, device=DEVICE)
    for i, logits in enumerate(first_steps):
        tok = first[:, i + 1]
        top5 = logits.topk(5, dim=-1).indices
        outside += int(((top5 != tok[:, None]).all(-1) & ~done).sum())
        done |= tok == 1
    if outside:
        raise AssertionError(f"{phase}: {outside} sampled tokens outside the top 5")
    sample_ms, greedy_ms = paired_ms(generate, build_generate_fn(model, MAX_ANSWER), tb)
    c1 = c1_serving(phase, "LaTr-base SAMPLE (TOP_K 5)", ex, MAX_ANSWER, encode,
                    restart=ex._generate_fns.clear)

    # PREDICT_SCORES through predict(), on the model's seeded weights (no checkpoint)
    ex.config.update(SAMPLE=False, PREDICT_SCORES=True, get_predict_score=False,
                     SAVE_PATH=save, PREDICT_BATCH_SIZE=BATCH, max_predict_length=MAX_ANSWER)
    ex._generate_fns.clear()
    ex.mode, ex.predict_data = "predict", dataset
    ex._load_trained_checkpoint = lambda loadtype: None
    os.makedirs(save, exist_ok=True)
    results = counted(f"{phase} PREDICT_SCORES", ex.predict,
                      want={k: n * (VARIANT_ROWS // BATCH) for k, n in encode.items()})
    want = []
    for batch, _ in batch_iterator(dataset, BATCH):
        _, s = build_generate_fn(model, MAX_ANSWER, True)(ex._device_batch(batch))
        want.extend(torch.exp(s.double()).tolist())
    conf_err = max(abs(r["confidence"] - w) for r, w in zip(results, want))
    if len(results) != VARIANT_ROWS or conf_err > 1e-6:
        raise AssertionError(f"{phase}: PREDICT_SCORES confidences {conf_err:.3e} from greedy's")
    with open(os.path.join(save, "results.json"), encoding="utf-8") as f:
        if json.load(f) != results:
            raise AssertionError(f"{phase}: results.json does not hold the confidences")
    out = {"sample_ms_per_batch": sample_ms, "greedy_ms_per_batch": greedy_ms,
           "confidence_max_abs_err": conf_err, "confidences": [r["confidence"] for r in
                                                               results[:3]],
           "launches_per_batch": encode, "c1_served": c1}
    del ex, model
    torch.cuda.empty_cache()
    log(f"{phase}: LaTr-base SAMPLE ({card_line()}): TEMPERATURE 0 and TOP_K 1 give greedy's "
        f"tokens; SEED "
        f"reproducible, calls differ, TOP_K 5 draws within the top 5; {sample_ms:.3f} ms/batch "
        f"against greedy {greedy_ms:.3f}; PREDICT_SCORES confidences within {conf_err:.3e} of "
        f"exp(greedy's scores); {json.dumps(out)}")
    return out



# -- phases 14-17: the online serving engines ----------------------------------

FUTURE_TIMEOUT = 300  # seconds a request may take before the run fails
FLOOD_REQUESTS = 128
CLIENTS = 8
LONE_REQUESTS = 16
BUCKETS = [1, 4, BATCH]
BUSY_REQUESTS = 64  # the flood window the profiler traces
CONT_REQUESTS = 128
# phase 15's grid: decode steps a dispatch x rows a prefill, at BATCH slots
# (horizon 16 was never the best point: dropped to keep the script's time)
CONT_GRID = [(h, 16) for h in (4, 8)]
STALL_TIMEOUT_S = 2.0


def percentile(values, p):
    v = sorted(values)
    return v[min(len(v) - 1, int(p * len(v)))]


def flood(engine, reqs, clients=CLIENTS):
    """``reqs`` submitted from ``clients`` threads at once, each submitting
    its share back to back: (answers in request order, wall s, each
    request's submit -> resolution ms)."""
    answers, done_at, sent_at = [None] * len(reqs), [None] * len(reqs), [None] * len(reqs)
    errors = []

    def client(k):
        try:
            futures = []
            for j in range(k, len(reqs), clients):
                sent_at[j] = time.perf_counter()
                f = engine.submit(*reqs[j])
                f.add_done_callback(lambda _, j=j: done_at.__setitem__(j, time.perf_counter()))
                futures.append((j, f))
            for j, f in futures:
                answers[j] = f.result(timeout=FUTURE_TIMEOUT)
        except Exception as e:  # reported on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * FUTURE_TIMEOUT)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"flood: a client failed: {errors[:1]}")
    return answers, wall, [1e3 * (d - s) for d, s in zip(done_at, sent_at)]


def lone_latencies(engine, reqs, n=LONE_REQUESTS):
    """ms of ``n`` requests sent one at a time (each waits for the last)."""
    out = []
    for i, q in reqs[:n]:
        t0 = time.perf_counter()
        engine.answer(i, q, timeout=FUTURE_TIMEOUT)
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def flood_busy_share(engine, reqs) -> dict:
    """The device's busy share of a flood window: CUDA kernel time under
    torch.profiler over the host-clock wall of the same flood unprofiled
    (the profiler's own cost stretches the traced wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, wall, _ = flood(engine, reqs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        flood(engine, reqs)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"flood_window_requests": len(reqs), "flood_window_ms": 1e3 * wall,
            "device_busy_ms": busy_ms, "device_busy_share": busy_ms / (1e3 * wall),
            "device_kernel_launches": sum(e.count for e in kernels)}


def latency_summary(prefix, lats) -> dict:
    return {f"{prefix}_p50_ms": percentile(lats, 0.5), f"{prefix}_p99_ms": percentile(lats, 0.99)}


def capture_costs(ex, reqs, max_answer=MAX_ANSWER) -> dict:
    """Per bucket: the seconds to capture its decode graphs (a fresh
    ``GraphDecoder`` on a side stream) and the peak device memory above
    what was allocated before, with its static buffers' bytes."""
    out = {}
    stream = torch.cuda.Stream()
    for b in BUCKETS:
        tb = first_batch(ex, reqs, b)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            decoder = GraphDecoder(ex.model, tb, max_answer, False, torch.cuda.graph_pool_handle())
        torch.cuda.synchronize()
        out[str(b)] = {"capture_s": time.perf_counter() - t0, "graphs": len(decoder.graphs),
                       "peak_bytes_above_base": torch.cuda.max_memory_allocated() - base,
                       "static_buffer_bytes": decoder_bytes(decoder)}
        del decoder, tb
        torch.cuda.empty_cache()
    return out


def check_bucket_rows(phase, engine, ex, reqs, max_answer=MAX_ANSWER) -> None:
    """Each bucket's replayed rows equal the eager generate's bit for bit
    (the engine idle: its static buffers are free)."""
    generate = ex._get_generate_fn(max_answer)
    for b in engine.buckets:
        tb = first_batch(ex, reqs, b)
        want = generate(tb)
        with engine._stream.scope():
            got = engine._decoders[b].start(tb)()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{phase}: bucket {b}: replayed rows differ from the eager "
                                 f"generate's ({int((got != want).sum())} tokens)")


def gathered_phase(title, make_ex, paths, per_batch: dict) -> dict:
    """Phase 14 for one model (see the module docstring)."""
    phase = "phase 14"
    reqs = requests(FLOOD_REQUESTS)
    out = {}
    for dtype in ("bfloat16", "float32"):
        ex = make_ex(paths, dtype)
        costs = capture_costs(ex, reqs) if dtype == "bfloat16" else None
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = ServingEngine(ex, *ex.serve_frames, batch_size=BATCH, max_wait_ms=5,
                               max_answer_length=MAX_ANSWER, buckets=BUCKETS)
        start_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        with engine:
            check_bucket_rows(f"{phase} {title} {dtype}", engine, ex, reqs)
            dataset = request_dataset(ex, reqs)
            t0 = time.perf_counter()
            want = ex.infer(dataset, BATCH, MAX_ANSWER)  # the eager, synchronous path
            torch.cuda.synchronize()
            sync_s = time.perf_counter() - t0
            flood(engine, reqs[:BATCH])  # warm-up
            batches0 = engine.stats()["batches"]
            reset_launches()
            answers, wall, lats = flood(engine, reqs)
            got = launches()
            n_batches = engine.stats()["batches"] - batches0
            check_launches(f"{phase} {title} {dtype}", got,
                           {k: n * n_batches for k, n in per_batch.items()})
            if answers != want:
                bad = sum(a != w for a, w in zip(answers, want))
                raise AssertionError(f"{phase}: {title} {dtype}: {bad} answers differ from "
                                     "executor.infer's")
            row = {"engine_start_s": start_s, "capture_s": engine.capture_s,
                   "peak_bytes_above_base": peak, "flood_requests": len(reqs),
                   "flood_clients": CLIENTS, "flood_batches": n_batches,
                   "answers_per_s": len(reqs) / wall, **latency_summary("flood", lats),
                   "sync_infer_answers_per_s": len(reqs) / sync_s,
                   "sync_infer_ms_per_batch": 1e3 * sync_s / -(-len(reqs) // BATCH),
                   "launches": got}
            if dtype == "bfloat16":
                row["capture_costs"] = costs
                row.update(latency_summary("lone", lone_latencies(engine, reqs)))
                row.update(flood_busy_share(engine, reqs[:BUSY_REQUESTS]))
                row["bucket_batches"] = engine.stats()["bucket_batches"]
        out[dtype] = row
        del ex, engine
        torch.cuda.empty_cache()
    b = out["bfloat16"]
    log(f"{phase}: {title} gathered engine, buckets {BUCKETS} ({card_line()}): rows of every "
        f"bucket replayed bit for bit as the eager generate's, and {FLOOD_REQUESTS} answers from "
        f"{CLIENTS} clients equal to executor.infer's, in bf16 and f32; bf16 flood "
        f"{b['answers_per_s']:.3f} answers/s (eager infer {b['sync_infer_answers_per_s']:.3f}), "
        f"p50/p99 {b['flood_p50_ms']:.3f}/{b['flood_p99_ms']:.3f} ms, lone "
        f"{b['lone_p50_ms']:.3f}/{b['lone_p99_ms']:.3f} ms, busy share "
        f"{b['device_busy_share']:.3f}; capture s {json.dumps(b['capture_s'])}; "
        f"{json.dumps(out)}")
    return out


def rows_engine(engine):
    """Within the block the engine's executor detokenizes nothing: answers
    are the token rows (the continuous engine's per-slot rows)."""
    ex = engine.executor

    class _Rows:
        def __enter__(self):
            ex._decode_rows = lambda rows: rows

        def __exit__(self, *exc):
            del ex._decode_rows

    return _Rows()


def continuous_run(engine, reqs) -> dict:
    """One configuration: flood, lone requests; launches per prefill."""
    flood(engine, reqs[:BATCH])  # warm-up
    s0 = engine.stats()
    reset_launches()
    _, wall, lats = flood(engine, reqs)
    got = launches()
    s1 = engine.stats()
    return {"answers_per_s": len(reqs) / wall, **latency_summary("flood", lats),
            **latency_summary("lone", lone_latencies(engine, reqs, 8)),
            "dispatches": s1["decode_dispatches"] - s0["decode_dispatches"],
            "prefill_chunks": s1["prefill_chunks"] - s0["prefill_chunks"],
            "slot_occupancy": s1["slot_occupancy"], "launches": got}


def check_continuous_identity(phase, title, ex, engine, reqs, max_answer, dtype) -> dict:
    """f32: answers equal ``infer``'s; bf16: rows equal the eager greedy
    rows but where the greedy step's top-2 margin is within twice the
    measured gap between the one-token window step and the one-token step."""
    dataset = request_dataset(ex, reqs)
    if dtype == "float32":
        want = ex.infer(dataset, BATCH, max_answer)
        got = answer_all(engine, reqs)
        if got != want:
            raise AssertionError(f"{phase}: {title}: f32 continuous answers differ from infer's")
        return {"answers_equal": True}
    parted, gap = 0, 0.0
    with rows_engine(engine):
        rows = answer_all(engine, reqs)
    for j, (batch, n_valid) in enumerate(batch_iterator(dataset, BATCH)):
        tb = ex._device_batch(batch)
        with torch.inference_mode():
            r, seen = greedy_recorded(ex.model, tb, max_answer)
        g = step_k_logit_gap(ex.model.eval(), tb, r, seen, 1)
        gap = max(gap, g)
        parted += tie_parted(f"{phase} {title} bf16", rows[j * BATCH:j * BATCH + n_valid],
                             r.tolist()[:n_valid], seen,
                             margin_allowed=max(TIE_MARGIN, 2 * g))[0]
    return {"rows_parted": parted, "step_k_logit_gap": gap}


def continuous_phase(title, make_ex, paths, per_prefill: dict, grid, max_answer=MAX_ANSWER):
    """Phase 15 for one model (see the module docstring): the grid in bf16
    (each point's capture, flood and lone numbers), the best point's busy
    share, a mid-stream join, and identity in f32 and bf16."""
    phase = "phase 15"
    reqs = requests(CONT_REQUESTS)
    out = {"grid": {}}
    ex = make_ex(paths, "bfloat16")
    for horizon, chunk in grid:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with ContinuousEngine(ex, *ex.serve_frames, num_slots=BATCH, prefill_chunk=chunk,
                              horizon=horizon, max_answer_length=max_answer,
                              max_queue=0) as engine:
            row = {"capture_s": engine.capture_s,
                   "peak_bytes_above_base": torch.cuda.max_memory_allocated() - base,
                   **continuous_run(engine, reqs)}
        check_launches(f"{phase} {title} h{horizon} c{chunk}", row["launches"],
                       {k: n * row["prefill_chunks"] for k, n in per_prefill.items()})
        out["grid"][f"{horizon}x{chunk}"] = row
    best = max(out["grid"], key=lambda k: out["grid"][k]["answers_per_s"])
    horizon, chunk = (int(x) for x in best.split("x"))
    out["best"] = best
    for dtype in ("bfloat16", "float32"):
        if dtype == "float32":
            del ex
            torch.cuda.empty_cache()
            ex = make_ex(paths, dtype)
        with ContinuousEngine(ex, *ex.serve_frames, num_slots=BATCH, prefill_chunk=chunk,
                              horizon=horizon, max_answer_length=max_answer,
                              max_queue=0) as engine:
            out[dtype] = check_continuous_identity(phase, title, ex, engine, reqs[:2 * BATCH],
                                                   max_answer, dtype)
            if dtype == "bfloat16":
                out[dtype].update(flood_busy_share(engine, reqs[:BUSY_REQUESTS]))
            else:  # a mid-stream join: later requests join the decode of earlier ones
                want = ex.infer(request_dataset(ex, reqs[:16]), BATCH, max_answer)
                first = [engine.submit(*r) for r in reqs[:8]]
                time.sleep(0.02)
                later = [engine.submit(*r) for r in reqs[8:16]]
                got = [f.result(timeout=FUTURE_TIMEOUT) for f in first + later]
                if got != want:
                    raise AssertionError(f"{phase}: {title}: a mid-stream join parted")
                out[dtype]["mid_stream_join_equal"] = True
    del ex
    torch.cuda.empty_cache()
    b = out["grid"][best]
    log(f"{phase}: {title} continuous engine, {BATCH} slots ({card_line()}): best of the grid "
        f"{best} (horizon x prefill chunk): {b['answers_per_s']:.3f} answers/s under a flood of "
        f"{CONT_REQUESTS} from {CLIENTS} clients, p50/p99 {b['flood_p50_ms']:.3f}/"
        f"{b['flood_p99_ms']:.3f} ms, lone {b['lone_p50_ms']:.3f}/{b['lone_p99_ms']:.3f} ms; "
        f"f32 answers equal infer's, bf16 rows parted {out['bfloat16']['rows_parted']} "
        f"(near-ties); {json.dumps(out)}")
    return out


def fault_phase(paths, root) -> dict:
    """Phase 16: a hung dispatch fails the in-flight futures within the
    stall timeout; an expired request resolves TimeoutError; a reload then
    answers as a fresh engine on the new weights does. LaTr-base widths,
    two layers each (depth cut: the faults need no depth)."""
    phase = "phase 16"
    save = os.path.join(root, "fault_ckpts")
    config = latr_train_config(paths, save, num_encoder_layers=2, num_t5_decoder_layers=2,
                               vit_num_layers=2)
    ex = serve_executor(config)
    reqs = requests(BATCH)
    out = {}
    for kind in ("gathered", "continuous"):
        release = threading.Event()
        if kind == "gathered":
            engine = ServingEngine(ex, *ex.serve_frames, batch_size=BATCH, max_wait_ms=5,
                                   max_answer_length=MAX_ANSWER, stall_timeout_s=STALL_TIMEOUT_S)
            real = ex.infer_async

            def hung(*a, **kw):
                resolve = real(*a, **kw)
                return lambda: (release.wait(), resolve())[1]

            ex.infer_async = hung
        else:
            engine = ContinuousEngine(ex, *ex.serve_frames, num_slots=BATCH, prefill_chunk=8,
                                      horizon=8, max_answer_length=MAX_ANSWER,
                                      stall_timeout_s=STALL_TIMEOUT_S)
            real = engine._dispatch
            engine._dispatch = lambda *a: (release.wait(), real(*a))[1]
        t0 = time.perf_counter()
        futures = [engine.submit(*r) for r in reqs[:4]]
        for f in futures:
            try:
                f.result(timeout=FUTURE_TIMEOUT)
                raise AssertionError(f"{phase}: {kind}: a hung dispatch answered")
            except RuntimeError as e:
                if "device stall" not in str(e):
                    raise
        failed_s = time.perf_counter() - t0
        if failed_s > STALL_TIMEOUT_S + 2.0 or engine.unhealthy_reason is None:
            raise AssertionError(f"{phase}: {kind}: in-flight futures failed after {failed_s} s "
                                 f"(stall timeout {STALL_TIMEOUT_S})")
        t0 = time.perf_counter()
        engine.stop()
        stop_s = time.perf_counter() - t0
        release.set()  # the abandoned thread finishes its dispatch and sees the stall
        if kind == "gathered":
            ex.infer_async = real
            engine._resolver.join(timeout=FUTURE_TIMEOUT)
        else:
            engine._worker.join(timeout=FUTURE_TIMEOUT)
        out[kind] = {"stall_failed_after_s": failed_s, "stop_s": stop_s}
    # expiry, then reload == a fresh engine on the new weights
    ex.ckpt.save("best", {"params": ex.state.params, "best_score": 0.0})
    other = dict(config, SEED=SEED + 1)
    fresh = serve_executor(Config(other))
    fresh.ckpt.save("last", {"params": fresh.state.params, "best_score": 0.0})
    for kind in ("gathered", "continuous"):
        served = serve_executor(config)
        served._load_trained_checkpoint("best")
        make = (lambda e: ServingEngine(e, *e.serve_frames, batch_size=BATCH, max_wait_ms=5,
                                        max_answer_length=MAX_ANSWER)) if kind == "gathered" \
            else (lambda e: ContinuousEngine(e, *e.serve_frames, num_slots=BATCH,
                                             prefill_chunk=8, horizon=8,
                                             max_answer_length=MAX_ANSWER))
        with make(served) as engine:
            try:
                engine.submit(*reqs[0], deadline_s=-1.0).result(timeout=FUTURE_TIMEOUT)
                raise AssertionError(f"{phase}: {kind}: an expired request answered")
            except TimeoutError:
                pass
            before = answer_all(engine, reqs)
            info = engine.reload("last")
            after = answer_all(engine, reqs)
        newer = serve_executor(Config(other))
        with make(newer) as engine:
            want = answer_all(engine, reqs)
        if after != want or after == before:
            raise AssertionError(f"{phase}: {kind}: after the reload the answers are not a fresh "
                                 "engine's on the new weights")
        out[kind].update(expired_timeout=True, reload_ms=info["ms"], reload_equal_fresh=True)
        del served, newer
        torch.cuda.empty_cache()
    log(f"{phase}: faults (LaTr-base widths, 2 layers each): a hung dispatch fails the "
        f"in-flight futures within the {STALL_TIMEOUT_S} s stall timeout and stop() returns, an "
        f"expired request resolves TimeoutError, reload then answer == a fresh engine on the "
        f"new weights, in both engines: {json.dumps(out)}")
    return out


REPO = os.path.dirname(os.path.abspath(__file__))


def _serve_cli(*args, **kw):
    return subprocess.run([sys.executable, "-m", "phoneme_vqa_torch.serve", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=600, **kw)


def cli_phase(paths, root) -> dict:
    """Phase 17: ``python -m phoneme_vqa_torch.serve`` at full width
    (LaTr-base, its config as JSON): ``--prime`` with a kernel store exits
    0, a stdin/stdout round trip loads that store, and an HTTP server
    answers /answer, /stats, /metrics and /healthz, then drains on SIGTERM
    and exits 0."""
    phase = "phase 17"
    cfg_path = os.path.join(root, "latr_base_serve.json")
    with open(cfg_path, "w", encoding="utf-8") as f:
        json.dump(dict(latr_train_config(paths, os.path.join(root, "cli_ckpts"))), f)
    store = os.path.join(root, "kernel_store")
    base = ["--config-file", cfg_path, "--ckpt", "none", "--max-length", str(MAX_ANSWER),
            "--aot", store]
    out = {}
    t0 = time.perf_counter()
    r = _serve_cli(*base, "--prime", "--buckets", "1,4")
    out["prime_s"] = time.perf_counter() - t0
    if r.returncode != 0 or "primed" not in r.stderr or \
            not os.path.isfile(os.path.join(store, "manifest.json")):
        raise AssertionError(f"{phase}: --prime failed ({r.returncode}): {r.stderr[-3000:]}")
    reqs = requests()
    lines = "".join(json.dumps({"id": n, "image_id": i, "question": q}) + "\n"
                    for n, (i, q) in enumerate(reqs))
    t0 = time.perf_counter()
    r = _serve_cli(*base, input=lines)
    out["stdin_s"] = time.perf_counter() - t0
    answers = [json.loads(line) for line in r.stdout.strip().splitlines()]
    if r.returncode != 0 or sorted(a["id"] for a in answers if "answer" in a) != \
            list(range(len(reqs))) or "AOT store loaded" not in r.stderr:
        raise AssertionError(f"{phase}: stdin round trip failed ({r.returncode}): "
                             f"{r.stderr[-3000:]}")
    with socket.socket() as sock:
        sock.bind(("", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen([sys.executable, "-m", "phoneme_vqa_torch.serve", *base,
                             "--http", str(port)], cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 300
        while True:
            try:
                health = json.loads(urllib.request.urlopen(url + "/healthz", timeout=5).read())
                break
            except (urllib.error.URLError, ConnectionError):
                if time.time() > deadline or proc.poll() is not None:
                    raise AssertionError(f"{phase}: the HTTP server never became healthy")
                time.sleep(1.0)
        results = []

        def post(i, q):
            body = json.dumps({"image_id": i, "question": q}).encode()
            results.append(json.loads(urllib.request.urlopen(
                urllib.request.Request(url + "/answer", body), timeout=FUTURE_TIMEOUT).read()))

        threads = [threading.Thread(target=post, args=r) for r in reqs[:16]]
        [t.start() for t in threads]
        [t.join(timeout=FUTURE_TIMEOUT) for t in threads]
        stats = json.loads(urllib.request.urlopen(url + "/stats", timeout=30).read())
        metrics = urllib.request.urlopen(url + "/metrics", timeout=30).read().decode()
        if health != {"ok": True} or len(results) != 16 or \
                not all("answer" in x for x in results) or stats["served"] < 16 or \
                "phonovqa_served_total" not in metrics:
            raise AssertionError(f"{phase}: HTTP round trip failed: {stats}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        if rc != 0:
            raise AssertionError(f"{phase}: SIGTERM drain exited {rc}: {proc.stderr.read()[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out["http_served"] = stats["served"]
    log(f"{phase}: serve CLI at full width (LaTr-base): --prime with a kernel store exited 0 in "
        f"{out['prime_s']:.1f} s, a stdin round trip loaded the store and answered "
        f"{len(reqs)} requests in {out['stdin_s']:.1f} s, HTTP /answer x16, /stats, /metrics, "
        f"/healthz answered and SIGTERM drained with exit 0")
    return out


# -- phases 18-22: fine-tuning from pretrained weights ------------------------

HF_MANIFEST = os.path.join(REPO, "tests", "data", "latr_base_hf_manifest.json")
LORA_RANK = 8


def opt_state_bytes(tree) -> int:
    """Bytes of the tensors in an optimizer state (or any nested dict)."""
    if isinstance(tree, dict):
        return sum(opt_state_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0


def seeded_array(g, key: str, shape) -> np.ndarray:
    """A seeded f32 value for a checkpoint tensor: norm scales near 1,
    biases and position tables small, matrices and tables N(0, fan_in^-1/2)."""
    shape = tuple(shape)
    x = g.standard_normal(shape, dtype=np.float32)
    leaf = key.rsplit(".", 1)[-1]
    if "norm" in key and leaf == "weight":
        return 1.0 + 0.1 * x
    if leaf == "bias" or "position_embeddings" in key or "cls_token" in key:
        return 0.02 * x
    if len(shape) >= 2:
        return x * np.float32(int(np.prod(shape[1:])) ** -0.5)
    return x


def write_safetensors(path: str, tensors: dict) -> None:
    """f32 numpy arrays as a .safetensors file: an 8-byte little-endian header
    length, a JSON header of dtype, shape and byte offsets, the raw bytes
    (the card machine has no safetensors package)."""
    header, offset = {}, 0
    for key, a in tensors.items():
        header[key] = {"dtype": "F32", "shape": list(a.shape),
                       "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for a in tensors.values():
            f.write(np.ascontiguousarray(a, "<f4").tobytes())


def import_phase(root, encode_launches, e2e_launches) -> dict:
    """Phase 18: a LaTr-base T5 (``t5/model.safetensors``) and ViT-base
    (``vit/pytorch_model.bin``) written with seeded values from the committed
    manifest of transformers' key layout (tests/data), imported through
    ``pretrained_weights_path``: every manifest key mapped, none failed, the
    masters the files' values; f32 logits and greedy rows kernels vs plain
    (phase 5's gates); bf16 requests through the gathered engine."""
    phase = "phase 18"
    with open(HF_MANIFEST, encoding="utf-8") as f:
        manifest = json.load(f)
    weights = os.path.join(root, "pretrained")
    t0 = time.perf_counter()
    for i, (name, entry) in enumerate(manifest.items()):
        os.makedirs(os.path.join(weights, name))
        g = np.random.default_rng(SEED + 100 + i)
        tensors = {k: seeded_array(g, k, shape) for k, shape in entry["tensors"]}
        path = os.path.join(weights, name, entry["file"])
        if path.endswith(".safetensors"):
            write_safetensors(path, tensors)
            written = tensors["shared.weight"][:4].copy()  # to hold the import to
        else:
            torch.save({k: torch.from_numpy(v) for k, v in tensors.items()}, path)
        del tensors
    write_s = time.perf_counter() - t0
    want_keys = {k for entry in manifest.values() for k, _ in entry["tensors"]}
    paths = latr_fixture(os.path.join(root, "import"))
    reqs = requests()
    out = {"manifest_tensors": len(want_keys), "write_s": write_s,
           "checkpoint_gb": sum(os.path.getsize(os.path.join(weights, n, e["file"]))
                                for n, e in manifest.items()) / 1e9}
    for dtype in ("float32", "bfloat16"):
        gc_cuda()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ex = EXECUTORS.get("LaTr_Executor")(latr_train_config(
            paths, os.path.join(root, "import_ckpts"), DTYPE=dtype,
            pretrained_weights_path=weights), "serve", device=DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        report = ex.import_report
        if report.failed or report.unused or set(report.mapped) != want_keys:
            raise AssertionError(f"{phase}: import report failed {report.failed[:3]}, unused "
                                 f"{report.unused[:3]}, mapped {len(report.mapped)} of "
                                 f"{len(want_keys)} manifest keys")
        if not np.array_equal(ex.state.params["t5.shared.weight"][:4].detach().cpu().numpy(),
                              written):
            raise AssertionError(f"{phase}: t5.shared.weight is not the file's")
        ex.model.eval()
        out[dtype] = {"load_s": load_s, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "mapped": len(report.mapped), "failed": len(report.failed),
                      "unfilled": report.unfilled}
        if dtype == "float32":
            out[dtype]["end_to_end"] = check_end_to_end_f32(phase, ex.model, first_batch(ex, reqs),
                                                            e2e_launches)
        else:
            with ServingEngine(ex, *ex.serve_frames, batch_size=BATCH, max_wait_ms=20,
                               max_answer_length=MAX_ANSWER) as engine:
                out[dtype]["served"] = serve(phase, "LaTr-base (imported weights)", engine, reqs,
                                             encode_launches)
        log(f"{phase}: LaTr-base {dtype} from {len(want_keys)} HF tensors "
            f"({out['checkpoint_gb']:.2f} GB, written in {write_s:.1f} s): import report mapped "
            f"{len(report.mapped)}, failed {len(report.failed)}, unused {len(report.unused)}, "
            f"unfilled (keep the seeded init) {report.unfilled}; executor built and imported in "
            f"{load_s:.1f} s, peak {out[dtype]['peak_gb']:.2f} GB")
        del ex
    shutil.rmtree(weights)
    gc_cuda()
    return out


def gc_cuda() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def reference_state_dict(ex, seed: int) -> dict:
    """A PhonemeSaL reference model's ``state_dict()`` (the original torch
    repository's layout) at the executor's widths, seeded: the HF T5
    encoder under ``encoder.`` (keys of the manifest's T5, the vocabulary
    one context token larger), ``rel2Dbias``, the OCR and object projectors
    and norms, a plain ``nn.Embedding`` ``tgt_tok_emb``, torch
    ``nn.TransformerDecoder`` layers under ``decoder.decoder.`` and the
    ``lm_head``."""
    with open(HF_MANIFEST, encoding="utf-8") as f:
        t5_keys = json.load(f)["t5"]["tensors"]
    shapes = {n: tuple(p.shape) for n, p in ex.model.named_parameters()}
    vocab, d = shapes["t5.shared.weight"]
    g = np.random.default_rng(seed)
    sd = {}
    for key, shape in t5_keys:
        if key == "shared.weight":
            shape = (vocab, d)
        elif not key.startswith("encoder."):
            continue  # an encoder-only T5: no decoder keys
        sd[f"encoder.{key}"] = seeded_array(g, key, shape)
    sd["rel2Dbias.Relative1D.relative_attention_bias.weight"] = seeded_array(
        g, "table", shapes["rel2d.rel1d.weight"])
    sd["rel2Dbias.SCP.relative_attention_bias.weight"] = seeded_array(
        g, "table", shapes["rel2d.scp.weight"])
    for stream in ("ocr", "obj"):
        for mod in ("feature_projector", "bbox_projector"):
            for leaf in ("weight", "bias"):
                key = f"{stream}_{mod}.{leaf}"
                sd[key] = seeded_array(g, key, shapes[key])
        sd[f"{stream}_feature_layer_norm.weight"] = seeded_array(
            g, "norm.weight", shapes[f"{stream}_norm.weight"])
    n_layers = len({n.split(".")[1] for n in shapes if n.startswith("decoder.layer_")})
    dim_ff = shapes["decoder.layer_0.fc1.weight"][0]
    with torch.device("meta"):
        layers = torch.nn.TransformerDecoder(torch.nn.TransformerDecoderLayer(
            d, PSAL_FULL["n_head"], dim_ff), n_layers)
    for key, t in layers.state_dict().items():
        sd[f"decoder.decoder.{key}"] = seeded_array(g, key, t.shape)
    tgt = shapes["decoder.embed.weight"]
    sd["tgt_tok_emb.weight"] = seeded_array(g, "table", tgt)
    sd["lm_head.weight"] = seeded_array(g, "lm_head.weight", tgt)
    sd["lm_head.bias"] = seeded_array(g, "lm_head.bias", tgt[:1])
    return sd


def converter_phase(psal_paths, root) -> dict:
    """Phase 19: a full-width PhonemeSaL-base reference .pth converted by
    ``python -m phoneme_vqa_torch.import_reference_ckpt`` (a subprocess, its
    config as JSON) into best_ckp, evaluated by ``python -m
    phoneme_vqa_torch.run --mode eval``; in process, the converted
    checkpoint's answers equal those of the in-process import of the same
    state dict, 12 SaL launches a batch."""
    phase = "phase 19"
    save = os.path.join(root, "converted")
    cfg = phoneme_train_config(psal_paths, save, SAVE=True)
    cfg_path = os.path.join(root, "phoneme_sal_base.json")
    with open(cfg_path, "w", encoding="utf-8") as f:
        json.dump(dict(cfg), f)
    shapes_ex = EXECUTORS.get(cfg.EXECUTOR)(cfg, "serve", device=DEVICE)  # meta: shapes only
    sd = reference_state_dict(shapes_ex, SEED + 200)
    del shapes_ex
    pth = os.path.join(root, "phoneme_sal_reference.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}, "epoch": 2,
                "step": 40, "best_score": 0.25}, pth)
    out = {"reference_tensors": len(sd), "pth_gb": os.path.getsize(pth) / 1e9}
    device = ["--device", DEVICE.type]
    for key, argv in (("convert", ["-m", "phoneme_vqa_torch.import_reference_ckpt",
                                   "--config-file", cfg_path, "--ckpt", pth, "--name", "best",
                                   *device]),
                      ("eval_cli", ["-m", "phoneme_vqa_torch.run", "--config-file", cfg_path,
                                    "--mode", "eval", "--evaltype", "best", *device])):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, *argv], cwd=REPO, capture_output=True, text=True,
                           timeout=600)
        out[f"{key}_s"] = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"{phase}: {' '.join(argv[:2])} exited {r.returncode}:\n"
                                 f"{r.stderr[-3000:]}")
        if key == "convert" and "FAILED" in r.stderr:
            raise AssertionError(f"{phase}: the conversion reported failures:\n{r.stderr[-3000:]}")
    ev = EXECUTORS.get(cfg.EXECUTOR)(cfg, "eval", evaltype="best", device=DEVICE)
    ev._load_trained_checkpoint("best")
    reset_launches()
    converted = ev.infer(ev.val_data, BATCH, PSAL_ANSWER)
    torch.cuda.synchronize()
    check_launches(phase, launches(), {"flash_attention": 0,
                                       "sal_fused_attention": T5_BASE["num_encoder_layers"]})
    del ev
    ref = EXECUTORS.get(cfg.EXECUTOR)(cfg, "eval", device=DEVICE)
    report = hf_import.ImportReport()
    ref.load_params(hf_import.import_reference_state_dict(ref._ensure_params(), sd, report))
    in_process = ref.infer(ref.val_data, BATCH, PSAL_ANSWER)
    if report.failed or converted != in_process:
        raise AssertionError(f"{phase}: failed {report.failed[:3]}; converted answers "
                             f"{converted[:3]} != in-process {in_process[:3]}")
    out.update(mapped=len(report.mapped), answers=len(converted), first_answer=converted[0])
    log(f"{phase}: PhonemeSaL-base reference .pth ({len(sd)} tensors, {out['pth_gb']:.2f} GB) "
        f"converted in {out['convert_s']:.1f} s, --mode eval in {out['eval_cli_s']:.1f} s (both "
        f"exit 0); {len(report.mapped)} tensors mapped, 0 failed; the converted checkpoint's "
        f"{len(converted)} answers equal the in-process import's: {converted[:2]}")
    del ref
    gc_cuda()
    return out


def lora_phase(paths, root, encode_step, trained7) -> dict:
    """Phase 20: LaTr-base with ``LORA_RANK`` 8 (attention projections), 20
    steps at batch 16 through LaTrExecutor: optimizer state for the adapters
    only, the base bit for bit unchanged, 48 launches a step, ms a step and
    peak beside phase 7's; one f32 step kernels vs plain (phase 7b's
    yardstick); two serving adapters through the gathered engine: each
    route's answers equal an engine's over that adapter's merged weights,
    the base restored bit for bit, the switch ms."""
    phase = "phase 20"
    gc_cuda()
    torch.cuda.reset_peak_memory_stats()
    cfg = latr_train_config(paths, os.path.join(root, "lora_ckpts"), LORA_RANK=LORA_RANK,
                            SAVE=False)
    ex = LaTrExecutor(cfg, "train", device=DEVICE)
    base0 = {n: p.detach().clone() for n, p in ex.state.params.items()}
    names = {f"{n}.{k}" for n in ex.state.lora for k in ("a", "b")}
    if set(ex.state.opt_state["mu"]) != names or set(ex.state.opt_state["nu"]) != names:
        raise AssertionError(f"{phase}: optimizer state beyond the adapters")
    batches = [b for b, _ in itertools.islice(batch_iterator(
        ex.train_data, TRAIN_BATCH, shuffle=True, seed=SEED + 1, drop_last=True), TRAIN_STEPS)]
    reset_launches()
    loss = ex.forward_loss(ex._to_device(batches[0]))
    loss.backward()
    ex.apply_gradients()
    torch.cuda.synchronize()
    step_launches = launches()
    check_launches(phase, step_launches, encode_step_plus_decoder(encode_step))
    losses = [float(loss)]
    ms = timed_steps(ex, batches[1:])
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the frozen ViT runs without gradients (as JAX stops them at its
    # output): its adapters take none and stay at their zero b
    vit = [n for n in ex.state.lora if n.startswith("vit.")]
    moved = [n for n, ad in ex.state.lora.items() if ad["b"].abs().max() > 0]
    unchanged = all(torch.equal(p, base0[n]) for n, p in ex.state.params.items())
    if not unchanged or sorted(moved) != sorted(set(ex.state.lora) - set(vit)):
        raise AssertionError(f"{phase}: base unchanged {unchanged}, {len(moved)} of "
                             f"{len(ex.state.lora)} adapters moved ({len(vit)} on the ViT)")
    check_losses(phase, losses)
    out = {"adapters": len(ex.state.lora), "adapter_params_m": sum(
        t.numel() for t in ex._opt_params().values()) / 1e6,
        "base_params_m": sum(p.numel() for p in ex.state.params.values()) / 1e6,
        "opt_state_gb": opt_state_bytes(ex.state.opt_state) / 1e9, "ms_per_step": ms,
        "peak_gb": peak, "phase7_ms_per_step": trained7["ms_per_step"],
        "phase7_peak_gb": trained7["peak_memory_gb"], "base_bit_identical": unchanged,
        "launches_per_step": step_launches}
    log(f"{phase}: LaTr-base LoRA rank {LORA_RANK} ({out['adapter_params_m']:.2f}M adapter "
        f"parameters over a frozen {out['base_params_m']:.1f}M base): optimizer state "
        f"{out['opt_state_gb'] * 1e3:.1f} MB for the adapters only, base bit-identical after "
        f"{TRAIN_STEPS} steps, {ms:.1f} ms a step, peak {peak:.2f} GB (phase 7, full fine-tune: "
        f"{trained7['ms_per_step']:.1f} ms, {trained7['peak_memory_gb']:.2f} GB)")
    trained_lora = {n: {k: t.detach().clone() for k, t in ad.items()}
                    for n, ad in ex.state.lora.items()}
    scale = ex._lora_scale
    del ex, batches, base0
    gc_cuda()
    out["f32_step"] = check_train_f32(phase, LaTrExecutor(latr_train_config(
        paths, os.path.join(root, "f32"), DTYPE="float32", TRAIN_BATCH_SIZE=4, SAVE=False,
        LORA_RANK=LORA_RANK), "train", device=DEVICE), encode_step_plus_decoder(encode_step))
    out["serving"] = adapter_serving(paths, root, trained_lora, scale)
    return out


def encode_step_plus_decoder(encode_step) -> dict:
    """A LaTr-base train step's launches: the ViT and encoder layers, and the
    decoder's self and cross layers (48)."""
    n_dec = T5_BASE["num_t5_decoder_layers"]
    return {"flash_attention": encode_step["flash_attention"] + 2 * n_dec,
            "sal_fused_attention": 0}


def adapter_serving(paths, root, trained_lora, scale) -> dict:
    """Phase 20's serving half: adapters a1 (phase 20's trained ones) and a2
    (seeded, b ~ N(0, 0.05)) on a bf16 LaTr-base gathered engine; every route
    of 64 requests against an engine over the merged weights."""
    phase = "phase 20"
    save = os.path.join(root, "adapter_serve")
    cfg = latr_train_config(paths, save)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 300)
    a2 = {n: {"a": ad["a"].clone(), "b": torch.randn(ad["b"].shape, generator=g,
                                                     device=DEVICE) * 0.05}
          for n, ad in trained_lora.items()}
    adapters = {"a1": {"lora": trained_lora, "scale": scale}, "a2": {"lora": a2, "scale": scale}}
    reqs = requests()
    want = {}
    for route in (None, "a1", "a2"):
        ex = serve_executor(cfg)
        if route is not None:
            ex.load_params(lora_mod.merge_lora(ex.state.params, adapters[route]["lora"], scale))
        with ServingEngine(ex, *ex.serve_frames, batch_size=BATCH, max_wait_ms=20,
                           max_answer_length=MAX_ANSWER) as engine:
            want[route] = answer_all(engine, reqs)
        del ex, engine
        gc_cuda()
    ex = serve_executor(cfg)
    base = {n: p.detach().clone() for n, p in ex.model.named_parameters()}
    routed = [(i, q, (None, "a1", "a2")[n % 3]) for n, (i, q) in enumerate(reqs)]
    with ServingEngine(ex, *ex.serve_frames, batch_size=BATCH, max_wait_ms=20,
                       max_answer_length=MAX_ANSWER, adapters=adapters) as engine:
        answer_all(engine, reqs[:BATCH])  # warm-up
        t0 = time.perf_counter()
        futures = [engine.submit(i, q, adapter=a) for i, q, a in routed]
        got = [f.result(timeout=FUTURE_TIMEOUT) for f in futures]
        wall = time.perf_counter() - t0
        stats = engine.stats()
        engine._activate(None)
    restored = all(torch.equal(p, base[n]) for n, p in ex.model.named_parameters())
    bad = [n for n, (i, q, a) in enumerate(routed) if got[n] != want[a][n]]
    if bad or not restored:
        raise AssertionError(f"{phase}: {len(bad)} routed answers differ from their merged "
                             f"engines' (first {bad[:3]}); base restored {restored}")
    differs = {a: sum(x != y for x, y in zip(want[a], want[None])) for a in ("a1", "a2")}
    out = {"requests": len(routed), "answers_per_s": len(routed) / wall,
           "switches": stats["adapter_switches"], "switch_ms": stats["adapter_switch_ms"],
           "base_restored_bit_identical": restored, "answers_differing_from_base": differs}
    log(f"{phase}: adapters a1 (trained) and a2 through one engine, {len(routed)} requests "
        f"round robin over base/a1/a2: every answer equals its merged engine's; "
        f"{stats['adapter_switches']} switches of "
        f"{np.median(stats['adapter_switch_ms']):.1f} ms median "
        f"(max {max(stats['adapter_switch_ms']):.1f}); base restored bit for bit; answers "
        f"differing from the base's: {differs}; {out['answers_per_s']:.1f} answers/s")
    del ex, engine
    gc_cuda()
    return out


def set_remat(ex, on: bool) -> None:
    for stack in (ex.model.t5.encoder, getattr(ex.model.t5, "decoder", None)):
        if stack is not None:
            stack.cfg = dataclasses.replace(stack.cfg, remat=on)


def remat_f32_check(phase, ex, per_step_on, per_step_off) -> dict:
    """One f32 step (batch 4, dropout 0.1): loss and every gradient with
    REMAT on against off, both through the kernels, held to phase 7b's
    yardstick (the noisy plain path against the plain path, REMAT off); the
    launches of each counted."""
    start = {n: p.detach().clone() for n, p in ex.state.params.items()}
    batch, _ = next(batch_iterator(ex.train_data, 4))

    def grads_of(remat, attention=None):
        set_remat(ex, remat)
        ex.load_params(start)
        ex.state.step = 0
        with attention_replaced(attention) if attention else contextlib.nullcontext():
            loss = ex.forward_loss(ex._to_device(batch))
            loss.backward()
        grads = {n: g.clone() for n, g in ex._collect_grads().items()}
        torch.cuda.synchronize()
        return float(loss.detach()), grads

    reset_launches()
    on_loss, on = grads_of(True)
    check_launches(f"{phase} REMAT on", launches(), per_step_on)
    reset_launches()
    off_loss, off = grads_of(False)
    check_launches(f"{phase} REMAT off", launches(), per_step_off)
    _, plain = grads_of(False, plain_attention)
    _, noisy = grads_of(False, noisy_attention(torch.Generator(device=DEVICE).manual_seed(SEED)))
    if not abs(on_loss - off_loss) <= LOSS_RTOL * abs(off_loss):
        raise AssertionError(f"{phase}: loss {on_loss} with REMAT, {off_loss} without")
    worst, identical = 0.0, 0
    for n, g in off.items():
        norm = float(g.norm())
        gap = float((on[n] - g).norm()) / max(norm, 1e-30)
        noise = float((noisy[n] - plain[n]).norm()) / max(float(plain[n].norm()), 1e-30)
        if not gap <= GRAD_NOISE_FACTOR * noise + GRAD_FLOOR:
            raise AssertionError(f"{phase}: REMAT moves the gradient of {n} by {gap:.3e} of its "
                                 f"norm, the yardstick {noise:.3e}")
        worst = max(worst, gap)
        identical += int(torch.equal(on[n], g))
    out = {"loss_on": on_loss, "loss_off": off_loss, "worst_grad_gap": worst,
           "grads_bit_identical": identical, "grads": len(off)}
    log(f"{phase}: f32 step, dropout {ex.config.dropout_rate}: REMAT on vs off loss "
        f"{on_loss:.6f} vs {off_loss:.6f}; {identical} of {len(off)} gradients bit-identical, "
        f"the widest gap {worst:.2e} of its norm (allowed {GRAD_NOISE_FACTOR} x the noisy "
        f"plain path's + {GRAD_FLOOR})")
    del ex
    gc_cuda()
    return out


def remat_timing(phase, ex, batches, per_step_on, per_step_off) -> dict:
    """ms a step and peak with REMAT on and off in interleaved turns (off,
    on, on, off) on one bf16 executor; the launches of each turn's first
    step counted."""
    out = {"on": [], "off": []}
    for remat in (False, True, True, False):
        set_remat(ex, remat)
        gc_cuda()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        loss = ex.forward_loss(ex._to_device(batches[0]))
        loss.backward()
        ex.apply_gradients()
        torch.cuda.synchronize()
        check_launches(f"{phase} REMAT {remat}", launches(), per_step_on if remat else per_step_off)
        ms = timed_steps(ex, batches[1:])
        out["on" if remat else "off"].append(
            {"ms_per_step": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    return out


def knob_steps(phase, title, ex, batches, **knob) -> dict:
    """A few bf16 steps at batch 16 of a LaTr-base executor after setting
    ``knob`` in its config (the optimizer rebuilt and started afresh, an
    EMA seeded from the masters): losses finite, ms a step (all but the
    first), peak, the optimizer state's and the EMA's bytes."""
    ex.config.update(knob)
    ex.tx = ex._make_optimizer(ex._lr_schedule)
    ex.state.opt_state = ex.tx.init(ex._opt_params())
    ex._bind_optimizer()
    ex.state.ema_params = (train_state.tree_map(lambda t: t.detach().clone(), ex._ckpt_params())
                           if ex._ema_decay() else None)
    gc_cuda()
    torch.cuda.reset_peak_memory_stats()
    check_losses(phase, [float(ex.train_step(batches[0]))])
    ms = timed_steps(ex, batches[1:])
    out = {"ms_per_step": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "opt_state_gb": opt_state_bytes(ex.state.opt_state) / 1e9,
           "ema_gb": opt_state_bytes(ex.state.ema_params or {}) / 1e9}
    log(f"{phase}: {title}: {json.dumps(out)}")
    return out


def accum_check(phase, paths, root) -> dict:
    """GRAD_ACCUM_STEPS 4 at batch 16 (f32 loss and gradients, bf16 compute,
    dropout 0.1): the executor's accumulated step against four sequential
    microbatches run by hand (each its own dropout stream), and the peak of
    the accumulated step against one of the whole batch."""
    cfg = latr_train_config(paths, os.path.join(root, "accum"), GRAD_ACCUM_STEPS=4, SAVE=False)
    ex = LaTrExecutor(cfg, "train", device=DEVICE)
    start = {n: p.detach().clone() for n, p in ex.state.params.items()}
    batch, _ = next(batch_iterator(ex.train_data, TRAIN_BATCH))
    peaks = {}

    def restore():  # a copy each time: an f32 value becomes the master itself
        ex.load_params({n: t.clone() for n, t in start.items()})
        ex.state.step = 0

    for accum in (1, 4):
        ex.config["GRAD_ACCUM_STEPS"] = accum
        restore()
        gc_cuda()
        torch.cuda.reset_peak_memory_stats()
        ex.train_step(batch)
        torch.cuda.synchronize()
        peaks[accum] = torch.cuda.max_memory_allocated() / 1e9
    after = {n: p.detach().clone() for n, p in ex.state.params.items()}
    restore()
    rows, summed, total = TRAIN_BATCH // 4, None, 0.0
    for i in range(4):
        micro = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        loss = ex.forward_loss(ex._to_device(micro), micro=i)
        loss.backward()
        grads = ex._collect_grads()
        total += float(loss)
        summed = grads if summed is None else {n: summed[n] + grads[n] for n in grads}
    ex.apply_gradients({n: g / 4 for n, g in summed.items()})
    lr = ex._lr_schedule(0)
    worst = 0.0
    for n, p in after.items():  # adam moves by up to ~lr: 2 lr and an ulp of p either way
        diff = (ex.state.params[n] - p).abs()
        worst = max(worst, float(diff.max()))
        if not bool((diff <= 2 * lr + 2 * torch.finfo(torch.float32).eps * p.abs()).all()):
            raise AssertionError(f"{phase}: the accumulated step parts from four hand-run "
                                 f"microbatches by {float(diff.max())} at {n} (2 lr = {2 * lr})")
    identical = sum(torch.equal(ex.state.params[n], p) for n, p in after.items())
    out = {"peak_gb_whole_batch": peaks[1], "peak_gb_accum_4": peaks[4],
           "params_bit_identical": identical, "params": len(after), "worst_param_gap": worst}
    log(f"{phase}: GRAD_ACCUM_STEPS 4 at batch 16: {identical} of {len(after)} masters "
        f"bit-identical to four hand-run microbatches (widest gap {worst:.2e}, lr {lr:.0e}); "
        f"peak {peaks[4]:.2f} GB against {peaks[1]:.2f} GB for the whole batch at once")
    del ex
    gc_cuda()
    return out


def remat_phase(paths, psal_paths, root, encode_step, sal_step) -> dict:
    """Phase 21: REMAT on LaTr-base and SaL-base with dropout 0.1 (f32 step on
    against off within the yardstick; the launches counted; ms a step and
    peak in interleaved turns at batch 16); GRAD_ACCUM_STEPS 4 against four
    hand-run microbatches; a few steps of EMA_DECAY, adafactor and
    OPT_MU_DTYPE bf16 with their optimizer-state bytes."""
    phase = "phase 21"
    n_t5, n_dec = T5_BASE["num_encoder_layers"], T5_BASE["num_t5_decoder_layers"]
    latr_off = encode_step_plus_decoder(encode_step)
    # the recompute reruns every T5 block's forward: the encoder's and the
    # decoder's self and cross layers again; the frozen ViT is not rerun
    latr_on = {"flash_attention": latr_off["flash_attention"] + n_t5 + 2 * n_dec,
               "sal_fused_attention": 0}
    sal_on = {"flash_attention": 2 * sal_step["flash_attention"],
              "sal_fused_attention": 2 * sal_step["sal_fused_attention"]}
    sal_keys = dict(EXECUTOR="SaL_Executor", MODEL_CLASS="SaL", MODEL_MOD_CONFIG_CLASS="SaL_config")
    out = {}
    for name, make, per_off, per_on in (
            ("latr", lambda **kw: LaTrExecutor(latr_train_config(
                paths, os.path.join(root, "remat"), SAVE=False, REMAT=True, **kw), "train",
                device=DEVICE), latr_off, latr_on),
            ("sal", lambda **kw: SaLExecutor(phoneme_train_config(
                psal_paths, os.path.join(root, "remat_sal"), SAVE=False, REMAT=True,
                **sal_keys, **kw), "train", device=DEVICE), sal_step, sal_on)):
        f32 = remat_f32_check(f"{phase} {name}", make(DTYPE="float32", TRAIN_BATCH_SIZE=4),
                              per_on, per_off)
        ex = make()
        batches = [b for b, _ in itertools.islice(batch_iterator(
            ex.train_data, TRAIN_BATCH, shuffle=True, seed=SEED + 3, drop_last=True), 5)]
        timing = remat_timing(f"{phase} {name}", ex, batches, per_on, per_off)
        out[name] = {"f32": f32, "timing": timing, "launches_on": per_on, "launches_off": per_off}
        log(f"{phase}: {name} REMAT launches a step {per_on} (off: {per_off}); interleaved "
            f"off/on/on/off at batch 16: {json.dumps(timing)}")
        if name == "latr":  # the optimizer knobs on the same executor, REMAT off
            set_remat(ex, False)
            out["knobs"] = {title: knob_steps(phase, title, ex, batches, **knob) for title, knob in (
                ("adam", {}), ("EMA_DECAY 0.999", {"EMA_DECAY": 0.999}),
                ("adafactor", {"OPTIMIZER": "adafactor", "EMA_DECAY": 0}),
                ("OPT_MU_DTYPE bfloat16", {"OPTIMIZER": "adam", "OPT_MU_DTYPE": "bfloat16"}))}
        del ex, batches
        gc_cuda()
    out["grad_accum"] = accum_check(phase, paths, root)
    return out


def vit_cache_phase(root, encode_step) -> dict:
    """Phase 22: VIT_CACHE. LaTr-base eval (bf16) over 64 questions on 16
    images (4 an image): each unique image encoded once (12 launches a chunk
    of 32), then 12 attention launches a batch (the T5 encoder) against 24
    uncached; answers identical to the uncached run's; ms of the pass. Then
    the serving encoding cache in the gathered engine: a second pass hits
    every image, answers equal an uncached engine's, a reload flushes the
    table and bumps its generation."""
    phase = "phase 22"
    paths = synthetic.make_latr_fixture(os.path.join(root, "vit_cache"), n_images=16, n_rows=64,
                                        image_hw=FULL["vit_image_size"])
    n_t5 = T5_BASE["num_encoder_layers"]
    cfg = latr_train_config(paths, os.path.join(root, "vit_cache_ckpts"),
                            qa_val_path=paths["train"], VIT_CACHE_BATCH=BATCH)
    out = {}
    answers = {}
    for cache in (False, True):
        ex = EXECUTORS.get(cfg.EXECUTOR)(Config({**cfg, "VIT_CACHE": cache}), "eval",
                                         device=DEVICE)
        ex._ensure_params()
        ex.infer(ex.val_data, BATCH, MAX_ANSWER)  # warm-up
        reset_launches()
        t0 = time.perf_counter()
        ex._maybe_attach_vit_cache(("val_data",))
        torch.cuda.synchronize()
        attach = launches()
        attach_s = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        answers[cache] = ex.infer(ex.val_data, BATCH, MAX_ANSWER)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        n_batches = len(answers[cache]) // BATCH
        per_batch = {k: v // n_batches for k, v in launches().items()}
        want = {"flash_attention": n_t5 if cache else encode_step["flash_attention"],
                "sal_fused_attention": 0}
        check_launches(f"{phase} cache {cache}", per_batch, want)
        out["cached" if cache else "uncached"] = {
            "eval_ms": ms, "launches_per_batch": per_batch, "attach_launches": attach,
            "attach_s": attach_s, "rows": len(answers[cache])}
        del ex
        gc_cuda()
    if answers[True] != answers[False]:
        raise AssertionError(f"{phase}: cached answers differ from the uncached run's")
    log(f"{phase}: LaTr-base eval over 64 questions on 16 images: answers identical cached and "
        f"uncached; {json.dumps(out)}")

    reqs = [(float(i % 16), synthetic.QUESTIONS[i % len(synthetic.QUESTIONS)])
            for i in range(64)]
    served = {}
    for cache in (False, True):
        ex = serve_executor(Config({**cfg, "VIT_CACHE": cache}))
        with ServingEngine(ex, *ex.serve_frames, batch_size=BATCH, max_wait_ms=20,
                           max_answer_length=MAX_ANSWER) as engine:
            reset_launches()
            first = answer_all(engine, reqs)
            torch.cuda.synchronize()
            first_launches = launches()
            reset_launches()
            t0 = time.perf_counter()
            second = answer_all(engine, reqs)
            torch.cuda.synchronize()
            second_ms = 1e3 * (time.perf_counter() - t0)
            second_launches = launches()
            stats = engine.stats()
            if cache:
                ex.ckpt.save("best", {"params": ex.state.params, "best_score": 0.0})
                gen = engine._enc_cache.generation
                engine.reload("best")
                flushed = engine.stats()["vit_cache"]
                if engine._enc_cache.generation != gen + 1 or flushed["entries"]:
                    raise AssertionError(f"{phase}: reload left {flushed} (generation "
                                         f"{engine._enc_cache.generation}, was {gen})")
                third = answer_all(engine, reqs)
                if third != first:
                    raise AssertionError(f"{phase}: answers after the reload differ")
        served[cache] = {"answers": first, "second": second, "second_ms": second_ms,
                         "first_launches": first_launches, "second_launches": second_launches,
                         "vit_cache": stats.get("vit_cache")}
        del ex, engine
        gc_cuda()
    if not (served[True]["answers"] == served[True]["second"] == served[False]["answers"]):
        raise AssertionError(f"{phase}: the encoding cache's answers differ")
    vc = served[True]["vit_cache"]
    if vc["hits"] < len(reqs) or vc["entries"] != 16:
        raise AssertionError(f"{phase}: encoding cache stats {vc}")
    for cache in served.values():
        del cache["answers"], cache["second"]
    out["serving"] = {str(k): v for k, v in served.items()}
    log(f"{phase}: serving encoding cache: answers equal the uncached engine's, a repeat pass "
        f"hits every image ({vc}), launches of the repeat pass "
        f"{served[True]['second_launches']} against {served[False]['second_launches']}, "
        f"{served[True]['second_ms']:.0f} ms against {served[False]['second_ms']:.0f}; a reload "
        f"flushed the table and bumped its generation")
    return out


# -- phases 23-25: the A12 knobs, the kernels at TP head slices, the mesh --------------

MESH_BATCH = 4  # phase 25's f32 steps, as 7b's
# phase 25 cuts depth, not width: 4 ViT, 4 encoder and 4 decoder layers (the
# spawned processes each build, step and checkpoint the model)
MESH_LAYERS = 4
MESH_ANSWER = 8  # its greedy and beam rows


def _knob_steps(ex, batches, workers: int) -> tuple:
    """``len(batches)`` train steps from the executor's initial masters
    (reloaded, optimizer state and step reset) through ``_maybe_prefetch``
    at ``workers``: (losses, ms a step)."""
    ex.load_params({n: t.clone() for n, t in ex._knob_start.items()})  # masters alias them
    ex.state.step = 0
    ex.config["NUMWORKERS"] = workers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(ex.train_step(b)) for b, _ in ex._maybe_prefetch(iter(batches))]
    torch.cuda.synchronize()
    return losses, 1e3 * (time.perf_counter() - t0) / len(batches)


def knobs_phase(paths, root) -> dict:
    """Phase 23: FEATURE_CACHE, PROFILE_DIR and DEBUG_NANS on full-width
    LaTr-base (phase 7's config, bf16, dropout 0.1); NUMWORKERS is
    :func:`numworkers_phase`."""
    from phoneme_vqa_torch.data.latr import LaTrDataset
    from phoneme_vqa_torch.utils import profiling

    phase = "phase 23"
    out = {}
    ex = LaTrExecutor(latr_train_config(paths, os.path.join(root, "knobs"), SAVE=False),
                      "train", device=DEVICE)
    c = ex.config
    rows = synthetic.read_qa_csv(paths["train"])
    store = ex._adapt_frames()[0]
    kw = dict(max_ocr_element=c.max_ocr_element, max_ocr_length=c.max_ocr_length,
              max_input_length=c.max_q_length, max_output_length=c.max_a_length)
    cache = os.path.join(root, "feature_cache")
    seconds = []
    for _ in range(2):  # a miss (featurize + write), then a hit (memory-mapped load)
        t0 = time.perf_counter()
        cached = LaTrDataset(rows, store, ex.tokenizer, c.base_img_path, cache_dir=cache,
                             **kw).dataset
        seconds.append(time.perf_counter() - t0)
    if not all(isinstance(a, np.memmap) for a in cached.arrays.values()):
        raise AssertionError(f"{phase}: the second build did not load the cache")
    for name, array in ex.train_data.arrays.items():
        if not np.array_equal(np.asarray(cached.arrays[name]), array):
            raise AssertionError(f"{phase}: cached {name} != the fresh build's")
    first = np.arange(TRAIN_BATCH)
    with torch.no_grad():
        fresh = ex.forward_loss(ex._to_device(ex.train_data.gather(first)))
        hit = ex.forward_loss(ex._to_device(cached.gather(first)))
    if not torch.equal(fresh, hit):
        raise AssertionError(f"{phase}: first-step loss {float(hit)} from the cache != "
                             f"{float(fresh)}")
    out["feature_cache"] = {"rows": len(rows), "featurize_s": seconds[0], "load_s": seconds[1],
                            "first_loss": float(fresh)}
    log(f"{phase}: FEATURE_CACHE {len(rows)} rows: featurize + write {seconds[0]:.3f} s, "
        f"load {seconds[1]:.3f} s; arrays equal, first-step loss bit-identical "
        f"({float(fresh):.6f})")

    ex._knob_start = {n: t.detach().clone() for n, t in ex.state.params.items()}
    batches = list(itertools.islice(batch_iterator(ex.train_data, TRAIN_BATCH, shuffle=True,
                                                   seed=SEED + 1, drop_last=True), 4))

    # PROFILE_DIR over a 3-step epoch
    prof = os.path.join(root, "profile")
    marks = {}
    ex.config["NUMWORKERS"] = 0
    reset_launches()
    with profiling.maybe_trace(prof, "train_epoch", cuda=DEVICE.type == "cuda"):
        for b, _ in batches[:3]:
            ex.train_step(b)
        torch.cuda.synchronize()
        marks["steps_done"] = time.perf_counter()
    write_s = time.perf_counter() - marks["steps_done"]
    check_launches(phase, launches(), {"flash_attention": 3 * 48, "sal_fused_attention": 0})
    (trace,) = os.listdir(prof)
    attn = traced_attention_kernels(os.path.join(prof, trace))
    if attn != 3 * 48:
        raise AssertionError(f"{phase}: the trace names the attention kernel {attn} times over "
                             "3 steps, want 3 x 48")
    size_mb = os.path.getsize(os.path.join(prof, trace)) / 2**20
    out["profile_dir"] = {"trace_mb": size_mb, "write_s": write_s, "attention_events": attn}
    log(f"{phase}: PROFILE_DIR 3 steps: trace {size_mb:.1f} MB written in {write_s:.2f} s, "
        f"the attention kernel named {attn} times, as the wrappers counted")

    # DEBUG_NANS: ms a step on against off, then a NaN in one T5 block's output
    def steps_ms():
        return _knob_steps(ex, batches[:1], 0)[1]

    nan_ms = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        check = profiling.NanCheck(ex.model) if mode == "on" else None
        try:
            nan_ms[mode].append(steps_ms())
        finally:
            if check is not None:
                check.close()
    block = f"t5.encoder.block_{T5_BASE['num_encoder_layers'] // 2}"

    def inject(module, args, output):
        output = output.clone()
        output[0, 0, 0] = float("nan")
        return output

    handle = ex.model.get_submodule(block).register_forward_hook(inject)
    check = profiling.NanCheck(ex.model)
    try:
        ex.forward_loss(ex._to_device(batches[0][0]))
        raise AssertionError(f"{phase}: DEBUG_NANS let a NaN in {block}'s output pass")
    except FloatingPointError as e:
        if f"of {block} " not in str(e):
            raise AssertionError(f"{phase}: DEBUG_NANS named another module: {e}") from e
        named = str(e)
    finally:
        check.close()
        handle.remove()
    out["debug_nans"] = {"ms_per_step_off": nan_ms["off"], "ms_per_step_on": nan_ms["on"],
                         "raised": named}
    log(f"{phase}: DEBUG_NANS off {[round(x, 1) for x in nan_ms['off']]} ms a step, on "
        f"{[round(x, 1) for x in nan_ms['on']]} (off, on, on, off); an injected NaN raised "
        f"FloatingPointError: {named}")
    del ex
    torch.cuda.empty_cache()
    return out


def numworkers_phase(paths, root) -> dict:
    """Phase 23's NUMWORKERS, 0 against 2 on full-width LaTr-base (phase 7's
    config), late in the run: a profiler session after its prefetch runs
    may record no CUDA kernel, and one such session is logged."""
    phase = "phase 23"
    out = {}
    ex = LaTrExecutor(latr_train_config(paths, os.path.join(root, "workers"), SAVE=False),
                      "train", device=DEVICE)
    ex._knob_start = {n: t.detach().clone() for n, t in ex.state.params.items()}
    batches = list(itertools.islice(batch_iterator(ex.train_data, TRAIN_BATCH, shuffle=True,
                                                   seed=SEED + 1, drop_last=True), 4))
    # 0 against 2, interleaved, from the same start
    runs = {0: [], 2: []}
    _knob_steps(ex, batches, 0)  # warm-up: the first steps after a reload pay allocations
    for workers in (0, 2, 2, 0):
        runs[workers].append(_knob_steps(ex, batches, workers))
    losses = {w: [r[0] for r in runs[w]] for w in runs}
    if any(l != losses[0][0] for w in losses for l in losses[w]):
        raise AssertionError(f"{phase}: NUMWORKERS losses differ: {losses}")
    ms = {w: [r[1] for r in runs[w]] for w in runs}
    out["numworkers"] = {"ms_per_step_0": ms[0], "ms_per_step_2": ms[2], "losses": losses[0][0]}
    log(f"{phase}: NUMWORKERS 0 {[round(x, 1) for x in ms[0]]} ms a step, 2 "
        f"{[round(x, 1) for x in ms[2]]} (0, 2, 2, 0); 4 losses bit-identical")
    # an observation, not a gate: whether a profiler session right after the
    # prefetch threads records the attention kernel (None: no CUDA kernel)
    q, k, v, bias, mask, causal, scale = serving_shapes()[1]
    after = _split_time("", lambda: fa.fused_attention(q, k, v, bias, mask, causal, scale))
    out["profiler_after_prefetch_device_ms"] = after["device_ms"]
    log(f"{phase}: a profiler session after the NUMWORKERS runs: attention kernel device "
        f"ms {_ms(after['device_ms'])}")
    del ex
    torch.cuda.empty_cache()
    return out


def traced_attention_kernels(path: str) -> int:
    """The device kernels in a Chrome trace whose name is the attention
    kernel's CUDA symbol."""
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events
               if e.get("cat") == "kernel" and "attn::attention_" in str(e.get("name", "")))


def _gb(x) -> str:
    return "not measured" if x is None else f"{x:.2f} GB"


def _head_slices(h: int, tp: int):
    size = h // tp
    return [slice(r * size, (r + 1) * size) for r in range(tp)]


def tp_slice_phase() -> dict:
    """Phase 24: both kernels at the head slices a TP rank gives them: each
    rank's call on its heads of the models' (B, L, H, D) storage (and its
    slice of the bias / the SaL tables) equals the full call's heads bit for
    bit; time, device time, bound and SDPA on the slice beside the full
    call's."""
    phase = "phase 24"
    rows = []
    for name, (q, k, v, bias, mask, causal, scale) in zip(("vit", "t5_encoder"),
                                                          serving_shapes()):
        full = fa.fused_attention(q, k, v, bias, mask, causal, scale)
        for tp in (2, 4):
            for heads in _head_slices(q.shape[1], tp):
                part = fa.fused_attention(q[:, heads], k[:, heads], v[:, heads],
                                          None if bias is None else bias[:, heads], mask,
                                          causal, scale)
                torch.cuda.synchronize()
                if not torch.equal(part, full[:, heads]):
                    raise AssertionError(f"{phase}: {name} tp={tp} heads {heads} != the full "
                                         "call's slice")
            heads = _head_slices(q.shape[1], tp)[0]
            args = (q[:, heads], k[:, heads], v[:, heads],
                    None if bias is None else bias[:, heads], mask, causal, scale)
            moved, flops = _qkvo_bytes_flops(args[0], args[1])
            moved += sum(0 if t is None else t.numel() * 4 for t in (args[3], mask))
            bound_ms, bound_by = _bound(moved, flops)
            kernel = lambda: fa.fused_attention(*args)
            library = _sdpa(*args[:5], scale)
            plain = lambda: attn_mod.reference_attention(*args)
            row = {"shape": f"{name}_tp{tp}", "q": list(args[0].shape), **_time("ms", kernel),
                   **_time("plain_ms", plain), **_time("library_ms", library),
                   **_split_time("", kernel), **_split_time("library_", library),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            rows.append(row)
            log(f"{phase}: {json.dumps(row)}")
    q, k, v, bias1d, cb, cell, mask = sal_serving_shape()
    full = sfa.sal_fused_attention(q, k, v, bias1d, cb, cell, mask)
    for tp in (2, 4):
        for heads in _head_slices(q.shape[1], tp):
            part = sfa.sal_fused_attention(q[:, heads], k[:, heads], v[:, heads], bias1d[heads],
                                           cb[heads], cell, mask)
            torch.cuda.synchronize()
            if not torch.equal(part, full[:, heads]):
                raise AssertionError(f"{phase}: SaL tp={tp} heads {heads} != the full call's")
        heads = _head_slices(q.shape[1], tp)[0]
        args = (q[:, heads], k[:, heads], v[:, heads], bias1d[heads], cb[heads], cell, mask)
        moved, flops = _qkvo_bytes_flops(args[0], args[1])
        moved += sum(t.numel() * t.element_size() for t in args[3:])
        bound_ms, bound_by = _bound(moved, flops)
        kernel = lambda: sfa.sal_fused_attention(*args)
        library = _sdpa(*args[:3], sfa.materialize_sal_bias(*args[3:6]), mask, None)
        plain = lambda: sfa.sal_reference_attention(*args)
        row = {"shape": f"sal_encoder_tp{tp}", "q": list(args[0].shape), **_time("ms", kernel),
               **_time("plain_ms", plain), **_time("library_ms", library),
               **_split_time("", kernel), **_split_time("library_", library),
               "library_excludes": "bias materialization", "bound_ms": bound_ms,
               "bound_by": bound_by}
        rows.append(row)
        log(f"{phase}: {json.dumps(row)}")
    log(f"{phase}: every head-sliced call (tp 2 and 4, ViT, T5 encoder, SaL) == the full "
        "call's heads bit for bit")
    return {"shapes": rows}


def mesh_fixture(root):
    """Phase 25's small LaTr fixture (8 rows; its first 4 are the gated
    batch) and SaL fixture."""
    latr = synthetic.make_latr_fixture(os.path.join(root, "mesh_latr"), n_images=4,
                                       n_rows=2 * MESH_BATCH, image_hw=FULL["vit_image_size"])
    sal = synthetic.make_sal_fixture(os.path.join(root, "mesh_sal"), n_images=4,
                                     n_rows=2 * MESH_BATCH, n_ocr_words=SAL_OCR_ELEMENTS,
                                     region_hidden=SAL_FULL["obj_hidden"])
    return latr, sal


def _one_process(ex_cls, config, steps: int, beams: int) -> dict:
    """The reference of a mesh run: the same executor in this process, its
    greedy and beam rows at the seeded init, then ``steps`` steps on the
    same first rows; the masters after the first."""
    from phoneme_vqa_torch.dryrun import _beam_rows

    ex = ex_cls(config, "train", device=DEVICE)
    # decoded at the seeded init, as run_mesh decodes before its steps
    tb = ex._device_batch(ex.val_data.gather(np.arange(int(config.EVAL_BATCH_SIZE))))
    with torch.inference_mode():
        rows, seen = greedy_recorded(ex.model, tb, int(config.max_eval_length))
    beam = _beam_rows(ex, int(config.max_eval_length), beams) if beams else None
    batch = ex.train_data.gather(np.arange(int(config.TRAIN_BATCH_SIZE)))
    losses, after_first = [], None
    for i in range(steps):
        losses.append(float(ex.train_step(batch)))
        if i == 0:
            after_first = {n: t.detach().to("cpu", copy=True) for n, t in ex.state.params.items()}
    return {"ex": ex, "losses": losses, "params": after_first, "rows": rows.tolist(),
            "seen": seen, "beam_rows": beam}


def _gate_mesh(phase, what, record, ref, lr) -> dict:
    """A mesh run against one process: the first loss within LOSS_RTOL,
    every master within 2 lr (a first adam step's bound where a gradient
    at rounding level flips its sign) plus the f32 rounding of the master
    itself, all but 0.1 % within rtol 1e-4 / atol 2e-5, greedy rows
    identical but at reference top-2 ties within TIE_MARGIN, beam rows
    identical."""
    loss_gap = abs(record["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    if loss_gap > LOSS_RTOL:
        raise AssertionError(f"{phase} {what}: loss {record['losses'][0]} vs one process "
                             f"{ref['losses'][0]}")
    out = {"loss": record["losses"][0], "loss_one_process": ref["losses"][0],
           "loss_rel_gap": loss_gap}
    if "checkpoint" in record:
        saved = torch.load(record["checkpoint"], map_location="cpu", weights_only=True)
        worst, worst_excess, n_far, n_all = 0.0, 0.0, 0, 0
        ulp = torch.finfo(torch.float32).eps
        for name, want in ref["params"].items():
            want = want.detach().float()
            gap = (saved["params"][name].detach().float() - want).abs()
            worst = max(worst, float(gap.max()))
            worst_excess = max(worst_excess, float((gap - 2 * lr - 2 * ulp * want.abs()).max()))
            n_far += int((gap > 2e-5 + 1e-4 * want.abs()).sum())
            n_all += gap.numel()
        if worst_excess > 0 or n_far > 1e-3 * n_all:
            raise AssertionError(f"{phase} {what}: masters part by up to {worst} (2 lr = "
                                 f"{2 * lr}, past it by {worst_excess}), {n_far}/{n_all} past "
                                 "rtol 1e-4 / atol 2e-5")
        out.update(master_max_gap=worst, masters_past_tol=n_far, masters=n_all, lr=lr)
        if not (record["restored_bit_for_bit"] and record["restored_opt_bit_for_bit"]):
            raise AssertionError(f"{phase} {what}: the mesh checkpoint did not restore on the "
                                 "mesh bit for bit")
        ex = ref["ex"]
        if not ex._try_full_resume(saved):
            raise AssertionError(f"{phase} {what}: the mesh checkpoint does not fit one process")
        for name, value in saved["params"].items():
            if not torch.equal(ex.state.params[name].cpu(), value):
                raise AssertionError(f"{phase} {what}: {name} restored in one process != file")
        out["checkpoint_restores_in_one_process"] = True
    if ref["rows"] is not None:
        parted, margin = tie_parted(phase, record["rows"], ref["rows"], ref["seen"])
        out.update(greedy_rows_parted=parted, greedy_parted_margin=margin)
    if ref["beam_rows"] is not None and record["beam_rows"] != ref["beam_rows"]:
        raise AssertionError(f"{phase} {what}: beam rows differ from one process's")
    return out


# phase 26: serving over a mesh at full depth, from phase 25's processes
MESH_SERVE_REQUESTS = 32
MESH_SERVE_WAVES = [1, 3]  # then the rest: buckets 1 (2 at data 2), 4, 32
FULL_DEPTH = dict(num_encoder_layers=T5_BASE["num_encoder_layers"],
                  num_t5_decoder_layers=T5_BASE["num_t5_decoder_layers"],
                  vit_num_layers=FULL["vit_num_layers"])


def mesh_requests(n):
    """Phase 26's requests, over the mesh fixture's 4 images."""
    return [(float(i % 4), synthetic.QUESTIONS[i % len(synthetic.QUESTIONS)]) for i in range(n)]


def served_reference(config, reqs) -> list:
    """Phase 26's reference: this process's serve-mode executor on the same
    seeded weights, its eager greedy rows of ``reqs`` in batches of BATCH
    with every step's logits: [(rows, logits a step)] a batch."""
    ex = serve_executor(config)
    out = []
    with torch.inference_mode():
        for batch, n in batch_iterator(request_dataset(ex, reqs), BATCH, pad_final=True):
            rows, seen = greedy_recorded(ex.model, ex._device_batch(batch), MAX_ANSWER)
            out.append((rows[:n].tolist(), [tuple(h[:n] for h in step) for step in seen]))
    del ex
    gc_cuda()
    return out


def serve_specs(reqs, config: dict, engines=("gathered",), buckets=BUCKETS,
                waves=MESH_SERVE_WAVES) -> list:
    """``run_mesh``'s serve specs for phase 26: token rows, MAX_ANSWER, the
    gathered engine in ``waves`` over ``buckets`` (``gathered_eager``: the
    same through the executor's eager generate, the graphs' yardstick) and
    the continuous engine at BATCH slots (phase 15's 4 x 16)."""
    common = dict(requests=[list(r) for r in reqs], config=config, rows=True,
                  max_answer=MAX_ANSWER)
    gathered = dict(common, batch_size=BATCH, buckets=buckets, waves=waves, max_wait_ms=20)
    specs = {"gathered": gathered, "gathered_eager": dict(gathered, eager_decode=True),
             "continuous": dict(common, engine="continuous", num_slots=BATCH,
                                prefill_chunk=16, horizon=4)}
    return [specs[e] for e in engines]


def check_served(phase, what, served, engines, ref, per_batch: dict, decode: str,
                 same_chunks: bool = False) -> dict:
    """One mesh run's served specs against ``ref`` (``served_reference``):
    rows identical but at top-2 ties within TIE_MARGIN, every rank's
    launches ``per_batch`` times its batches (gathered) or prefill chunks
    (continuous), the decode ``stats()`` names (``decode``; ``eager`` for
    ``gathered_eager``), with ``same_chunks`` (a model axis) every rank's
    count of decode chunks equal; ms a batch and answers/s a rank, each
    bucket's capture s and graph-decoder bytes."""
    out = {}
    for engine, ranks in zip(engines, served):
        rows, parted, margin = ranks[0]["answers"], 0, 0.0
        for j, (ref_rows, seen) in enumerate(ref):
            p, m = tie_parted(f"{phase} {what} {engine}", rows[j * BATCH:j * BATCH + len(ref_rows)],
                              ref_rows, seen)
            parted, margin = parted + p, max(margin, m)
        want = "eager" if engine == "gathered_eager" else decode
        per_rank = []
        for r in ranks:
            st = r["stats"]
            units = st["prefill_chunks"] if engine == "continuous" else st["batches"]
            check_launches(f"{phase} {what} {engine} rank {r['rank']}", r["launches"],
                           {k: n * units for k, n in per_batch.items()})
            if st["decode"] != want:
                raise AssertionError(f"{phase} {what} {engine}: decode {st['decode_reason']!r}, "
                                     f"want {want}")
            busy_s = st["dispatch_s"] if engine == "continuous" else st["decode_s"]
            steps = st["decode_dispatches"] if engine == "continuous" else st["batches"]
            per_rank.append({"rank": r["rank"], "units": units, "launches": r["launches"],
                             "ms_per_" + ("dispatch" if engine == "continuous" else "batch"):
                                 1e3 * busy_s / max(steps, 1),
                             "answers_per_s": len(rows) / r["wall_s"],
                             "engine_start_s": r["engine_start_s"],
                             "capture_s": r["capture_s"], "decoder_bytes": r["decoder_bytes"],
                             "decode_chunks": st.get("decode_chunks"),
                             "bucket_batches": st.get("bucket_batches")})
        chunks = [p["decode_chunks"] for p in per_rank]
        if same_chunks and engine == "gathered" and len(set(chunks)) != 1:
            raise AssertionError(f"{phase} {what}: the model ranks ran {chunks} decode chunks")
        out[engine] = {"rows": len(rows), "rows_parted": parted, "parted_margin": margin,
                       "decode_reason": ranks[0]["stats"]["decode_reason"], "ranks": per_rank,
                       "seconds_rank0": ranks[0].get("executor_build_s", 0.0)
                       + ranks[0]["engine_start_s"] + ranks[0]["wall_s"]}
        log(f"phase 26: {what}, {engine} engine ({card_line()}): {len(rows)} rows, parted "
            f"{parted} at ties (margin {margin:.2e}); decode {out[engine]['decode_reason']!r}; "
            + "; ".join(f"rank {p['rank']}: launches {p['launches']} over {p['units']} "
                        + ("prefill chunks" if engine == "continuous" else "batches") + ", "
                        + ", ".join(f"{k} {v:.3f}" for k, v in p.items() if k.startswith("ms_"))
                        + f" ms, {p['answers_per_s']:.3f} answers/s, buckets {p['bucket_batches']}"
                        + f", decode chunks {p['decode_chunks']}, capture s {p['capture_s']}, "
                        f"graph-decoder bytes {p['decoder_bytes']}"
                        for p in per_rank))
    if "gathered_eager" in out and "gathered" in out:
        e, g = out["gathered_eager"]["ranks"], out["gathered"]["ranks"]
        log(f"phase 26: {what}, eager against graphs in one call ({card_line()}): "
            + "; ".join(f"rank {a['rank']}: {a['ms_per_batch']:.3f} against {b['ms_per_batch']:.3f}"
                        f" ms a batch, {a['answers_per_s']:.3f} against {b['answers_per_s']:.3f} "
                        f"answers/s, capture s {b['capture_s']}, graph-decoder bytes "
                        f"{b['decoder_bytes']}" for a, b in zip(e, g)))
    return out


def mesh_phase(root) -> dict:
    """Phase 25: the mesh lifecycle at full width, MESH_LAYERS deep, through
    ``phoneme_vqa_torch.dryrun.run_mesh`` (f32, dropout 0, batch 4): (a) one
    NCCL rank a card with MESH {data: -1}; (b) two gloo processes on one card
    with MESH {model: 2}, {data: 2} and {data: 2, zero1: true} (the gather
    and reduce-scatter as gloo all-reduces; with 2 or 4 cards, NCCL across them
    at {model: 2} and {data: 2, model: 2, zero1: true} too); and a SaL-base
    step at {model: 2} (the head-sliced 2D tables). Each against the same
    steps in this process. Phase 26 serves from the same processes after
    their steps (module docstring), against ``served_reference``."""
    from phoneme_vqa_torch.dryrun import run_mesh

    phase = "phase 25"
    latr_paths, sal_paths = mesh_fixture(root)
    keys = dict(DTYPE="float32", dropout_rate=0.0, TRAIN_BATCH_SIZE=MESH_BATCH,
                EVAL_BATCH_SIZE=2, max_eval_length=MESH_ANSWER, num_encoder_layers=MESH_LAYERS,
                num_t5_decoder_layers=MESH_LAYERS, vit_num_layers=MESH_LAYERS)
    steps = 3
    latr = lambda name, **over: latr_train_config(latr_paths, os.path.join(root, name),
                                                  **keys, **over)
    t26 = time.perf_counter()
    reqs = mesh_requests(MESH_SERVE_REQUESTS)
    served_ref = served_reference(Config(dict(latr("mesh_serve_ref"), **FULL_DEPTH)), reqs)
    ref_s = time.perf_counter() - t26
    encode = {"flash_attention": FULL["vit_num_layers"] + T5_BASE["num_encoder_layers"],
              "sal_fused_attention": 0}
    serving = {}
    ref = _one_process(LaTrExecutor, latr("mesh_ref"), steps, beams=2)
    lr = float(ref["ex"]._lr_schedule(0))
    out = {}
    cards = torch.cuda.device_count()
    first = "nccl" if DEVICE.type == "cuda" else "gloo"
    # (name, title, MESH, processes, backend, beam search); a machine with
    # more cards also runs NCCL meshes across them
    runs = [("a", f"{cards} {first} rank(s), data {cards}", {"data": -1}, cards, first, False)]
    if first == "nccl" and cards >= 2:
        runs.append(("nccl_model", "2 NCCL ranks on 2 cards, model 2", {"model": 2}, 2, "nccl",
                     True))
    if first == "nccl" and cards >= 4:
        runs.append(("nccl_data_model_zero1", "4 NCCL ranks on 4 cards, data 2 x model 2, "
                     "ZeRO-1", {"data": 2, "model": 2, "zero1": True}, 4, "nccl", False))
    if len(runs) == 1:
        log(f"{phase}: {cards} card(s): the NCCL meshes across 2 and 4 cards need as many")
    runs += [("b_model", "2 gloo processes on one card, model 2", {"model": 2}, 2, "gloo", True),
             ("b_data", "2 gloo processes on one card, data 2", {"data": 2}, 2, "gloo", False),
             ("b_data_zero1", "2 gloo processes on one card, data 2, ZeRO-1",
              {"data": 2, "zero1": True}, 2, "gloo", False)]
    # phase 26's engines a run, and the decode each must report: each rank
    # replays its own graphs at data 2 and over NCCL at model 2 (the model
    # axis's collectives captured inside); over gloo at model 2 nothing is
    # captured. The eager yardstick first, in the same processes
    serve_runs = {"nccl_model": (("gathered_eager", "gathered", "continuous"), "graphs"),
                  "b_model": (("gathered", "continuous"), "eager"),
                  "b_data": (("gathered_eager", "gathered"), "graphs")}
    for key, what, mesh, world, backend, beam in runs:
        t0 = time.perf_counter()
        engines, decode = serve_runs.get(key, ((), None))
        record = run_mesh(dict(latr(f"mesh_{key}", MESH=mesh)), world, device=DEVICE.type,
                          backend=backend, steps=steps, beams=2 if beam else 0, timeout=600,
                          serve=serve_specs(reqs, FULL_DEPTH, engines) if engines else None)
        if engines:
            serving[key] = check_served("phase 26", f"LaTr-base {what}", record["serve"], engines,
                                        served_ref, encode, decode,
                                        same_chunks=mesh.get("model", 1) > 1)
        res = _gate_mesh(phase, what, record, dict(ref, beam_rows=ref["beam_rows"] if beam
                                                   else None), lr)
        for r in record["ranks"]:  # every ViT, encoder, decoder self and cross layer
            check_launches(f"{phase} {what} rank {r['rank']}", r["launches_per_step"],
                           {"flash_attention": 4 * MESH_LAYERS, "sal_fused_attention": 0})
        res.update(what=what, seconds=time.perf_counter() - t0, ranks=record["ranks"])
        out[key] = res
        note = (" (a world of one: the same DeviceMesh, plan and optimizer path, every "
                "collective over one rank)" if world == 1 else "")
        log(f"{phase}: LaTr-base {what}{note}: loss {res['loss']:.6f} vs "
            f"{res['loss_one_process']:.6f}; masters within {res['master_max_gap']:.2e}, "
            "checkpoint mesh -> mesh and -> one process bit for bit; "
            + ("beam rows identical; " if beam else "")
            + f"greedy rows parted {res['greedy_rows_parted']} (margin {res['greedy_parted_margin']:.2e}); "
            + "; ".join(f"rank {r['rank']} ({r['backend']}): {np.median(r['ms_per_step']):.1f} ms "
                        f"a step, peak {_gb(r['peak_gb'])}, optimizer state "
                        f"{r['opt_state_bytes'] / 1e9:.3f} GB, launches {r['launches_per_step']}"
                        for r in record["ranks"])
            + f" ({res['seconds']:.1f} s)")
    del ref, served_ref
    torch.cuda.empty_cache()
    sal_cfg = phoneme_train_config(sal_paths, os.path.join(root, "mesh_sal_ref"),
                                   EXECUTOR="SaL_Executor", MODEL_CLASS="SaL",
                                   MODEL_MOD_CONFIG_CLASS="SaL_config", **keys)
    sal_depth = {k: FULL_DEPTH[k] for k in ("num_encoder_layers", "num_t5_decoder_layers")}
    t0 = time.perf_counter()
    sal_served_ref = served_reference(Config(dict(sal_cfg, **sal_depth)), reqs[:BATCH])
    ref_s += time.perf_counter() - t0
    sal_ref = _one_process(SaLExecutor, sal_cfg, 1, beams=0)
    t0 = time.perf_counter()
    record = run_mesh(dict(sal_cfg, SAVE_PATH=os.path.join(root, "mesh_sal"),
                           MESH={"model": 2}), 2, device=DEVICE.type, backend="gloo", steps=1,
                      beams=0, checkpoint=True, timeout=600,
                      serve=serve_specs(reqs[:BATCH], sal_depth, buckets=[BATCH], waves=()))
    serving["sal_model2"] = check_served(
        "phase 26", "SaL-base 2 gloo processes on one card, model 2", record["serve"],
        ("gathered",), sal_served_ref, {"flash_attention": 0,
                                        "sal_fused_attention": T5_BASE["num_encoder_layers"]},
        "eager", same_chunks=True)
    res = _gate_mesh(phase, "SaL-base, model 2", record,
                     dict(sal_ref, rows=None), float(sal_ref["ex"]._lr_schedule(0)))
    per_rank = record["ranks"][0]["launches_per_step"]
    # the encoder's layers through the SaL kernel, the decoder's self and
    # cross layers through the attention kernel, at 6 heads a call
    check_launches(phase, per_rank, {"flash_attention": 2 * MESH_LAYERS,
                                     "sal_fused_attention": MESH_LAYERS})
    res.update(seconds=time.perf_counter() - t0, ranks=record["ranks"])
    out["sal_model2"] = res
    log(f"{phase}: SaL-base model 2 (gloo, one card): loss {res['loss']:.6f} vs "
        f"{res['loss_one_process']:.6f}, masters within {res['master_max_gap']:.2e}, "
        f"launches a rank a step {per_rank} (6 heads a call, {MESH_LAYERS} layers); "
        + "; ".join(f"rank {r['rank']}: peak {_gb(r['peak_gb'])}, optimizer state "
                    f"{r['opt_state_bytes'] / 1e9:.3f} GB" for r in record["ranks"])
        + f" ({res['seconds']:.1f} s)")
    del sal_ref, sal_served_ref
    torch.cuda.empty_cache()
    seconds = ref_s + sum(e["seconds_rank0"] for run in serving.values() for e in run.values())
    out["serving"] = dict(serving, phase26_s=seconds, reference_s=ref_s)
    log(f"phase 26: serving over a mesh took {seconds:.1f} s ({ref_s:.1f} s of it this process's "
        "reference rows; the rest rank 0's executor build, engine start and serving in phase "
        f"25's processes); {json.dumps(out['serving'])}")
    return out


def served_mesh_launches(across: dict, kernel: str) -> dict:
    """Phase 26's launches of ``kernel`` a rank a batch (gathered) or
    prefill chunk (continuous), by run and engine."""
    return {f"{key} {engine}": [r["launches"][kernel] / max(r["units"], 1) for r in e["ranks"]]
            for key, run in across["mesh"]["serving"].items() if isinstance(run, dict)
            for engine, e in run.items()}


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
    t_start = time.perf_counter()
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

    # phases 24 and 23 (but NUMWORKERS) first: later in a long process
    # torch.profiler drops CUDA kernel records (phase 24's device times
    # came out empty and phase 23's trace held 142-143 of its 144 launches
    # there; a fresh process held all: PERF.md §7)
    tp_slices = tp_slice_phase()
    with tempfile.TemporaryDirectory() as early:
        knobs = knobs_phase(train_fixture(early), early)

    worst = check_kernel_grid()
    sal_worst = check_sal_kernel_grid()
    grads = check_kernel_grads()
    n_t5 = T5_BASE["num_encoder_layers"]
    n_dec = T5_BASE["num_t5_decoder_layers"]
    encode_launches = FULL["vit_num_layers"] + n_t5  # every ViT and T5 encoder layer
    with tempfile.TemporaryDirectory() as root:
        def save(paths, name):
            return os.path.join(paths["root"], f"{name}_ckpts")

        served, e2e = run_family(
            "4", "LaTr-base",
            lambda paths, dtype: serve_executor(latr_train_config(paths, save(paths, "latr"),
                                                                  DTYPE=dtype)),
            latr_fixture, {"flash_attention": encode_launches, "sal_fused_attention": 0},
            # teacher forcing at T=20 >= 16: ViT + encoder + decoder self + cross
            # layers; then generate's encode: ViT + encoder again
            {"flash_attention": 2 * encode_launches + 2 * n_dec, "sal_fused_attention": 0},
            os.path.join(root, "latr"),
        )
        sal_keys = dict(EXECUTOR="SaL_Executor", MODEL_CLASS="SaL",
                        MODEL_MOD_CONFIG_CLASS="SaL_config")
        sal_served, sal_e2e = run_family(
            "4b", "SaL-base",
            lambda paths, dtype: serve_executor(phoneme_train_config(
                paths, save(paths, "sal"), DTYPE=dtype, **sal_keys)),
            sal_fixture, {"flash_attention": 0, "sal_fused_attention": n_t5},
            # teacher forcing: the encoder through the SaL kernel, decoder self
            # and cross layers through the attention kernel; then generate's
            # encode through the SaL kernel again
            {"flash_attention": 2 * n_dec, "sal_fused_attention": 2 * n_t5},
            os.path.join(root, "sal"),
        )
        n_custom = PSAL_FULL["num_decoder_layers"]
        psal_served, psal_e2e = run_family(
            "4c", "PhonemeSaL-base",
            lambda paths, dtype: serve_executor(phoneme_train_config(
                paths, save(paths, "psal"), DTYPE=dtype)),
            sal_fixture, {"flash_attention": 0, "sal_fused_attention": n_t5},
            # teacher forcing: the encoder through the SaL kernel, the custom
            # decoder's self and cross layers through the attention kernel;
            # then generate's encode through the SaL kernel again
            {"flash_attention": 2 * n_custom, "sal_fused_attention": 2 * n_t5},
            os.path.join(root, "psal"), max_answer=PSAL_ANSWER, vocab=len(PhonemeTokenizer()),
        )
        structured, vocab_path, ann_path = structured_tokenizer(root)
        structured_keys = dict(vocab_path=vocab_path, annotation_paths=[ann_path])
        platr_served, platr_e2e = run_family(
            "4d", "PhonemeLaTr-base",
            lambda paths, dtype: serve_executor(family_train_config(
                paths, save(paths, "platr"), "phoneme_latr", DTYPE=dtype, **structured_keys)),
            latr_fixture, {"flash_attention": encode_launches, "sal_fused_attention": 0},
            # teacher forcing: ViT + encoder, the triple decoder's self and
            # cross layers (T=20 >= 16); then generate's encode again
            {"flash_attention": 2 * encode_launches + 2 * n_custom, "sal_fused_attention": 0},
            os.path.join(root, "platr"),
            vocab=(structured.onset_size, structured.rhyme_size, structured.tone_size),
        )
        prestu_served, prestu_e2e = run_family(
            "4e", "PreSTU-base",
            lambda paths, dtype: serve_executor(family_train_config(
                paths, save(paths, "prestu"), "prestu", DTYPE=dtype)),
            latr_fixture, {"flash_attention": encode_launches, "sal_fused_attention": 0},
            {"flash_attention": 2 * encode_launches + 2 * n_dec, "sal_fused_attention": 0},
            os.path.join(root, "prestu"),
        )
        shapes = time_kernel()
        sal_shape = time_sal_kernel()
        sal_choice = time_sal_fused_choice()
        ablations = time_ablations()
        train_shapes = time_train_shapes(training_shapes(torch.bfloat16))
        psal_shapes = time_train_shapes(phoneme_training_shapes(torch.bfloat16))
        family_shapes = time_train_shapes(latr_family_training_shapes(torch.bfloat16))
        sal_train_shape = time_sal_train_shape()
        # every encoder, decoder self and cross layer recomputes in the backward
        recompute = sum(n_t5 * r["recompute_backward_ms"] for r in train_shapes
                        if "recompute_backward_ms" in r)
        paths = train_fixture(root)
        trained = train_latr(paths, recompute)
        train_f32 = check_train_f32("phase 7b", LaTrExecutor(latr_train_config(
            paths, os.path.join(paths["root"], "f32"), DTYPE="float32", TRAIN_BATCH_SIZE=4,
            SAVE=False), "train", device=DEVICE), trained["launches_per_step"])
        shutil.rmtree(os.path.join(paths["root"], "ckpts"))  # phase 7's 2 x 3.8 GB
        psal_paths = sal_train_fixture(root)
        psal_trained = train_phoneme_sal(psal_paths)
        psal_f32 = check_train_f32("phase 8b", PhonemeSaLExecutor(phoneme_train_config(
            psal_paths, os.path.join(psal_paths["root"], "f32"), DTYPE="float32",
            TRAIN_BATCH_SIZE=4, SAVE=False), "train", device=DEVICE),
            psal_trained["launches_per_step"])
        # 8c: the stock SaLExecutor at configs/sal.yaml's widths (answers of 40
        # backbone ids): 12 SaL + 24 attention launches a step
        sal_steps = train_steps("phase 8c", "SaL-base (stock T5 decoder)", SaLExecutor,
                                phoneme_train_config(psal_paths, os.path.join(
                                    psal_paths["root"], "sal_ckpts"), EXECUTOR="SaL_Executor",
                                    MODEL_CLASS="SaL", MODEL_MOD_CONFIG_CLASS="SaL_config",
                                    SAVE=False),
                                {"flash_attention": 2 * n_dec, "sal_fused_attention": n_t5},
                                vit_trains=False)
        shutil.rmtree(os.path.join(psal_paths["root"], "psal_ckpts"))

        # the PhonemeLaTr / PreSTU families on phase 7's fixture
        encode_step = {"flash_attention": encode_launches, "sal_fused_attention": 0}
        custom_step = {"flash_attention": encode_launches + 2 * n_custom,
                       "sal_fused_attention": 0}  # + the decoder's self and cross layers
        prestu_step = {"flash_attention": encode_launches + 2 * n_dec, "sal_fused_attention": 0}
        platr_trained = train_and_predict(
            "phase 9", "PhonemeLaTr-base", PhonemeLaTrExecutor, family_train_config(
                paths, os.path.join(paths["root"], "platr_ckpts"), "phoneme_latr",
                **structured_keys), custom_step, encode_step)
        # 9b holds PhonemeLaTr's f32 step to the yardstick without dropout.
        # With the preset's dropout 0.1 the kernels' ~1e-7 a call flips a few
        # of the triple decoder's ReLU units at their kink, which moves single
        # gradients of its last layers by ~1e-3 of their norm: that step's
        # gaps are measured and printed; its loss, kernel calls and 2-lr bound
        # are held as in every f32 step
        platr_f32 = {f"dropout_{rate}": check_train_f32(
            "phase 9b", PhonemeLaTrExecutor(family_train_config(
                paths, os.path.join(paths["root"], "f32"), "phoneme_latr", DTYPE="float32",
                TRAIN_BATCH_SIZE=4, SAVE=False, dropout_rate=rate, **structured_keys), "train",
                device=DEVICE), custom_step, gate_grads=rate == 0.0) for rate in (0.0, 0.1)}
        shutil.rmtree(os.path.join(paths["root"], "platr_ckpts"))
        # the customized presets' answer tokenizer: BPE of up to 3000 ids,
        # trained on the fixture's answers
        answer_keys = {"DecodeTokenizer": "BPE_Tokenizer", "bpe_step": 1000,
                       "max_vocab_size": 3000,
                       "vocab_save_path": os.path.join(paths["root"], "bpevocab.json")}
        steps_9c = {}
        for kind, title, ex_cls, per_step_9c, keys in (
                ("customized_latr", "CustomizedLaTr-base", CustomizedLaTrExecutor, custom_step,
                 answer_keys),
                ("prestu", "PreSTU-base", PreSTUExecutor, prestu_step, {}),
                ("customized_prestu", "CustomizedPreSTU-base", CustomizedPreSTUExecutor,
                 custom_step, answer_keys),
                ("phoneme_prestu", "PhonemePreSTU-base", PhonemePreSTUExecutor, custom_step,
                 structured_keys)):
            steps_9c[kind] = train_steps(
                "phase 9c", title, ex_cls, family_train_config(
                    paths, os.path.join(paths["root"], kind), kind, SAVE=False, **keys),
                per_step_9c, vit_trains=kind == "prestu")
        prestu_f32 = check_train_f32("phase 9d", PreSTUExecutor(family_train_config(
            paths, os.path.join(paths["root"], "f32"), "prestu", DTYPE="float32",
            TRAIN_BATCH_SIZE=4, SAVE=False), "train", device=DEVICE), prestu_step)

        # phases 10-13: the decode variants, each path's launches counted
        sal_encode = {"flash_attention": 0, "sal_fused_attention": n_t5}
        variants = {"beam": {
            "phoneme_latr": beam_phase(
                "PhonemeLaTr-base", lambda dtype: PhonemeLaTrExecutor(family_train_config(
                    paths, os.path.join(paths["root"], "beam"), "phoneme_latr", DTYPE=dtype,
                    SAVE=False, isgreedy=False, num_beam=NUM_BEAM, **structured_keys), "train",
                    device=DEVICE), MAX_ANSWER, encode_step, serve_c1=True),
            "phoneme_sal": beam_phase(
                "PhonemeSaL-base", lambda dtype: PhonemeSaLExecutor(phoneme_train_config(
                    psal_paths, os.path.join(psal_paths["root"], "beam"), DTYPE=dtype, SAVE=False,
                    isgreedy=False, num_beam=NUM_BEAM), "train", device=DEVICE), PSAL_ANSWER,
                sal_encode)}}
        variants["speculative"] = speculative_phase(paths, paths["root"])
        variants["pool"] = {
            "latr": pool_phase("LaTr-base", lambda dtype: LaTrExecutor(latr_train_config(
                paths, os.path.join(paths["root"], "pool"), DTYPE=dtype, SAVE=False), "train",
                device=DEVICE), encode_step),
            "phoneme_latr": pool_phase("PhonemeLaTr-base", lambda dtype: PhonemeLaTrExecutor(
                family_train_config(paths, os.path.join(paths["root"], "pool"), "phoneme_latr",
                                    DTYPE=dtype, SAVE=False, **structured_keys), "train",
                device=DEVICE), encode_step)}
        variants["sampling"] = sampling_phase(paths, paths["root"])

        # phases 14-17: the online serving engines, on phase 7's fixture
        # (LaTr family) and phase 8's (PhonemeSaL)
        def latr_ex(p, dtype):
            return serve_executor(latr_train_config(p, save(p, "serve_latr"), DTYPE=dtype))

        engines = {"gathered": {
            "latr": gathered_phase("LaTr-base", latr_ex, paths, encode_step),
            "phoneme_latr": gathered_phase(
                "PhonemeLaTr-base", lambda p, dtype: serve_executor(family_train_config(
                    p, save(p, "serve_platr"), "phoneme_latr", DTYPE=dtype, **structured_keys)),
                paths, encode_step)}}
        cont_latr = continuous_phase("LaTr-base", latr_ex, paths, encode_step, CONT_GRID)
        best = tuple(int(x) for x in cont_latr["best"].split("x"))
        engines["continuous"] = {
            "latr": cont_latr,
            "phoneme_sal": continuous_phase(
                "PhonemeSaL-base", lambda p, dtype: serve_executor(phoneme_train_config(
                    p, save(p, "serve_psal"), DTYPE=dtype)), psal_paths, sal_encode, [best],
                max_answer=PSAL_ANSWER)}
        engines["faults"] = fault_phase(paths, root)
        engines["cli"] = cli_phase(paths, root)

        # phases 18-22: fine-tuning from pretrained weights
        finetune = {
            "import": import_phase(root, encode_step, {
                "flash_attention": 2 * encode_launches + 2 * n_dec, "sal_fused_attention": 0}),
            "converter": converter_phase(psal_paths, root),
            "lora": lora_phase(paths, root, encode_step, trained),
            "remat": remat_phase(paths, psal_paths, root, encode_step,
                                 {"flash_attention": 2 * n_dec, "sal_fused_attention": n_t5}),
            "vit_cache": vit_cache_phase(root, encode_step)}

        # phase 23's NUMWORKERS (24 and the rest of 23 ran after phase 2),
        # then 25: training over a (data, model) mesh
        knobs.update(numworkers_phase(paths, root))
        across = {"knobs": knobs, "tp_slices": tp_slices, "mesh": mesh_phase(root)}

    per_batch = lambda key: 12 * shapes[0][key] + 12 * shapes[1][key]
    per_step = lambda key: 12 * sum(r[key] for r in train_shapes)
    # a PhonemeLaTr (or CustomizedLaTr, CustomizedPreSTU, PhonemePreSTU) step:
    # the frozen ViT's and the encoder's 12 layers each (phase-6d LaTr rows)
    # and the decoder's 4 self and 4 cross layers; a PreSTU step: the ViT
    # under gradients and the encoder, decoder self and cross rows, 12 each
    vit_row, enc_row, dec_row, cross_row = train_shapes
    fam_self, fam_cross, vit_train = family_shapes
    triple_step = lambda key: (n_t5 * (vit_row[key] + enc_row[key])
                               + n_custom * (fam_self[key] + fam_cross[key]))
    prestu_step_ms = lambda key: n_t5 * sum(r[key] for r in (vit_train, enc_row, dec_row,
                                                               cross_row))
    recompute_key = "recompute_backward_ms"
    triple_recompute = n_t5 * enc_row[recompute_key] + n_custom * (
        fam_self[recompute_key] + fam_cross[recompute_key])
    prestu_recompute = n_t5 * sum(r[recompute_key] for r in (vit_train, enc_row, dec_row,
                                                             cross_row))
    vit_recompute = n_t5 * vit_train[recompute_key]
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
        # training (phases 3c, 6d, 7): launches on the main path's train run,
        # per step, and the four roles' times per step (12 layers each)
        "launches_train": trained["train_launches"]["flash_attention"],
        "launches_per_train_step": trained["launches_per_step"]["flash_attention"],
        "train_step_ms": per_step("ms"),
        "train_step_plain_ms": per_step("plain_ms"),
        "train_step_bound_ms": per_step("bound_ms"),
        "train_step_library_ms": per_step("library_ms"),
        "train_step_recompute_backward_ms": recompute,
        "train_shapes": train_shapes,
        "max_grad_err_f32": grads["max_grad_err_f32"],
        "max_grad_err_bf16": grads["max_grad_err_bf16"],
        # PhonemeSaL-base training (phases 3c, 6d, 8): the custom decoder's
        # self and cross layers (4 each) a step, and the SaL encoder's 12
        # layers with SAL_FUSED off
        "launches_train_phoneme_sal": psal_trained["train_launches"]["flash_attention"],
        "launches_per_train_step_phoneme_sal": psal_trained["launches_per_step"]["flash_attention"],
        "phoneme_sal_train_step_ms": n_custom * sum(r["ms"] for r in psal_shapes[:2]),
        "phoneme_sal_train_step_recompute_backward_ms": n_custom * sum(
            r["recompute_backward_ms"] for r in psal_shapes[:2]),
        "phoneme_sal_train_shapes": psal_shapes,
        # the PhonemeLaTr / PreSTU families (phases 3c, 4d, 4e, 6d, 9, 9c): the
        # serving launches of the main path's runs, the new roles' rows and
        # their times per step
        "launches_serving_phoneme_latr": platr_served["launches"]["flash_attention"],
        "launches_serving_prestu": prestu_served["launches"]["flash_attention"],
        "launches_train_phoneme_latr": platr_trained["train_launches"]["flash_attention"],
        "launches_per_train_step_phoneme_latr":
            platr_trained["launches_per_step"]["flash_attention"],
        "launches_per_train_step_prestu": steps_9c["prestu"]["launches_per_step"]["flash_attention"],
        "latr_family_train_shapes": family_shapes,
        "phoneme_latr_train_shapes": [fam_self, fam_cross],
        "phoneme_latr_train_step_ms": triple_step("ms"),
        "phoneme_latr_train_step_plain_ms": triple_step("plain_ms"),
        "phoneme_latr_train_step_bound_ms": triple_step("bound_ms"),
        "phoneme_latr_train_step_library_ms": triple_step("library_ms"),
        "phoneme_latr_train_step_recompute_backward_ms": triple_recompute,
        "prestu_vit_train_shape": vit_train,
        "prestu_train_step_ms": prestu_step_ms("ms"),
        "prestu_train_step_plain_ms": prestu_step_ms("plain_ms"),
        "prestu_train_step_bound_ms": prestu_step_ms("bound_ms"),
        "prestu_train_step_library_ms": prestu_step_ms("library_ms"),
        "prestu_train_step_recompute_backward_ms": prestu_recompute,
        "prestu_vit_recompute_backward_ms_per_step": vit_recompute,
        "prestu_vit_recompute_share_of_step": vit_recompute / steps_9c["prestu"]["ms_per_step"],
        # the decode variants (phases 10-13): launches a batch of 32, counted
        # on each path (the one-token and K-token steps stay plain)
        "launches_per_batch_beam_phoneme_latr":
            variants["beam"]["phoneme_latr"]["launches_per_batch"]["flash_attention"],
        "launches_per_batch_speculative_latr": encode_step["flash_attention"],
        "launches_per_batch_pool_latr": encode_step["flash_attention"],
        "launches_per_batch_pool_phoneme_latr": encode_step["flash_attention"],
        "launches_per_batch_sampling_latr":
            variants["sampling"]["launches_per_batch"]["flash_attention"],
        # fine-tuning (phases 18-22): counted on each path
        "launches_serving_imported_latr":
            finetune["import"]["bfloat16"]["served"]["launches"]["flash_attention"],
        "launches_per_train_step_lora": finetune["lora"]["launches_per_step"]["flash_attention"],
        "launches_per_train_step_remat_latr":
            finetune["remat"]["latr"]["launches_on"]["flash_attention"],
        "launches_per_train_step_remat_sal":
            finetune["remat"]["sal"]["launches_on"]["flash_attention"],
        "launches_per_eval_batch_vit_cache":
            finetune["vit_cache"]["cached"]["launches_per_batch"]["flash_attention"],
        # across cards (phases 24-25): the head-sliced calls a TP rank makes,
        # and the launches a rank a step of the model-2 mesh (counted)
        "tp_head_slice_shapes": [r for r in across["tp_slices"]["shapes"]
                                 if not r["shape"].startswith("sal")],
        "launches_per_step_per_rank_model2":
            across["mesh"]["b_model"]["ranks"][0]["launches_per_step"]["flash_attention"],
        # C1 (phases 10 and 13): a batch of 32 served through the gathered
        # engine's eager decode; phase 26: a batch a rank served over a mesh
        "launches_per_batch_c1_served_beam":
            variants["beam"]["phoneme_latr"]["c1_served"]["launches"]["flash_attention"],
        "launches_per_batch_c1_served_sample":
            variants["sampling"]["c1_served"]["launches"]["flash_attention"],
        "launches_per_batch_per_rank_served_mesh": served_mesh_launches(across, "flash_attention"),
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
        "sal_fused_choice": sal_choice,
        # PhonemeSaL-base training (phase 8): 12 launches a step, 12 an eval
        # batch; per step at the training shape (12 layers)
        "launches_train": psal_trained["train_launches"]["sal_fused_attention"],
        "launches_per_train_step": psal_trained["launches_per_step"]["sal_fused_attention"],
        "train_step_ms": n_t5 * sal_train_shape["ms"],
        "train_step_plain_ms": n_t5 * sal_train_shape["plain_ms"],
        "train_step_bound_ms": n_t5 * sal_train_shape["bound_ms"],
        "train_step_library_ms": n_t5 * sal_train_shape["library_ms"],
        "train_step_recompute_backward_ms": n_t5 * sal_train_shape["recompute_backward_ms"],
        "train_shapes": [sal_train_shape],
        "max_grad_err_bf16": grads["sal_max_grad_err"],
        "launches_per_batch_beam_phoneme_sal":
            variants["beam"]["phoneme_sal"]["launches_per_batch"]["sal_fused_attention"],
        "launches_per_batch_converted_phoneme_sal": T5_BASE["num_encoder_layers"],
        "launches_per_train_step_remat_sal":
            finetune["remat"]["sal"]["launches_on"]["sal_fused_attention"],
        "tp_head_slice_shapes": [r for r in across["tp_slices"]["shapes"]
                                 if r["shape"].startswith("sal")],
        "launches_per_step_per_rank_model2_sal":
            across["mesh"]["sal_model2"]["ranks"][0]["launches_per_step"]["sal_fused_attention"],
        "launches_per_batch_per_rank_served_mesh":
            served_mesh_launches(across, "sal_fused_attention"),
    }]
    log(json.dumps({"serving": {"latr": served, "sal": sal_served, "phoneme_sal": psal_served,
                                "phoneme_latr": platr_served, "prestu": prestu_served},
                    "end_to_end_f32": {"latr": e2e, "sal": sal_e2e, "phoneme_sal": psal_e2e,
                                       "phoneme_latr": platr_e2e, "prestu": prestu_e2e},
                    "train": {"latr": trained, "f32_step": train_f32,
                              "phoneme_sal": psal_trained, "phoneme_sal_f32_step": psal_f32,
                              "sal": sal_steps, "phoneme_latr": platr_trained,
                              "phoneme_latr_f32_step": platr_f32, "steps_9c": steps_9c,
                              "prestu_f32_step": prestu_f32},
                    "decode_variants": variants, "serving_engines": engines,
                    "finetune": finetune, "across_cards": across, "card": card}))
    log(f"seconds a phase (from the previous phase's last line): {json.dumps(phase_seconds())}")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
