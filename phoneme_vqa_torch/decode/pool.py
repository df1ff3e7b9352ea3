"""Slot-refill greedy decoding over a pool of prefilled rows (counterpart of
``phoneme_vqa_tpu/decode/pool.py``).

Offline decode in batches pays the longest answer of every batch. Here all
N rows are prefilled (the same per-batch ``encode_for_generate`` calls the
batch decode makes) and their caches kept on the device as a pool; S
decode slots run ``decode_step_k`` with K=1 at per-row positions, and a
slot whose row is done takes the pool's next row. Tokens land in the (N,
max_length) output by pool row, so the result is the array batch greedy
gives over the same rows: identical in f32; in bf16 the per-row step sums
in another order and can flip a near-tie argmax.

The JAX package runs one ``while_loop`` and refills inside it; the port
runs a Python loop with one host read a step (the slots' active flags), and
the host decides from that read which slots to refill.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

# step_k_fn(tokens (S, 1[, C]) int64, cache, pos (S,) int64, enc_mask (S, Ls))
#   -> (logits (S, 1, V) f32, or a C-tuple of such, cache)
StepKFn = Callable[[torch.Tensor, object, torch.Tensor, torch.Tensor], Tuple]

#: cache leaves whose row axis is 1: (layers, rows, ...) self-attention K/V
#: and cross-attention K/V
CACHE_KEYS = ("k", "v", "ck", "cv")


def _take_rows(cache: Dict[str, torch.Tensor], enc_mask: torch.Tensor, row_ids: torch.Tensor):
    """Pool rows ``row_ids`` (S,): new tensors."""
    return ({n: cache[n].index_select(1, row_ids) for n in CACHE_KEYS},
            enc_mask.index_select(0, row_ids))


def pool_greedy_decode(
    step_k_fn: StepKFn,
    pool_cache: Dict[str, torch.Tensor],
    pool_enc_mask: torch.Tensor,
    num_slots: int,
    max_length: int,
    bos_id: int,
    eos_id: int,
    pad_id: int,
    num_components: int = 1,
    stop_component: int = 0,
    with_scores: bool = False,
):
    """Decode all N pool rows through ``num_slots`` refilling slots:
    (N, max_length) int64, or (N, max_length, C) for component streams, row
    for row ``greedy_decode`` / ``multi_head_greedy_decode`` over the same
    rows. ``with_scores=True`` also returns the (N,) f32 mean emitted-token
    log-probability with those functions' meaning."""
    device = pool_enc_mask.device
    n = int(pool_enc_mask.shape[0])
    s = min(int(num_slots), n)
    c = int(num_components)
    # one trash row (index n) takes the writes of idle slots
    out = torch.full((n + 1, max_length) if c == 1 else (n + 1, max_length, c), pad_id,
                     dtype=torch.long, device=device)
    out[:, 0] = bos_id
    sum_lp = torch.zeros(n + 1, dtype=torch.float32, device=device)
    count = torch.zeros(n + 1, dtype=torch.float32, device=device)

    first = torch.arange(s, device=device)
    cache, enc_mask = _take_rows(pool_cache, pool_enc_mask, first)
    pos = torch.zeros(s, dtype=torch.long, device=device)
    cur = torch.full((s,) if c == 1 else (s, c), bos_id, dtype=torch.long, device=device)
    active = torch.ones(s, dtype=torch.bool, device=device)
    slot_row = first.clone()
    next_row = s
    active_host = [True] * s

    while any(active_host) or next_row < n:
        free = [i for i, a in enumerate(active_host) if not a][: n - next_row]
        if free:  # refill from the pool, in slot order
            slots = torch.tensor(free, dtype=torch.long, device=device)
            rows = torch.arange(next_row, next_row + len(free), device=device)
            got, got_mask = _take_rows(pool_cache, pool_enc_mask, rows)
            for name in CACHE_KEYS:  # the slots' own tensors, written in place
                cache[name].index_copy_(1, slots, got[name])
            enc_mask = enc_mask.index_copy(0, slots, got_mask)
            pos = pos.index_fill(0, slots, 0)
            cur = cur.index_fill(0, slots, bos_id)
            active = active.index_fill(0, slots, True)
            slot_row = slot_row.index_copy(0, slots, rows)
            next_row += len(free)

        logits, cache = step_k_fn(cur[:, None], cache, pos, enc_mask)
        if c == 1:
            tok = logits[:, 0].argmax(dim=-1)  # (S,)
            stop_tok = tok
            if with_scores:
                tok_lp = torch.log_softmax(logits[:, 0].float(), dim=-1).gather(
                    1, tok[:, None])[:, 0]
        else:
            tok = torch.stack([l[:, 0].argmax(dim=-1) for l in logits], dim=-1)  # (S, C)
            stop_tok = tok[:, stop_component]
            if with_scores:
                tok_lp = sum(torch.log_softmax(l[:, 0].float(), dim=-1).gather(
                    1, tok[:, j][:, None])[:, 0] for j, l in enumerate(logits))
        rows = torch.where(active, slot_row, n)
        out[rows, torch.where(active, pos + 1, 0)] = tok
        if with_scores:
            sum_lp.index_add_(0, rows, torch.where(active, tok_lp, 0.0))
            count.index_add_(0, rows, active.float() * c)
        new_pos = pos + active.long()
        cur = torch.where(active if c == 1 else active[:, None], tok, cur)
        active = active & (stop_tok != eos_id) & (new_pos < max_length - 1)
        pos = new_pos
        active_host = active.tolist()

    out = out[:n]
    if with_scores:
        return out, (sum_lp / count.clamp(min=1.0))[:n]
    return out
