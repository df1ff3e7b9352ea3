"""Batched beam search over the KV cache (counterpart of
``phoneme_vqa_tpu/decode/beam.py``).

Cumulative log-probabilities, ``num_beams`` hypotheses a row, no length
penalty; a finished beam may only emit pad, at no cost, and so persists with
its score; the best-scoring sequence wins. For phoneme triples the joint
next-token distribution is the outer sum of the three heads'
log-softmaxes: the top-K of each head, then the top-K of the K x K^3 cube
of (beam, onset, rhyme, tone) candidates (exact for the top-K of a sum of
independent terms).

Ties are broken as ``lax.top_k`` and ``jnp.argmax`` break them, lower index
first: the top-K comes from a stable descending sort and the best beam is
the first maximum. At step 0 every beam but the first starts at ``NEG``,
where f32 rounds ``NEG + logp`` to exactly ``NEG``, so such ties are
common.

The models' decode steps write the self-attention cache in place; the beam
reorder then builds new tensors by ``index_select`` along the batch axis
(axis 1 of the stacked (L, B·K, H, T, d) leaves). The cross-attention K/V
(``ck``/``cv``) are the same for every beam of a row and are never
reordered. A Python loop over steps; one host read a step (the all-done
flag).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

NEG = -1.0e9
# cross-attention K/V: projected once from the encoder, the same for every
# beam of a row
STATIC_KEYS = ("ck", "cv")


def _batch_axis(x: torch.Tensor) -> int:
    """Stacked (L, B, H, T, d) cache leaves carry the batch on axis 1;
    everything else is batch-major."""
    return 1 if x.dim() == 5 else 0


def expand_to_beams(tree, k: int):
    """Repeat a tensor, or every tensor of a dict, along its batch axis:
    (..., B, ...) -> (..., B·K, ...), each row's K copies adjacent."""
    if isinstance(tree, dict):
        return {n: expand_to_beams(x, k) for n, x in tree.items()}
    return tree.repeat_interleave(k, dim=_batch_axis(tree))


def split_static(cache):
    """(dynamic, static) parts of a decode cache: the cross-attention K/V
    are static."""
    if isinstance(cache, dict) and "ck" in cache:
        return ({n: v for n, v in cache.items() if n not in STATIC_KEYS},
                {n: cache[n] for n in STATIC_KEYS})
    return cache, {}


def gather_beams(tree: Dict[str, torch.Tensor], beam_idx: torch.Tensor, batch: int, k: int):
    """Reorder beam-major leaves (B·K on the batch axis) by per-row beam
    indices (B, K): new tensors, exact in any dtype."""
    flat = (torch.arange(batch, device=beam_idx.device)[:, None] * k + beam_idx).reshape(-1)
    return {n: x.index_select(_batch_axis(x), flat) for n, x in tree.items()}


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties broken
    lower index first (``lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _pad_only(v: int, pad_id: int, device) -> torch.Tensor:
    row = torch.full((v,), NEG, dtype=torch.float32, device=device)
    row[pad_id] = 0.0
    return row


def _best(seqs, scores, counts, with_scores: bool):
    best = scores.argmax(dim=1)  # the first maximum, as jnp.argmax
    rows = torch.arange(seqs.shape[0], device=seqs.device)
    best_seq = seqs[rows, best]
    if with_scores:
        return best_seq, scores[rows, best] / counts[rows, best].clamp(min=1.0)
    return best_seq


def beam_decode(
    step_fn: Callable,  # (tokens (B·K,), cache, i) -> (logits (B·K, V), cache)
    cache,
    batch_size: int,
    num_beams: int,
    max_length: int,
    bos_id: int,
    eos_id: int,
    pad_id: int,
    device,
    with_scores: bool = False,
):
    """The best sequence of each batch row: (B, max_length) int64.
    ``cache`` must already hold B·K rows (:func:`expand_to_beams`).
    ``with_scores=True`` also returns the (B,) f32 winning score over its
    emitted count (finished beams add pad at no cost, so the sum runs over
    emitted tokens, EOS included; a mid-sequence pad that was scored counts
    too)."""
    b, k = batch_size, num_beams
    seqs = torch.full((b, k, max_length), pad_id, dtype=torch.long, device=device)
    seqs[:, :, 0] = bos_id
    scores = torch.full((b, k), NEG, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    finished = torch.zeros((b, k), dtype=torch.bool, device=device)
    counts = torch.zeros((b, k), dtype=torch.float32, device=device)
    cache, static = split_static(cache)
    pad_only = None

    for i in range(max_length - 1):
        logits, cache = step_fn(seqs[:, :, i].reshape(b * k), {**cache, **static}, i)
        cache, _ = split_static(cache)
        logp = torch.log_softmax(logits.float(), dim=-1)
        v = logp.shape[-1]
        logp = logp.view(b, k, v)
        if pad_only is None:
            pad_only = _pad_only(v, pad_id, device)
        logp = torch.where(finished[:, :, None], pad_only, logp)

        total = scores[:, :, None] + logp  # (B, K, V)
        scores, flat_idx = top_k_stable(total.view(b, k * v), k)
        beam_idx = flat_idx // v
        token = flat_idx % v

        seqs = seqs.gather(1, beam_idx[:, :, None].expand(b, k, max_length))
        seqs[:, :, i + 1] = token
        prev_fin = finished.gather(1, beam_idx)
        counts = counts.gather(1, beam_idx) + (~prev_fin).float()
        finished = prev_fin | (token == eos_id)
        cache = gather_beams(cache, beam_idx, b, k)
        if bool(finished.all()):
            break
    return _best(seqs, scores, counts, with_scores)


def multi_head_beam_decode(
    step_fn,  # (tokens (B·K, C), cache, i) -> (C-tuple of (B·K, V_c), cache)
    cache,
    batch_size: int,
    num_beams: int,
    max_length: int,
    bos_id: int,
    eos_id: int,
    pad_id: int,
    device,
    stop_component: int = 0,
    with_scores: bool = False,
    bos_triple=None,
):
    """Joint-log-probability beam over (onset, rhyme, tone) triples: (B, T,
    3) int64. ``with_scores=True`` also returns the (B,) f32 winning score
    over its emitted component ids (steps x 3). ``bos_triple`` gives the
    start ids per component (default ``bos_id`` in each). Every head must
    have at least ``num_beams`` ids: a head with fewer raises
    ``ValueError`` naming it."""
    b, k, num_c = batch_size, num_beams, 3
    seqs = torch.full((b, k, max_length, num_c), pad_id, dtype=torch.long, device=device)
    start = [bos_id] * num_c if bos_triple is None else [int(t) for t in bos_triple]
    seqs[:, :, 0, :] = torch.tensor(start, dtype=torch.long, device=device)
    scores = torch.full((b, k), NEG, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    finished = torch.zeros((b, k), dtype=torch.bool, device=device)
    counts = torch.zeros((b, k), dtype=torch.float32, device=device)
    cache, static = split_static(cache)
    pad_only = {}

    for i in range(max_length - 1):
        logits_tuple, cache = step_fn(seqs[:, :, i, :].reshape(b * k, num_c),
                                      {**cache, **static}, i)
        cache, _ = split_static(cache)
        comp_scores, comp_tokens = [], []
        for c, logits in enumerate(logits_tuple):
            v = logits.shape[-1]
            if v < k:
                raise ValueError(f"num_beam {k} exceeds the {v} ids of head {c} "
                                 f"({('onset', 'rhyme', 'tone')[c]})")
            logp = torch.log_softmax(logits.float(), dim=-1).view(b, k, v)
            if v not in pad_only:
                pad_only[v] = _pad_only(v, pad_id, device)
            logp = torch.where(finished[:, :, None], pad_only[v], logp)
            s, t = top_k_stable(logp, k)  # (B, K, k)
            comp_scores.append(s)
            comp_tokens.append(t)

        joint = (comp_scores[0][:, :, :, None, None] + comp_scores[1][:, :, None, :, None]
                 + comp_scores[2][:, :, None, None, :])  # (B, K, k, k, k)
        total = scores[:, :, None, None, None] + joint
        scores, flat_idx = top_k_stable(total.reshape(b, k ** 4), k)
        beam_idx = flat_idx // (k ** 3)
        rem = flat_idx % (k ** 3)
        picks = (rem // (k * k), (rem % (k * k)) // k, rem % k)

        token = torch.stack([
            comp_tokens[c].gather(1, beam_idx[:, :, None].expand(b, k, k))
            .gather(2, picks[c][:, :, None])[:, :, 0]
            for c in range(num_c)], dim=-1)  # (B, K, C)

        seqs = seqs.gather(1, beam_idx[:, :, None, None].expand(b, k, max_length, num_c))
        seqs[:, :, i + 1, :] = token
        prev_fin = finished.gather(1, beam_idx)
        counts = counts.gather(1, beam_idx) + num_c * (~prev_fin).float()
        finished = prev_fin | (token[:, :, stop_component] == eos_id)
        cache = gather_beams(cache, beam_idx, b, k)
        if bool(finished.all()):
            break
    return _best(seqs, scores, counts, with_scores)
