"""Stochastic decoding: temperature, top-k and nucleus top-p (counterpart of
``phoneme_vqa_tpu/decode/sample.py``).

The greedy loop's shape (per-row done latch, all-done exit, one host read a
step) with a draw in place of the argmax. The filters compose the standard
way: temperature scales the logits, top-k keeps the k best, top-p keeps the
smallest prefix of probability mass >= p. Thresholds are values, so the
filtered logits do not depend on how a sort orders ties. ``temperature ==
0`` or ``top_k == 1`` is the argmax, the greedy choice on the same logits.

The draws come from a ``torch.Generator`` on the logits' device (Gumbel-max
over the filtered logits, a categorical draw). ``jax.random`` and
``torch.Generator`` are different streams, so the port cannot draw what the
JAX package draws; it holds the same distribution and the same support.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .greedy import StepFn, chosen_logprob

NEG = -1.0e9


def filter_logits(logits: torch.Tensor, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """(B, V) f32 logits with temperature, then top-k, then top-p applied;
    the filtered-out entries are ``NEG``."""
    if temperature not in (0.0, 1.0):
        logits = logits / temperature
    v = logits.shape[-1]
    if top_k and 0 < top_k < v:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]  # the k-th largest value
        logits = torch.where(logits < kth, NEG, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens while the mass before them is < p (always >= 1 token)
        keep_sorted = (cum - probs) < top_p
        thresh = torch.where(keep_sorted, sorted_logits, torch.inf).min(dim=-1).values[:, None]
        logits = torch.where(logits < thresh, NEG, logits)
    return logits


def sample_generator(seed: int, call: int, device) -> torch.Generator:
    """The draw stream of one call: a generator on ``device`` seeded from
    ``(seed, call)``, so every call draws fresh noise and one process stays
    reproducible from its seed."""
    mixed = np.random.SeedSequence([int(seed), int(call)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def sample_decode(
    step_fn: StepFn,
    cache,
    batch_size: int,
    max_length: int,
    bos_id: int,
    eos_id: int,
    pad_id: int,
    device,
    seed: int = 0,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
    with_scores: bool = False,
):
    """(B, max_length) int64 sampled rows, shaped as greedy's.

    ``generator`` is the call's stream (``None``: one seeded from ``seed``).
    ``with_scores=True`` also returns the (B,) f32 mean log-probability of
    the emitted tokens under the raw model distribution (before temperature
    and filtering)."""
    greedy_mode = temperature == 0.0 or top_k == 1
    if generator is None and not greedy_mode:
        generator = sample_generator(seed, 0, device)
    out = torch.full((batch_size, max_length), pad_id, dtype=torch.long, device=device)
    out[:, 0] = bos_id
    done = torch.zeros(batch_size, dtype=torch.bool, device=device)
    sum_lp = torch.zeros(batch_size, dtype=torch.float32, device=device)
    count = torch.zeros(batch_size, dtype=torch.float32, device=device)

    for i in range(max_length - 1):
        logits, cache = step_fn(out[:, i], cache, i)
        if greedy_mode:
            nxt = logits.argmax(dim=-1)
        else:
            filtered = filter_logits(logits.float(), temperature, top_k, top_p)
            u = torch.rand(filtered.shape, generator=generator, device=filtered.device)
            nxt = (filtered - torch.log(-torch.log(u))).argmax(dim=-1)
        if with_scores:
            lp = chosen_logprob(logits, nxt)
            sum_lp += torch.where(done, 0.0, lp)
            count += (~done).float()
        nxt = torch.where(done, pad_id, nxt)
        out[:, i + 1] = nxt
        done |= nxt == eos_id
        if bool(done.all()):
            break
    if with_scores:
        return out, sum_lp / count.clamp(min=1.0)
    return out
