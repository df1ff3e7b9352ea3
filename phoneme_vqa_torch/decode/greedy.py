"""KV-cached greedy decoding (counterpart of ``phoneme_vqa_tpu/decode/greedy.py``).

Semantics mirror HF greedy: the output starts with the decoder-start
token, rows stop emitting after their EOS (padded thereafter), and the loop
ends once every row is done. A Python loop over steps; one host sync per
step reads the all-done flag.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

# step_fn(tokens (B,) int64, cache, index int) -> (logits (B, V) f32, cache)
StepFn = Callable[[torch.Tensor, object, int], Tuple[torch.Tensor, object]]


def chosen_logprob(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """log p(chosen) under softmax(logits): (B, V), (B,) -> (B,) f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(1, chosen[:, None].long())[:, 0]


def greedy_decode(
    step_fn: StepFn,
    cache,
    batch_size: int,
    max_length: int,
    bos_id: int,
    eos_id: int,
    pad_id: int,
    device,
    with_scores: bool = False,
):
    """Returns (B, max_length) int64: [bos, t1, ..., eos, pad, ...].

    ``with_scores=True`` also returns the (B,) f32 mean log-probability of
    the emitted tokens (EOS included)."""
    out = torch.full((batch_size, max_length), pad_id, dtype=torch.long, device=device)
    out[:, 0] = bos_id
    done = torch.zeros(batch_size, dtype=torch.bool, device=device)
    sum_lp = torch.zeros(batch_size, dtype=torch.float32, device=device)
    count = torch.zeros(batch_size, dtype=torch.float32, device=device)

    for i in range(max_length - 1):
        logits, cache = step_fn(out[:, i], cache, i)
        nxt = logits.argmax(dim=-1)
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


def multi_head_greedy_decode(
    step_fn,  # (tokens (B, C), cache, i) -> (tuple of C logits (B, V_c), cache)
    cache,
    batch_size: int,
    max_length: int,
    num_components: int,
    bos_id: int,
    eos_id: int,
    pad_id: int,
    device,
    stop_component: int = 0,
    with_scores: bool = False,
):
    """Greedy decode over component tuples (phoneme onset / rhyme / tone).

    Each step emits one id per component, the argmax of each head; a row is
    done when its ``stop_component`` (the onset) emits EOS, and emits pad in
    every component from then on. Returns (B, max_length, C) int64;
    ``with_scores=True`` also returns the (B,) f32 mean log-probability per
    emitted component id (the mean runs over steps x C)."""
    out = torch.full((batch_size, max_length, num_components), pad_id, dtype=torch.long,
                     device=device)
    out[:, 0, :] = bos_id
    done = torch.zeros(batch_size, dtype=torch.bool, device=device)
    sum_lp = torch.zeros(batch_size, dtype=torch.float32, device=device)
    count = torch.zeros(batch_size, dtype=torch.float32, device=device)

    for i in range(max_length - 1):
        logits, cache = step_fn(out[:, i], cache, i)
        nxt = torch.stack([l.argmax(dim=-1) for l in logits], dim=-1)
        if with_scores:
            lp = sum(chosen_logprob(l, nxt[:, c]) for c, l in enumerate(logits))
            sum_lp += torch.where(done, 0.0, lp)
            count += (~done).float() * len(logits)
        nxt = torch.where(done[:, None], pad_id, nxt)
        out[:, i + 1] = nxt
        done |= nxt[:, stop_component] == eos_id
        if bool(done.all()):
            break
    if with_scores:
        return out, sum_lp / count.clamp(min=1.0)
    return out
