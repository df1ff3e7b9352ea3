"""Speculative greedy decoding with prompt-lookup drafts (counterpart of
``phoneme_vqa_tpu/decode/speculative.py``).

Scene-text answers mostly copy spans of the OCR. Each trip drafts K-1
tokens by n-gram lookup in a row's source ids (OCR ++ question: "prompt
lookup", no draft model), verifies the window [current, drafts] in one
``decode_step_k`` at per-row positions, and accepts the longest prefix
where the drafts equal the argmax. The output is token for token greedy's
for any draft function: drafts change only how many trips an answer takes.
Rows advance at their own rate. A Python loop over trips; one host read a
trip (the all-done flag).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

# step_k_fn(tokens (B, K) int64, cache, pos (B,) int64) -> (logits (B, K, V) f32, cache)
StepKFn = Callable[[torch.Tensor, object, torch.Tensor], Tuple[torch.Tensor, object]]
# draft_fn(out (B, T) int64, pos (B,) int64) -> (B, K-1) int64
DraftFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def draft_from_pair(src: torch.Tensor, valid: torch.Tensor, cur: torch.Tensor,
                    prev: torch.Tensor, have_prev: torch.Tensor, num_draft: int,
                    pad_id: int) -> torch.Tensor:
    """The ``num_draft`` tokens that follow the source's first occurrence of
    the current n-gram: the bigram (prev, cur) where one occurs, else the
    unigram (cur); pad where there is no match or no real continuation.
    ``src``/``valid``: (B, Ls) ids and real-token flags; ``cur``, ``prev``,
    ``have_prev``: (B,)."""
    ls = src.shape[1]
    m1 = (src == cur[:, None]) & valid
    src_prev = torch.nn.functional.pad(src[:, :-1], (1, 0), value=-1)
    m2 = m1 & (src_prev == prev[:, None]) & have_prev[:, None]
    m = torch.where(m2.any(dim=1, keepdim=True), m2, m1)
    has = m.any(dim=1)
    first = m.int().argmax(dim=1)  # the first match (0 where there is none)
    cont_pos = first[:, None] + 1 + torch.arange(num_draft, device=src.device)[None, :]
    clamped = cont_pos.clamp(max=ls - 1)
    ok = has[:, None] & (cont_pos < ls) & valid.gather(1, clamped)
    return torch.where(ok, src.gather(1, clamped), pad_id)


def make_prompt_lookup_draft(source_ids: torch.Tensor, num_draft: int, pad_id: int,
                             source_mask: torch.Tensor = None) -> DraftFn:
    """:func:`draft_from_pair` over ``source_ids`` (B, Ls), reading (prev,
    cur) from the decode's output rows."""
    src = source_ids.long()
    valid = torch.ones_like(src, dtype=torch.bool) if source_mask is None else source_mask.bool()

    def draft(out: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        cur = out.gather(1, pos[:, None])[:, 0]
        prev = out.gather(1, (pos - 1).clamp(min=0)[:, None])[:, 0]
        return draft_from_pair(src, valid, cur, prev, pos > 0, num_draft, pad_id)

    return draft


def speculative_greedy_decode(
    step_k_fn: StepKFn,
    draft_fn: DraftFn,
    cache,
    batch_size: int,
    max_length: int,
    spec_k: int,
    bos_id: int,
    eos_id: int,
    pad_id: int,
    device,
    with_scores: bool = False,
):
    """(B, max_length) int64, greedy's rows. ``with_scores=True`` also
    returns the (B,) f32 mean emitted-token log-probability, greedy's (every
    emitted position's logits come out of the verification).

    ``pos[b]`` is the position of row b's last verified token. Window K/V
    past a row's accepted count land in cache slots at or after its next
    ``pos``: never read (queries attend the cache strictly before their
    window) and overwritten by the next trip's window."""
    kk = spec_k
    # one trash column past the end takes the writes a row does not keep
    out = torch.full((batch_size, max_length + 1), pad_id, dtype=torch.long, device=device)
    out[:, 0] = bos_id
    pos = torch.zeros(batch_size, dtype=torch.long, device=device)
    done = torch.zeros(batch_size, dtype=torch.bool, device=device)
    sum_lp = torch.zeros(batch_size, dtype=torch.float32, device=device)
    count = torch.zeros(batch_size, dtype=torch.float32, device=device)
    jj = torch.arange(kk, device=device)[None, :]  # (1, K)

    while True:
        cur = out.gather(1, pos[:, None])  # (B, 1)
        window = torch.cat([cur, draft_fn(out[:, :max_length], pos)], dim=1)  # (B, K)
        logits, cache = step_k_fn(window, cache, pos)
        greedy = logits.argmax(dim=-1)  # (B, K)

        # greedy[:, j] is the token at position pos+j+1; draft j (window[:,
        # j+1]) is accepted iff it equals greedy[:, j] and so did every
        # earlier draft
        match = (window[:, 1:] == greedy[:, :-1]).long()
        n_acc = 1 + match.cumprod(dim=1).sum(dim=1)  # 1..K
        n_acc = torch.minimum(n_acc, (max_length - 1) - pos)

        toks = torch.where(jj < n_acc[:, None], greedy, pad_id)
        # cut after the first EOS within the accepted run (the EOS kept)
        is_eos = (toks == eos_id).long()
        eos_before = is_eos.cumsum(dim=1) - is_eos
        keep = (jj < n_acc[:, None]) & (eos_before == 0) & ~done[:, None]
        toks = torch.where(keep, toks, pad_id)
        n_eff = keep.long().sum(dim=1)
        if with_scores:
            tok_lp = torch.log_softmax(logits.float(), dim=-1).gather(2, greedy[:, :, None])[..., 0]
            sum_lp += torch.where(keep, tok_lp, 0.0).sum(dim=1)
            count += n_eff.float()

        write_pos = torch.where(keep, pos[:, None] + 1 + jj, max_length)
        out.scatter_(1, write_pos, toks)

        # a row not done accepts >= 1 token, so the done rows are those with
        # n_eff == 0
        done = done | (keep & (toks == eos_id)).any(dim=1) | (pos + n_eff >= max_length - 1)
        pos = pos + n_eff
        if bool(done.all()):
            break
    out = out[:, :max_length]
    if with_scores:
        return out, sum_lp / count.clamp(min=1.0)
    return out
