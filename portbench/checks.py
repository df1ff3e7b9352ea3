"""The output check: what the timed path produced against the plain
float32 reference (``portbench/reference/``), on the card, once the window
has closed and the program's state is freed.

* Serving: a sample of the answered requests, drawn from the seed with the
  longest served rows in it. The reference runs once over each prompt with
  its served tokens (teacher-forced), and ``served_gap`` is the widest gap
  by which a served token's logit lies below the reference's best at that
  position. A row that does not start with the decoder's start id, or whose
  answer carries no row, fails.
* Training: the first three steps, on the rows the program's loader gave
  them. ``loss_gap``: the largest relative gap of a step's loss.
  ``grad_gap``: the first gradient as the optimizer got it (its first
  moment after one step over (1 - beta1)), by the worst leaf: the gap of
  the leaf's norms over the larger of the reference leaf's norm and the
  median leaf's. ``change_gap``: the same for each leaf's change after the
  three steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).
  ``frozen_moved``: the largest change of a leaf the reference does not
  train (LaTr's ViT).

Each number's limit is the cell's (``limits`` in its workload file). A
driver (``portbench/drivers/``) says which numbers its outputs give
(``numbers()``), through the functions here or its own.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import weights as weights_mod
from .reference import nn as ref_nn

EXCLUDE_BELOW = 1e-3  # of the median leaf's reference gradient norm


def tensors(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def check(run, driver) -> dict:
    """{"correct": bool, "checks": {name: {"value", "limit"}}}."""
    ref_nn.plain_precision()
    values = driver.numbers()
    limits = run.workload["limits"]
    out, ok = {}, run.failed == 0
    for name, limit in limits.items():
        value = values.get(name, math.inf)
        out[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return {"correct": bool(ok), "checks": out}


@torch.no_grad()
def serve_numbers(run, driver, quant=None) -> dict:
    """``served_gap`` of the sampled rows; with ``quant``, of the tokens the
    reference so computed puts first at each position of the same prompts
    and served tokens (the control)."""
    if driver.bad_rows or not driver.sample:
        return {"served_gap": math.inf}
    c, fam = run.c, run.family
    rows = [r for r, _ in driver.sample]
    served = [list(t) for _, t in driver.sample]
    length = int(driver.settings["max_answer_length"])
    if any(len(t) != length or t[0] != fam.decode_start(c) for t in served):
        return {"served_gap": math.inf}
    p = weights_mod.make(fam.reference.param_spec(c), run.seed, run.device)
    batch = tensors(fam.reference_inputs(run.fixture, rows, c), run.device)
    ids = torch.tensor(served, device=run.device)
    inputs, keep = ids[:, :-1], torch.ones_like(ids[:, :-1])
    logits = fam.reference.logits(p, batch, inputs, keep, c)
    picked = ids[:, 1:, None] if quant is None else \
        fam.reference.logits(p, batch, inputs, keep, c, quant).argmax(-1, keepdim=True)
    gap = logits.max(-1).values - logits.gather(-1, picked)[..., 0]
    return {"served_gap": float((gap * valid_positions(ids, fam.eos_id(c))).max())}


def valid_positions(ids: torch.Tensor, eos: int) -> torch.Tensor:
    """1 for each served token up to and including the row's first EOS."""
    toks = ids[:, 1:]
    after = torch.cumsum((toks == eos).int(), 1) - (toks == eos).int()
    return (after == 0).float()


def train_numbers(run, driver, quant=None, rows_kept=None) -> dict:
    """The numbers of the program's readings (``driver.losses``,
    ``driver.readings``) against the reference's three steps; with
    ``quant`` or ``rows_kept`` (a fault: the loss over the first rows of
    each batch alone) the reference so computed stands in the program's
    place."""
    ref = reference_steps(run, driver.checked_rows)
    if quant is None and rows_kept is None:
        prog = {"losses": driver.losses, "grad": driver.readings["grad"],
                "change": driver.readings["change"]}
    else:
        prog = reference_steps(run, driver.checked_rows, quant, rows_kept)
    return compare_train(prog, ref, run.family.reference.trainable)


def reference_steps(run, checked_rows, quant=None, rows_kept=None) -> dict:
    """Three Adam steps of the reference from the seeded weights: each
    step's loss, the first gradient's leaf norms, each leaf's change."""
    c, fam = run.c, run.family
    spec = fam.reference.param_spec(c)
    p = weights_mod.make(spec, run.seed, run.device)
    trainable = [n for n in spec if fam.reference.trainable(n)]
    for n in trainable:
        p[n] = p[n].clone().requires_grad_(True)
    rows = run.fixture.train_rows
    adam = ref_nn.Adam(trainable, fam.lr_schedule(c, len(rows)), tuple(c["BETAS"]), 1e-9)
    losses, grad = [], None
    for idx in checked_rows:
        kept = idx if rows_kept is None else idx[:rows_kept]
        batch = tensors(fam.reference_inputs(run.fixture, [rows[int(i)] for i in kept], c),
                        run.device)
        loss = fam.reference.loss(p, batch, c, quant)
        grads = torch.autograd.grad(loss, [p[n] for n in trainable])
        g = dict(zip(trainable, grads))
        if grad is None:
            grad = {n: float(torch.linalg.vector_norm(g[n])) for n in trainable}
        losses.append(float(loss.detach()))
        adam.step(p, g)
        del batch, grads, g
    init = weights_mod.make(spec, run.seed, run.device)
    change = {n: float(torch.linalg.vector_norm(p[n].detach() - init[n])) for n in spec}
    del p, init
    torch.cuda.empty_cache()
    return {"losses": losses, "grad": grad, "change": change}


def compare_train(prog: dict, ref: dict, trainable) -> dict:
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g_ref = ref["grad"]
    median_g = float(np.median(list(g_ref.values())))
    grad_gap = max((abs(prog["grad"].get(n, math.inf) - g) / max(g, median_g)
                    for n, g in g_ref.items()), default=math.inf)
    kept = [n for n, g in g_ref.items() if g >= EXCLUDE_BELOW * median_g]
    median_d = float(np.median([ref["change"][n] for n in kept]))
    change_gap = max((abs(prog["change"][n] - ref["change"][n]) / max(ref["change"][n], median_d)
                      for n in kept), default=math.inf)
    frozen = [prog["change"][n] for n in prog["change"] if not trainable(n)]
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "frozen_moved": max(frozen, default=0.0)}
