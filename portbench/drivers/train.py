"""A train loop: the port's executor in train mode, the window driving
``train_step`` over the port's own loader (``batch_iterator``, reshuffled
each pass, through ``_maybe_prefetch``) and reading the loss each step.

The mix sets ``rows`` (QA rows from the mix's generator), ``val_rows``,
``checked_steps`` (the first steps, which the output check follows in the
reference) and ``warmup_steps``. ``train_samples_per_s`` is the rows of all
optimizer steps of the window over the window.
"""

from __future__ import annotations

import itertools
import math
import time

import numpy as np

from portbench import checks, trace
from portbench import weights as weights_mod
from portbench.drivers import Steady, executor, free, sync


class Driver:

    def __init__(self, run):
        self.run = run

    def build(self):
        from phoneme_vqa_torch.data.loader import batch_iterator, num_batches

        run, c = self.run, self.run.c
        fx = run.fixture
        self.rows = fx.train_rows = fx.rows()
        fx.paths["train"] = fx.write_csv("train", self.rows)
        fx.paths["val"] = fx.write_csv("val", self.rows[:int(run.mix.get("val_rows", 16))])
        ex, self.spec = executor(run, "train")
        self.ex = ex
        ds = ex.train_data
        gather, self.gathered = ds.gather, []
        ds.gather = lambda idx: (self.gathered.append(np.asarray(idx).copy()), gather(idx))[1]
        bs = int(c["TRAIN_BATCH_SIZE"])
        steps = num_batches(len(ds), bs, drop_last=True)
        seed = ex.config["SEED"]

        def epochs():
            for epoch in itertools.count(1):
                yield from ex._maybe_prefetch(itertools.islice(
                    batch_iterator(ds, bs, shuffle=True, seed=seed + epoch, drop_last=True),
                    steps))

        self.batches, self.bs = epochs(), bs

    def warm(self):
        """The first steps, which the output check follows, then a few more:
        every shape of the window is warm."""
        import torch

        run, ex = self.run, self.ex
        self.losses, self.readings = [], {}
        checked = int(run.mix.get("checked_steps", 3))
        for i in range(checked):
            self.losses.append(self.step())
            if i == 0:
                b1 = ex.tx.b1
                mu = ex.state.opt_state["mu"]
                names = list(mu)
                with torch.no_grad():
                    norms = torch._foreach_norm([mu[n] for n in names])
                self.readings["grad"] = {n: float(v) / (1 - b1) for n, v in zip(names, norms)}
        with torch.no_grad():
            init = weights_mod.make(self.spec, run.seed, run.device)
            names = list(self.spec)
            norms = torch._foreach_norm([ex.state.params[n] - init[n] for n in names])
            self.readings["change"] = {n: float(v) for n, v in zip(names, norms)}
            del init
        self.checked_rows = [idx for idx in self.gathered[:checked]]
        for _ in range(int(run.mix.get("warmup_steps", 0))):
            self.step()
        free()
        sync(run.device)

    def step(self) -> float:
        spans = self.run.spans
        s0 = time.time_ns()
        batch, _ = next(self.batches)
        s1 = time.time_ns()
        loss = float(self.ex.train_step(batch))
        s2 = time.time_ns()
        spans.add("loader", s0, s1)
        spans.add("train_step", s1, s2)
        if not math.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss}")
        return loss

    def window(self):
        """Steps until the window's seconds have passed; with ``--trace 1``
        its last seconds run under the profiler."""
        run = self.run
        run.t_first = time.time()
        t0 = time.perf_counter()
        w0 = time.time_ns()
        steps = 0
        slice_at = run.seconds - run.slice_seconds() if run.trace else math.inf
        while time.perf_counter() - t0 < min(run.seconds, slice_at):
            self.step()
            steps += 1
        run.steady = Steady(seconds=time.perf_counter() - t0, ns=(w0, time.time_ns()),
                            steps=steps)
        if run.trace:
            with trace.Slice(run.device) as sl:
                while time.perf_counter() - t0 < run.seconds:
                    self.step()
                    steps += 1
            run.slice, run.slice_steps = sl, steps - run.steady.steps
        run.window_s = time.perf_counter() - t0
        run.e2e["train_samples_per_s"] = steps * self.bs / run.window_s
        run.attempted, run.failed = steps, 0

    def outputs(self):
        self.ex = None
        self.batches = None
        free()

    def numbers(self) -> dict:
        return checks.train_numbers(self.run, self)

    def controls(self) -> dict:
        """The float8 control, and the fault "half of the batch left out,
        the mean taken over the rest", both in the reference."""
        from portbench.reference import nn

        half = int(self.run.c["TRAIN_BATCH_SIZE"]) // 2
        return {"control": checks.train_numbers(self.run, self, quant=nn.fp8),
                "half_batch": checks.train_numbers(self.run, self, rows_kept=half)}
