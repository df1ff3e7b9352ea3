"""A closed loop of clients over the port's gathered ``ServingEngine``.

The mix sets ``clients`` (threads, each sending its next request when its
last is answered), ``requests`` and ``warmup_requests`` (distinct
(image, question) pairs from the mix's generator), ``sample`` (answers the
output check compares) and ``engine``: the engine's ``batch_size``,
``buckets``, ``max_wait_ms`` and ``max_answer_length``, as ``serve.py``
takes them. ``answers_per_s`` is the answers completed in the window over
the window.
"""

from __future__ import annotations

import itertools
import math
import threading
import time

import numpy as np

from portbench import checks, trace
from portbench.drivers import (FUTURE_TIMEOUT_S, Served, Steady, decode_steps, executor, free,
                               sleep_until, sync, tag_rows)

DRAIN_WAIT_S = 60.0  # how long a traced run's profiler waits for the answers in flight


class Driver:

    def __init__(self, run):
        self.run = run
        self.settings = run.mix["engine"]
        self.steady_end = None

    def build(self):
        from phoneme_vqa_torch.serving import ServingEngine

        ex, _ = executor(self.run, "serve")
        tag_rows(ex)
        ocr, obj = ex.serve_frames
        s = self.settings
        self.engine = ServingEngine(ex, ocr, obj, batch_size=s["batch_size"],
                                    max_wait_ms=s["max_wait_ms"],
                                    max_answer_length=s["max_answer_length"],
                                    buckets=s["buckets"])

    def warm(self):
        """The cell's own batches, full ones under the mix's load."""
        run = self.run
        self.requests = run.fixture.requests()
        n_warm = int(run.mix.get("warmup_requests", 0))
        warm, self.requests = self.requests[:n_warm], self.requests[n_warm:]
        if warm:
            for t in self._clients(warm, math.inf, []):
                t.join(FUTURE_TIMEOUT_S + 5)
        sync(run.device)

    def _clients(self, reqs, until: float, records: list):
        """The mix's clients, each sending its next request when its last is
        answered, until ``until`` (perf_counter) or the requests run out."""
        lock, counter = threading.Lock(), itertools.count()
        spans = self.run.spans

        def client():
            while time.perf_counter() < until:
                with lock:
                    k = next(counter)
                if k >= len(reqs):
                    return
                image_id, question = reqs[k]
                t_send, s0 = time.perf_counter(), time.time_ns()
                try:
                    fut = self.engine.submit(image_id, question)
                    spans.add("submit", s0, time.time_ns())
                    answer, ok = fut.result(timeout=FUTURE_TIMEOUT_S), True
                except Exception as e:  # a failed request counts as missing
                    answer, ok = repr(e), False
                records.append((k, t_send, time.perf_counter(), ok, answer))

        threads = [threading.Thread(target=client, name=f"client-{i}", daemon=True)
                   for i in range(int(self.run.mix["clients"]))]
        for t in threads:
            t.start()
        return threads

    def window(self):
        run = self.run
        stats0 = self.engine.stats()
        records: list = []
        t0 = time.perf_counter()
        w0 = time.time_ns()
        run.t_first = time.time()
        threads = self._clients(self.requests, t0 + run.seconds, records)
        drained = threading.Event()
        tracer = threading.Thread(target=self._traced, args=(t0, drained), daemon=True)
        tracer.start()
        sleep_until(t0 + run.seconds)
        t_end = time.perf_counter()
        for t in threads:
            t.join(FUTURE_TIMEOUT_S + 5)
        drained.set()
        tracer.join()
        done = [r for r in records if r[3] and t0 <= r[2] <= t_end]
        run.e2e["answers_per_s"] = len(done) / (t_end - t0)
        run.attempted = len([r for r in records if r[1] <= t_end])
        run.failed = len([r for r in records if not r[3]])
        self.answered = [r for r in records if r[3]]
        run.window_s = t_end - t0
        # the window before the traced slice (all of it in a run without one)
        t_mid, w_mid, stats_mid = self.steady_end or (t_end, time.time_ns(), None)
        steady = [r[4] for r in records if r[3] and t0 <= r[2] <= t_mid]
        eos = run.family.eos_id(run.c)
        run.steady = Steady(seconds=t_mid - t0, ns=(w0, w_mid),
                            stats=(stats0, stats_mid or self.engine.stats()),
                            answers=len(steady),
                            steps=[decode_steps(getattr(a, "row", ()), eos) for a in steady])

    def _traced(self, t0, drained: threading.Event):
        """With ``--trace 1``: a profiler slice of the window's last
        seconds. Reading the profiler's records holds the interpreter, so
        the slice closes the window, and the window-level readings take the
        part before it (``run.steady``); the profiler stops once the
        requests in flight are answered (``drained``)."""
        run = self.run
        if not run.trace:
            return
        sleep_until(t0 + run.seconds - run.slice_seconds())
        self.steady_end = (time.perf_counter(), time.time_ns(), self.engine.stats())
        s0 = self.steady_end[2]
        with trace.Slice(run.device) as sl:
            sleep_until(t0 + run.seconds)
            sl.mark_end()
            s1 = self.engine.stats()
            drained.wait(FUTURE_TIMEOUT_S + DRAIN_WAIT_S)
        run.slice, run.slice_stats = sl, (s0, s1)

    def outputs(self):
        """The answered requests the check samples: drawn from the seed, the
        longest served rows among them; then the program is freed."""
        run = self.run
        rng = np.random.default_rng([run.seed % 2**63, 99])
        n = min(int(run.mix.get("sample", 16)), len(self.answered))
        order = rng.permutation(len(self.answered))
        longest = max(range(len(self.answered)), key=lambda i: len(self.answered[i][4].row))
        picked = [longest] + [int(i) for i in order if i != longest][:n - 1]
        self.sample = []
        for i in picked:
            k, _, _, _, answer = self.answered[i]
            image_id, question = self.requests[k]
            self.sample.append(({"image_id": image_id, "question": question, "answer": ""},
                                list(answer.row)))
        self.bad_rows = [r[4] for r in self.answered if not isinstance(r[4], Served)]
        self.answered = None
        self.engine.stop()
        self.engine = None
        free()

    def numbers(self) -> dict:
        return checks.serve_numbers(self.run, self)

    def controls(self) -> dict:
        from portbench.reference import nn

        return {"control": checks.serve_numbers(self.run, self, quant=nn.fp8)}
