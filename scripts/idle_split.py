"""Where a benchmark cell's idle card time goes, by the program's own spans.

Runs one cell of ``portbench`` with its profiler slice (as ``--trace 1``
does) and prints one JSON line: the cell's per-layer metrics, and for every
span name the program recorded in the slice (``utils/profiling.py``) and
every span of the benchmark's own (``loader``, ``train_step``, ``submit``)
its count, mean ms and the card's idle time under it in % of the slice;
then the sums that split ``device_idle.serve`` / ``.train`` over the
serving resolver's loop or the train loop, the largest gap between two of
the resolver's top-level spans, and the spans a batch or a step records::

    python3 scripts/idle_split.py --workload latr-base.serve-flood --seed 7 --seconds 51

Needs a CUDA card, as the benchmark does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter, defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import bench, program_trace, trace  # noqa: E402

RESOLVER_DECODE = ("decode.replay", "decode.sync")
RESOLVER_HOST = ("decode.readback", "engine.detokenize", "engine.complete")
TRAIN_REST = ("step.to_device", "step.loss")


def _idle(run, intervals) -> float:
    t0, t1 = run.slice.t0, run.slice.t1
    held = program_trace.union((max(s, t0), min(e, t1)) for s, e in intervals)
    return 100.0 * program_trace.overlap_ns(held, trace.gaps(run.slice.ops, t0, t1)) / (t1 - t0)


def split(run, driver) -> dict:
    """The idle split of the run's slice."""
    if run.slice is None:
        return {}
    t0, t1 = run.slice.t0, run.slice.t1
    spans = program_trace.profiling().spans(t0, t1)
    by_name = defaultdict(list)
    for s in spans:
        by_name[s.name].append((s.start, s.end))
    with run.spans._lock:
        for s in run.spans.items:
            if s.end >= t0 and s.start <= t1:
                by_name["bench." + s.name].append((s.start, s.end))
    names = {n: {"count": len(v), "mean_ms": sum(e - s for s, e in v) / len(v) / 1e6,
                 "idle_pct": _idle(run, v)} for n, v in sorted(by_name.items())}
    idle = 100.0 * (1 - trace.busy_ns(run.slice.ops) / (t1 - t0))
    out = {"device_idle": idle, "spans": names}
    if "engine.await_batch" in by_name:
        loop = [s for s in spans if s.thread == "serving-resolver" and s.parent is None]
        gaps = [b.start - a.end for a, b in zip(loop, loop[1:])]
        parts = {"await_batch": _idle(run, by_name["engine.await_batch"]),
                 "resolver_host": _idle(run, [x for n in RESOLVER_HOST for x in by_name[n]]),
                 "decode": _idle(run, [x for n in RESOLVER_DECODE for x in by_name[n]])}
        per_batch = Counter(s.attrs.get("batch") for s in spans if s.name != "gc")
        out["serve_split"] = dict(parts, sum=sum(parts.values()),
                                  resolver_all=_idle(run, [(s.start, s.end) for s in loop]),
                                  max_gap_us=max(gaps) / 1e3 if gaps else None,
                                  spans_per_batch=sorted(per_batch.values())[len(per_batch) // 2])
    if "step" in by_name:
        parts = {n: _idle(run, by_name[n]) for n in
                 ("step.forward", "step.backward", "step.optimizer") + TRAIN_REST}
        parts["bench.loader"] = _idle(run, by_name["bench.loader"])
        steps = [s for s in spans if s.name == "step"]
        inside = Counter(id(s.parent) for s in spans if s.parent is not None
                         and s.parent.name == "step")
        out["train_split"] = dict(parts, sum=sum(parts.values()),
                                  step_all=_idle(run, by_name["step"]),
                                  spans_per_step=1 + sorted(inside.values())[len(inside) // 2]
                                  if inside else None,
                                  steps=len(steps))
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    args = p.parse_args(argv)
    args.trace = 1
    import torch

    if not torch.cuda.is_available():
        print("idle_split: no CUDA card is available", file=sys.stderr)
        return 2
    result, _ = bench.run_cell(args, torch.device("cuda"), time.time(), extra=split)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
