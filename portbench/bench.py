"""One run of one cell: set-up, window, output check, result line.

The result is the last line of standard output, one JSON object::

    {"correct", "attempted", "failed", "metrics", "device", ["breakdown"], "checks"}

``metrics`` holds the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``), as ``BENCHMARK.json`` lists them for the
cell; ``checks`` (last) holds each number the output check compared, with
its limit, which are also the last lines of standard error.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import shutil
import sys
import tempfile
import time

from . import checks, manifest, trace
from .fixture import Fixture

FORBIDDEN = ("jax", "jaxlib", "flax", "phoneme_vqa_tpu", "chip_smoke", "bench", "bench_train")
SLICE_S = 3.0  # the profiler slice of a traced run
RUN_LIMIT_S = 345.0  # a run must end within 360 s


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    flax's, the JAX package's or one of its bench scripts'."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


class Run:
    """What one run knows: the cell, its files, the seed, the device, the
    window's readings."""

    def __init__(self, args, device):
        self.cell = args.workload
        self.seed, self.seconds, self.trace = int(args.seed), float(args.seconds), bool(args.trace)
        self.bench = manifest.benchmark()
        self.workload = manifest.workload(self.cell)
        self.cf = manifest.config(self.workload["config"])
        self.c = self.cf["config"]
        self.mix = manifest.traffic(self.workload["traffic"])
        self.family = manifest.family(self.cf["family"])
        self.device = device
        self.spans = trace.Spans()
        self.e2e, self.notes = {}, []
        self.slice = None
        self.attempted = self.failed = 0

    def tmp_path(self, name: str) -> str:
        return os.path.join(self.tmp, name)

    def note(self, text: str) -> None:
        self.notes.append(text)

    def slice_seconds(self) -> float:
        """The traced slice: the window's last seconds."""
        return min(SLICE_S, 0.5 * self.seconds)


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, start: float) -> int:
    args = parse(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA card is available", file=sys.stderr)
        return 2
    try:
        workload = manifest.workload(args.workload)
        manifest.benchmark()
    except manifest.ManifestError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(workload["chips"]):
        print(f"portbench: {args.workload} needs {workload['chips']} cards, "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    try:
        import phoneme_vqa_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the port is not in this checkout: {e}", file=sys.stderr)
        return 2
    # a run that hangs prints every thread's stack and exits, inside the
    # time a run is allowed
    faulthandler.dump_traceback_later(RUN_LIMIT_S - (time.time() - start), exit=True)
    result, check_lines = run_cell(args, torch.device("cuda"), start)
    faulthandler.cancel_dump_traceback_later()
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for line in check_lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def run_cell(args, device, start: float, faults=None, extra=None):
    """Runs the cell; returns (result dict, check lines). ``faults`` (tests
    only) breaks the timed path of the built driver; ``extra(run, driver)``
    (``control.py``) adds readings of its own under ``"extra"``."""
    import torch

    run = Run(args, device)
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    run.tmp = tempfile.mkdtemp(prefix="portbench-", dir=base)
    try:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        run.fixture = Fixture(run.tmp_path("data"), run.seed, run.mix, run.c,
                              run.family.FIXTURE)
        driver = manifest.driver(run.mix["driver"]).Driver(run)
        driver.build()
        if faults is not None:
            faults(driver)
        driver.warm()
        if run.trace:
            # the profiler's first start is slow: made before the window, and
            # after the engine's graphs are captured (a capture after the
            # profiler has started hangs)
            with trace.Slice(device):
                torch.zeros(1, device=device).add_(1)
        driver.window()
        run.setup_s = run.t_first - start
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        layer_values = read_layer_metrics(run) if run.trace else {}
        driver.outputs()
        outcome = checks.check(run, driver)
        more = extra(run, driver) if extra is not None else None
    finally:
        shutil.rmtree(run.tmp, ignore_errors=True)
    e2e_metrics, layer_metrics = manifest.metrics_of(run.bench, run.cell)
    metrics = {}
    if run.trace:
        for m in layer_metrics:
            v = layer_values.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=run.setup_s)
        for m in e2e_metrics:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(run.workload["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": outcome["correct"], "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if run.trace and run.slice is not None:
        busy = trace.busy_ns(run.slice.ops)
        dev["busy_s"] = busy / 1e9
        dev["window_s"] = (run.slice.t1 - run.slice.t0) / 1e9
        result["breakdown"] = trace.breakdown(run.slice.ops, run.slice.t0, run.slice.t1,
                                                      run.spans)
    if more is not None:
        result["extra"] = more
    result["checks"] = outcome["checks"]
    lines = [f"note: {n}" for n in run.notes] + [
        f"check {name}: {v['value']!r} (limit {v['limit']!r})"
        for name, v in outcome["checks"].items()] + [f"correct: {outcome['correct']}"]
    return result, lines


def read_layer_metrics(run) -> dict:
    """Every per-layer metric the cell lists, by its reader; a reader that
    finds nothing returns None and the metric is left out."""
    _, layer_metrics = manifest.metrics_of(run.bench, run.cell)
    out = {}
    for m in layer_metrics:
        value = manifest.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = float(value)
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], time.time()))
