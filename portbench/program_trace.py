"""What the program records about itself, for the per-layer readers.

* Its spans (``phoneme_vqa_torch/utils/profiling.py``: ``spans``), named host
  intervals on the clock of the profiler's events, which the program records
  while the traced run's profiler slice runs: the serving engine's dispatcher
  and resolver, the train step's phases, the loaders' reads, the garbage
  collector.
* Its garbage collector's counts (``gc_stats``), always kept.

Each function returns None where the program has no recorder (a commit from
before it) or recorded nothing there, so the reader leaves its metric out.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from portbench import trace


def profiling():
    """The program's ``utils/profiling`` module, or None."""
    try:
        from phoneme_vqa_torch.utils import profiling as module
    except ImportError:
        return None
    return module


def slice_spans(run, names: Iterable[str]) -> Optional[list]:
    """The program's spans of these names that overlap the traced slice; None
    without a slice or a recorder, or where none was recorded."""
    module = profiling()
    if run.slice is None or module is None or not hasattr(module, "spans"):
        return None
    names = set(names)
    found = [s for s in module.spans(run.slice.t0, run.slice.t1) if s.name in names]
    return found or None


def mean_ms(run, name: str) -> Optional[float]:
    """The mean length of the spans ``name`` that lie in the slice, in ms."""
    found = [s for s in slice_spans(run, [name]) or ()
             if s.start >= run.slice.t0 and s.end <= run.slice.t1]
    if not found:
        return None
    return sum(s.end - s.start for s in found) / len(found) / 1e6


def per_step_ms(run, name: str) -> Optional[float]:
    """The length of the spans ``name`` that open in the slice, summed, over
    the train steps traced, in ms."""
    steps = getattr(run, "slice_steps", 0)
    found = [s for s in slice_spans(run, [name]) or ()
             if run.slice.t0 <= s.start < run.slice.t1]
    if not found or not steps:
        return None
    return sum(s.end - s.start for s in found) / steps / 1e6


def union(intervals: Iterable[tuple]) -> List[tuple]:
    """Sorted, disjoint (start, end) pairs covering ``intervals``."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [tuple(x) for x in out]


def overlap_ns(a: List[tuple], b: List[tuple]) -> int:
    """The length of the intersection of two sorted, disjoint lists of
    (start, end) pairs."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share(run, names: Iterable[str]) -> Optional[float]:
    """The card's idle time while one of the spans ``names`` is open (no
    device operation runs: ``trace.gaps``), over the slice, in %."""
    found = slice_spans(run, names)
    if not found:
        return None
    t0, t1 = run.slice.t0, run.slice.t1
    held = union((max(s.start, t0), min(s.end, t1)) for s in found)
    idle = trace.gaps(run.slice.ops, t0, t1)
    return 100.0 * overlap_ns(held, idle) / (t1 - t0)


def gc_share(run) -> Optional[float]:
    """The garbage collector's seconds over the window before the traced
    slice, in % of it; None where the program does not count them or its
    log does not reach back to the window's start."""
    module = profiling()
    if module is None or not hasattr(module, "gc_stats"):
        return None
    t0, t1 = run.steady.ns
    stats = module.gc_stats(t0, t1)
    if not stats.get("complete", False) or t1 <= t0:
        return None
    return 100.0 * sum(stats["seconds"]) / ((t1 - t0) / 1e9)
