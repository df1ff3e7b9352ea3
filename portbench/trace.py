"""The benchmark's own spans and the profiler slice of a traced run.

* :class:`Spans` records named host intervals (``loader``, ``train_step``,
  ``submit``) on the ``time.time_ns()`` clock, which is the clock of the
  profiler's events.
* :class:`Slice` runs ``torch.profiler`` over CUDA activity alone (no host
  op recording, so it costs the host little) for a few seconds inside the
  window and keeps every device operation: kernels, copies and sets.
* :func:`busy_ns` is the union of the device intervals, so overlapping
  operations count once; :func:`breakdown` gives the device operations that
  took most time and the longest idle gaps, each named by the host span it
  fell in.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from typing import List, NamedTuple, Optional


class Op(NamedTuple):
    name: str
    start: int  # ns, time.time_ns() clock
    end: int


class Spans:
    """Named host intervals, kept in memory, from any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items: List[Op] = []

    def add(self, name: str, start: int, end: int) -> None:
        with self._lock:
            self.items.append(Op(name, start, end))

    def within(self, name: str, t0: int, t1: int) -> List[Op]:
        with self._lock:
            return [s for s in self.items if s.name == name and s.start >= t0 and s.end <= t1]


class Slice:
    """``with Slice() as s:`` profiles the card's activity; afterwards
    ``s.ops`` (sorted device operations), ``s.t0`` / ``s.t1`` (ns)."""

    def __init__(self, device):
        self.device = device
        self.ops: List[Op] = []
        self.t0 = self.t1 = 0

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        activity = ProfilerActivity.CUDA if self.device.type == "cuda" else ProfilerActivity.CPU
        self._prof = profile(activities=[activity])
        self._prof.__enter__()
        self.t0 = time.time_ns()
        return self

    def mark_end(self) -> None:
        """Ends the slice's span here; the profiler itself stops at the
        ``with``'s exit, once the caller has let the work in flight drain
        (stopping it while other threads launch work can hang)."""
        self.t1 = time.time_ns()

    def __exit__(self, *exc):
        self._sync()
        self.t1 = self.t1 or time.time_ns()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.ops = device_ops(self._prof, self.t0, self.t1)
        return False


def device_ops(prof, t0: int, t1: int) -> List[Op]:
    """The device operations of a finished profile, clipped to [t0, t1]."""
    from torch.autograd import DeviceType

    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        s, d = int(e.start_ns()), int(e.duration_ns())
        s, end = max(s, t0), min(s + d, t1)
        if end > s:
            ops.append(Op(e.name(), s, end))
    ops.sort(key=lambda o: o.start)
    return ops


def busy_ns(ops: List[Op]) -> int:
    """Length of the union of the operations' intervals."""
    total, cur_s, cur_e = 0, None, None
    for o in ops:
        if cur_e is None or o.start > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = o.start, o.end
        else:
            cur_e = max(cur_e, o.end)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def matching_ns(ops: List[Op], pattern) -> Optional[int]:
    """Total device time of the operations whose name matches ``pattern``
    (a compiled regex); None when none does."""
    hits = [o.end - o.start for o in ops if pattern.search(o.name)]
    return sum(hits) if hits else None


def gaps(ops: List[Op], t0: int, t1: int) -> List[tuple]:
    """(start, end) of every interval in [t0, t1] with no device operation."""
    out, cursor = [], t0
    for o in ops:
        if o.start > cursor:
            out.append((cursor, o.start))
        cursor = max(cursor, o.end)
    if t1 > cursor:
        out.append((cursor, t1))
    return out


def breakdown(ops: List[Op], t0: int, t1: int, spans: Spans, top: int = 10) -> dict:
    """The ``top`` device operations by total seconds, and the idle seconds
    by the host span that was open when each gap began (``other`` where
    none was)."""
    by_op = defaultdict(int)
    for o in ops:
        by_op[o.name[:120]] += o.end - o.start
    device = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    with spans._lock:
        items = sorted((s for s in spans.items if s.end >= t0 and s.start <= t1),
                       key=lambda s: s.start)
    starts = [s.start for s in items]
    by_span = defaultdict(int)
    for g0, g1 in gaps(ops, t0, t1):
        label = "other"
        # the latest-opened span that is still open at the gap's start
        for s in reversed(items[max(0, bisect.bisect_right(starts, g0) - 256):
                                bisect.bisect_right(starts, g0)]):
            if g0 < s.end:
                label = s.name
                break
        by_span[label] += g1 - g0
    idle = sorted(by_span.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v / 1e9] for n, v in device],
            "idle_gaps": [[n, v / 1e9] for n, v in idle]}
