"""Tracing and NaN checks (counterpart of ``phoneme_vqa_tpu/utils/profiling.py``).

* :class:`StepTimer`: per-step wall clock, rolling samples/s and p50.
* :func:`maybe_trace` (``PROFILE_DIR``): the region under
  ``torch.profiler.profile`` (CPU activity, and CUDA activity on the card)
  inside a ``record_function(name)``, written as a Chrome trace into the
  directory.
* The span recorder: :func:`span`, :func:`record` and :func:`spans`, named
  host intervals on the ``time.time_ns()`` clock (the clock of the
  profiler's kineto events), kept in memory and recorded only while a
  ``torch.profiler`` session runs; :func:`tag` adds attributes (a batch
  id, a step) to every span a thread opens inside it.
* :func:`gc_stats`: the garbage collector's collections and seconds of
  each generation, always counted once :func:`watch_gc` has run; while
  the recorder is on, each collection is also a ``gc`` span.
* :class:`NanCheck` (``DEBUG_NANS``), the counterpart of ``jax_debug_nans``:
  a forward hook on every module raises ``FloatingPointError`` naming the
  first module whose output holds a NaN, and autograd's anomaly mode names
  the backward node that first returns one (:func:`backward`). Each check
  reads a flag back to the host, so it is skipped while a CUDA graph is
  being captured; the executor refuses ``DEBUG_NANS`` in serve mode, whose
  decode is captured.
"""

from __future__ import annotations

import array
import collections
import contextlib
import gc
import os
import statistics
import threading
import time
from typing import List, Optional

import torch

from .logger import get_logger

log = get_logger(__name__)


class StepTimer:
    """Rolling per-step timing; call `tick(n_samples)` once per step."""

    def __init__(self, window: int = 100):
        self.window = window
        self._durations: List[float] = []
        self._samples: List[int] = []
        self._last: Optional[float] = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def tick(self, n_samples: int) -> float:
        now = time.perf_counter()
        dt = now - (self._last if self._last is not None else now)
        self._last = now
        self._durations.append(dt)
        self._samples.append(n_samples)
        if len(self._durations) > self.window:
            self._durations.pop(0)
            self._samples.pop(0)
        return dt

    @property
    def samples_per_sec(self) -> float:
        total = sum(self._durations)
        return sum(self._samples) / total if total else 0.0

    @property
    def p50_ms(self) -> float:
        return statistics.median(self._durations) * 1000 if self._durations else 0.0

    def summary(self) -> str:
        return f"{self.samples_per_sec:.1f} samples/s, p50 {self.p50_ms:.1f} ms/step"


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str], name: str = "step", cuda: bool = False):
    """A ``torch.profiler`` trace of the region when ``profile_dir`` is set
    (CUDA activity too when ``cuda``), else a no-op. The trace is written to
    ``{profile_dir}/{name}_{pid}.pt.trace.json`` (one file per process).
    The recorder is on inside it, and each span also opens a
    ``record_function`` of its name, so the trace shows the spans."""
    if not profile_dir:
        yield
        return
    global _chrome
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(name):
            _chrome += 1
            try:
                yield
            finally:
                _chrome -= 1
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"{name}_{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    log.info(f"profiler trace written to {path}")


# -- the span recorder -------------------------------------------------------------------

_profiler = torch.autograd.profiler
#: spans kept in memory; the oldest drop out
MAX_SPANS = 1 << 18
#: on a tiled thread, a top-level span opens where the last one closed if
#: that was less than this long ago (longer: the recorder was off between)
TILE_NS = 50_000_000
_spans: "collections.deque" = collections.deque(maxlen=MAX_SPANS)
_chrome = 0  # maybe_trace regions open: spans also open a record_function


class _ThreadState(threading.local):
    def __init__(self):
        self.stack: list = []  # the thread's open spans, innermost last
        self.tags: Optional[dict] = None
        self.tiled = False
        self.last_end = 0  # end of the thread's last top-level span


_thread = _ThreadState()


def recording() -> bool:
    """Whether the recorder is on: a ``torch.profiler`` session is running."""
    return _profiler._is_profiler_enabled


class Span:
    """One host interval: ``name``, ``start`` and ``end`` (ns,
    ``time.time_ns()``), the ``thread``'s name, its ``parent`` (the
    innermost span open on that thread when it opened, or None) and
    ``attrs``. As a context manager it times the ``with`` block."""

    __slots__ = ("name", "start", "end", "thread", "parent", "attrs", "_fn")

    def __init__(self, name: str, attrs: dict, parent=None, start: int = 0, end: int = 0):
        self.name, self.attrs, self.parent = name, attrs, parent
        self.start, self.end = start, end
        self.thread = threading.current_thread().name
        self._fn = None

    def __bool__(self) -> bool:
        return True

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        state = _thread
        stack = state.stack
        self.parent = stack[-1] if stack else None
        stack.append(self)
        if _chrome:
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        self.start = time.time_ns()
        if self.parent is None and state.tiled and self.start - state.last_end < TILE_NS:
            self.start = state.last_end
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        if self._fn is not None:
            self._fn.__exit__(*exc)
            self._fn = None
        state = _thread
        state.stack.remove(self)
        if self.parent is None:
            state.last_end = self.end
        _spans.append(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {(self.end - self.start) / 1e3:.1f} us, "
                f"thread={self.thread!r}, attrs={self.attrs!r})")


class _Off:
    """What :func:`span` and :func:`tag` return while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def _attrs(attrs: dict) -> dict:
    tags = _thread.tags
    return {**tags, **attrs} if tags else attrs


def span(name: str, **attrs):
    """``with span(name, **attrs) as s:`` records the block as a span while
    a ``torch.profiler`` session runs; ``s.set(...)`` adds attributes.
    With no session it costs one flag check and allocates nothing, and
    ``s`` is false, so a site can skip computing attributes
    (``if s: s.set(bytes=...)``)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, _attrs(attrs))


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Records an interval whose start was taken elsewhere (``time.time_ns()``
    clock); its parent is the innermost span open on the calling thread.
    Nothing while the recorder is off."""
    if not _profiler._is_profiler_enabled:
        return
    stack = _thread.stack
    _spans.append(Span(name, _attrs(attrs), stack[-1] if stack else None, start_ns, end_ns))


class _Tags:
    __slots__ = ("attrs", "_prev")

    def __init__(self, attrs: dict):
        self.attrs = attrs

    def __enter__(self):
        self._prev = _thread.tags
        _thread.tags = {**self._prev, **self.attrs} if self._prev else self.attrs
        return self

    def __exit__(self, *exc):
        _thread.tags = self._prev
        return False


def tag(**attrs):
    """``with tag(batch=7):`` every span the thread opens or records inside
    the block carries these attributes (a span's own attributes win)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Tags(attrs)


def tile_thread() -> None:
    """Marks the calling thread's top-level spans as tiling its time: each
    opens where the last one closed (within :data:`TILE_NS`), so the code
    between two spans counts to the next and the spans leave no gap. For a
    loop made of spans (the serving engine's threads)."""
    _thread.tiled = True


def spans(t0_ns: Optional[int] = None, t1_ns: Optional[int] = None) -> List[Span]:
    """The recorded spans that overlap ``[t0_ns, t1_ns]`` (either end open
    when None), by start."""
    for _ in range(8):
        try:
            items = list(_spans)
            break
        except RuntimeError:  # appended to meanwhile (a collection's span)
            continue
    else:
        items = []
    lo = -1 if t0_ns is None else t0_ns
    hi = float("inf") if t1_ns is None else t1_ns
    out = [s for s in items if s.end >= lo and s.start <= hi]
    out.sort(key=lambda s: s.start)
    return out


# -- the garbage collector -------------------------------------------------------------------

#: collections kept (end, duration, generation) for windowed counts
GC_LOG = 1 << 17
_gc_log_end = array.array("q", bytes(8 * GC_LOG))
_gc_log_ns = array.array("q", bytes(8 * GC_LOG))
_gc_log_gen = array.array("b", bytes(GC_LOG))
_gc = {"logged": 0, "start": 0, "collections": [0, 0, 0], "ns": [0, 0, 0]}


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        _gc["start"] = time.time_ns()
        return
    end, start, gen = time.time_ns(), _gc["start"], info["generation"]
    if not start:
        return
    _gc["start"] = 0
    _gc["collections"][gen] += 1
    _gc["ns"][gen] += end - start
    i = _gc["logged"] % GC_LOG
    _gc_log_end[i], _gc_log_ns[i], _gc_log_gen[i] = end, end - start, gen
    _gc["logged"] += 1
    if _profiler._is_profiler_enabled:
        record("gc", start, end, generation=gen, collected=info.get("collected", 0))


def watch_gc() -> None:
    """Hooks the garbage collector (once a process): from here on every
    collection is counted, and is a ``gc`` span while the recorder is on.
    The serving engine and the executors call it when they are built."""
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)


def gc_stats(t0_ns: Optional[int] = None, t1_ns: Optional[int] = None) -> dict:
    """``{"collections": [n0, n1, n2], "seconds": [s0, s1, s2]}`` by
    generation since :func:`watch_gc`, or, given a window, of the
    collections that overlap it (seconds clipped to it) with
    ``"complete"``: whether the log of the last :data:`GC_LOG` collections
    reaches back to ``t0_ns``."""
    if t0_ns is None and t1_ns is None:
        return {"collections": list(_gc["collections"]),
                "seconds": [n / 1e9 for n in _gc["ns"]]}
    lo = -1 if t0_ns is None else t0_ns
    hi = float("inf") if t1_ns is None else t1_ns
    logged = _gc["logged"]
    first = max(0, logged - GC_LOG)
    counts, ns = [0, 0, 0], [0, 0, 0]
    for k in range(first, logged):
        i = k % GC_LOG
        end, gen = _gc_log_end[i], _gc_log_gen[i]
        start = end - _gc_log_ns[i]
        if end >= lo and start <= hi:
            counts[gen] += 1
            ns[gen] += min(end, hi) - max(start, lo)
    i = first % GC_LOG
    complete = first == 0 or _gc_log_end[i] - _gc_log_ns[i] <= lo
    return {"collections": counts, "seconds": [n / 1e9 for n in ns], "complete": complete}


def _has_nan(value) -> bool:
    if isinstance(value, torch.Tensor):
        return value.is_floating_point() and bool(torch.isnan(value).any())
    if isinstance(value, dict):
        return any(_has_nan(v) for v in value.values())
    if isinstance(value, (tuple, list)):
        return any(_has_nan(v) for v in value)
    return False


def _on_cuda(value) -> bool:
    if isinstance(value, torch.Tensor):
        return value.is_cuda
    if isinstance(value, dict):
        return any(_on_cuda(v) for v in value.values())
    if isinstance(value, (tuple, list)):
        return any(_on_cuda(v) for v in value)
    return False


class NanCheck:
    """``DEBUG_NANS`` over one model: forward hooks on every module and
    autograd's anomaly mode, until :meth:`close`. The hooks of a module run
    after those of the modules inside it, so the module named is the
    innermost one whose output first holds a NaN."""

    def __init__(self, model: torch.nn.Module):
        self._handles = [m.register_forward_hook(self._hook(name or type(m).__name__))
                         for name, m in model.named_modules()]
        self._anomaly = torch.is_anomaly_enabled()
        torch.autograd.set_detect_anomaly(True, check_nan=True)

    @staticmethod
    def _hook(name: str):
        def check(module, args, output):
            if _on_cuda(output) and torch.cuda.is_current_stream_capturing():
                return
            if _has_nan(output):
                raise FloatingPointError(f"DEBUG_NANS: NaN in the forward output of {name} "
                                         f"({type(module).__name__})")
        return check

    def close(self) -> None:
        for handle in self._handles:
            handle.remove()
        self._handles = []
        torch.autograd.set_detect_anomaly(self._anomaly)


def backward(loss: torch.Tensor) -> None:
    """``loss.backward()``; under anomaly mode a backward node that returns
    a NaN raises ``FloatingPointError`` naming it, as ``jax_debug_nans``
    raises, in place of autograd's ``RuntimeError``."""
    try:
        loss.backward()
    except RuntimeError as e:
        if "returned nan values" not in str(e):
            raise
        raise FloatingPointError(f"DEBUG_NANS: {e}") from e
