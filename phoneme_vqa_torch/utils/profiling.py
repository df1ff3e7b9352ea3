"""Tracing and NaN checks (counterpart of ``phoneme_vqa_tpu/utils/profiling.py``).

* :class:`StepTimer`: per-step wall clock, rolling samples/s and p50.
* :func:`maybe_trace` (``PROFILE_DIR``): the region under
  ``torch.profiler.profile`` (CPU activity, and CUDA activity on the card)
  inside a ``record_function(name)``, written as a Chrome trace into the
  directory.
* :class:`NanCheck` (``DEBUG_NANS``), the counterpart of ``jax_debug_nans``:
  a forward hook on every module raises ``FloatingPointError`` naming the
  first module whose output holds a NaN, and autograd's anomaly mode names
  the backward node that first returns one (:func:`backward`). Each check
  reads a flag back to the host, so it is skipped while a CUDA graph is
  being captured; the executor refuses ``DEBUG_NANS`` in serve mode, whose
  decode is captured.
"""

from __future__ import annotations

import contextlib
import os
import statistics
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
    ``{profile_dir}/{name}_{pid}.pt.trace.json`` (one file per process)."""
    if not profile_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(name):
            yield
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"{name}_{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    log.info(f"profiler trace written to {path}")


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
