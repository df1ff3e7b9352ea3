"""Device-stall watchdog for the serving engines (counterpart of
``phoneme_vqa_tpu/serving/watchdog.py``).

A lost or hung card makes a device read (a ``.tolist()``, a
``synchronize()``) block inside a C call that no Python mechanism can
interrupt. Without detection, every in-flight future never resolves and
``stop()`` deadlocks joining the stuck worker. The watchdog fails the
in-flight work loudly, marks the engine unhealthy (``/healthz`` turns 503),
keeps ``stop()`` returning, and leaves the stuck daemon thread behind rather
than waiting on it.

Over a serving mesh a rank that died or hangs is the same fault seen from
rank 0: its next collective (a batch's broadcast, the decode's model-axis
collectives, the answers' gather, or the no-op rank 0 sends when idle)
raises once the process group's timeout passes (``--group-timeout``; a
dead peer's closed socket usually raises at once), and the engines treat a
collective that raises as fatal: the in-flight futures fail and the engine
turns unhealthy. A collective blocked past the stall timeout first fires
this watchdog, whichever comes first.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..utils.logger import get_logger

log = get_logger(__name__)


class StallWatchdog:
    """Watches guarded device operations; fires ``on_stall`` ONCE if any
    single operation exceeds ``timeout_s``.

    Usage: the engine wraps every device call that may hang in
    ``with watchdog.guard("decode"):``. A monitor thread (started lazily at
    the first guard, ~4 checks per timeout window) compares the oldest
    operation in progress against the timeout. The stuck thread itself is
    NOT interrupted (it cannot be): the callback runs on the monitor thread
    and fails the futures and flips the health.
    """

    def __init__(self, timeout_s: float, on_stall: Callable[[str, float], None]):
        self.timeout_s = float(timeout_s)
        self._on_stall = on_stall
        self._lock = threading.Lock()
        self._ops: dict = {}  # id -> (label, t_start)
        self._next_id = 0
        self._fired = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def fired(self) -> bool:
        return self._fired

    def guard(self, label: str):
        return _Guard(self, label)

    def _enter(self, label: str) -> int:
        with self._lock:
            op_id = self._next_id
            self._next_id += 1
            self._ops[op_id] = (label, time.monotonic())
            if self._thread is None and self.timeout_s > 0:
                self._thread = threading.Thread(
                    target=self._monitor, daemon=True, name="serving-stall-watchdog",
                )
                self._thread.start()
        return op_id

    def _exit(self, op_id: int) -> None:
        with self._lock:
            self._ops.pop(op_id, None)

    def close(self) -> None:
        self._stop.set()

    def _monitor(self) -> None:
        interval = max(self.timeout_s / 4.0, 0.05)
        while not self._stop.wait(interval):
            now = time.monotonic()
            with self._lock:
                if self._fired:
                    return
                stuck = [(label, now - t0) for label, t0 in self._ops.values()
                         if now - t0 > self.timeout_s]
                if not stuck:
                    continue
                self._fired = True
            label, waited = max(stuck, key=lambda x: x[1])
            log.error(
                f"(!!) device stall: {label!r} has blocked for {waited:.1f}s "
                f"(> {self.timeout_s:.0f}s): failing in-flight requests and marking the "
                "engine unhealthy (lost or hung card?)"
            )
            try:
                self._on_stall(label, waited)
            except Exception as e:  # pragma: no cover: must never re-raise
                log.error(f"(!) stall handler itself failed: {e!r}")
            return


class _Guard:
    __slots__ = ("_wd", "_label", "_id")

    def __init__(self, wd: StallWatchdog, label: str):
        self._wd = wd
        self._label = label

    def __enter__(self):
        self._id = self._wd._enter(self._label)
        return self

    def __exit__(self, *exc):
        self._wd._exit(self._id)
        return False


def fail_future(fut, exc) -> bool:
    """Resolve ``fut`` with ``exc`` if still unresolved (idempotent: the
    stall path and a late-returning worker may race on the same future)."""
    if fut.done():
        return False
    try:
        fut.set_exception(exc)
        return True
    except Exception:  # already resolved or cancelled in the race window
        return False
