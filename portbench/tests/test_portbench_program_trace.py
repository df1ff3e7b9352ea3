"""The readers of the program's own spans and counters on canned spans,
device operations and counters: each reads its value, and None from a
program without the recorder, as at a commit from before it."""

import time
import types

import pytest

from portbench import manifest, program_trace, trace
from portbench.drivers import Steady

MS = 1_000_000
FLOOD = "latr-base.serve-flood"
TRAIN = ("phonemesal-base.train", "latr-base.train")
SERVE_METRICS = ("engine.featurize_ms.flood", "engine.encode_ms.flood",
                 "engine.queue_wait_ms.flood", "device_idle.await_batch.serve",
                 "device_idle.resolver_host.serve", "host.gc_share.serve")
TRAIN_METRICS = ("loader.read_ms.train", "device_idle.forward.train",
                 "device_idle.backward.train", "device_idle.optimizer.train",
                 "host.gc_share.train")


def _span(name, start, end):
    return types.SimpleNamespace(name=name, start=start * MS, end=end * MS, attrs={})


class _Program:
    """A program's ``utils/profiling`` module with canned spans and
    collections (end, seconds)."""

    def __init__(self, spans, collections=()):
        self._spans, self._collections = spans, collections

    def spans(self, t0, t1):
        return sorted((s for s in self._spans if s.end >= t0 and s.start <= t1),
                      key=lambda s: s.start)

    def gc_stats(self, t0, t1):
        secs = sum(max(0, min(e, t1) - max(e - d, t0)) / 1e9 for e, d in self._collections)
        return {"collections": [len(self._collections), 0, 0], "seconds": [secs, 0.0, 0.0],
                "complete": True}


def _run(ops, stats=None, steps=4):
    sl = types.SimpleNamespace(ops=sorted((trace.Op(*o) for o in ops), key=lambda o: o.start),
                               t0=0, t1=100 * MS)
    return types.SimpleNamespace(slice=sl, slice_steps=steps, spans=trace.Spans(),
                                 steady=Steady(seconds=1.0, ns=(-1000 * MS, 0), stats=stats))


@pytest.fixture
def program(monkeypatch):
    def use(module):
        monkeypatch.setattr(program_trace, "profiling", lambda: module)
    return use


def _get(name, run):
    return manifest.reader(name).read(run)


def test_serve_readers(program):
    # the card busy over [0, 30) and [50, 60) of a 100 ms slice
    ops = [("replay", 0, 30 * MS), ("vit", 50 * MS, 60 * MS)]
    spans = [
        _span("engine.featurize", 2, 6), _span("engine.featurize", 40, 44),
        _span("engine.featurize", 98, 103),  # past the slice's end: not a whole batch
        _span("engine.encode", 44, 60),
        _span("engine.await_batch", -5, 10), _span("engine.await_batch", 70, 80),
        _span("decode.replay", 10, 30), _span("decode.readback", 30, 35),
        _span("engine.detokenize", 35, 40), _span("engine.complete", 40, 45),
        _span("engine.complete", 45, 52),
    ]
    program(_Program(spans, collections=[(-500 * MS, 20 * MS), (1 * MS, 2 * MS)]))
    s0 = {"queue_wait_s": 1.0, "claimed": 100}
    s1 = {"queue_wait_s": 1.5, "claimed": 300}
    run = _run(ops, stats=(s0, s1))
    assert _get("engine.featurize_ms.flood", run) == pytest.approx(4.0)
    assert _get("engine.encode_ms.flood", run) == pytest.approx(16.0)
    assert _get("engine.queue_wait_ms.flood", run) == pytest.approx(2.5)
    # idle [30, 50) and [60, 100): the await [70, 80), the host work [30, 50)
    assert _get("device_idle.await_batch.serve", run) == pytest.approx(10.0)
    assert _get("device_idle.resolver_host.serve", run) == pytest.approx(20.0)
    # 20 ms and the 1 ms inside the window, over its 1000 ms
    assert _get("host.gc_share.serve", run) == pytest.approx(2.1)


def test_train_readers(program):
    ops = [("gemm", 0, 10 * MS), ("gemm", 20 * MS, 60 * MS), ("adam", 70 * MS, 75 * MS)]
    spans = [
        _span("loader.read", 1, 3), _span("loader.read", 3, 4), _span("loader.read", 50, 53),
        _span("step.forward", 5, 25), _span("step.backward", 25, 60),
        _span("step.optimizer", 60, 80), _span("step.forward", 85, 110),
    ]
    program(_Program(spans, collections=[(-10 * MS, 5 * MS)]))
    run = _run(ops, steps=2)
    assert _get("loader.read_ms.train", run) == pytest.approx(3.0)
    # idle [10, 20), [60, 70), [75, 100)
    assert _get("device_idle.forward.train", run) == pytest.approx(10.0 + 15.0)
    assert _get("device_idle.backward.train", run) == pytest.approx(0.0)
    assert _get("device_idle.optimizer.train", run) == pytest.approx(15.0)
    assert _get("host.gc_share.train", run) == pytest.approx(0.5)


@pytest.mark.parametrize("name", SERVE_METRICS + TRAIN_METRICS)
def test_a_program_without_the_recorder_reads_none(program, name):
    program(types.SimpleNamespace())  # the module, without spans or gc_stats
    run = _run([("gemm", 0, MS)], stats=({"decode_s": 0.0}, {"decode_s": 1.0}))
    assert _get(name, run) is None
    program(None)  # no program at all
    assert _get(name, run) is None


@pytest.mark.parametrize("name", ("engine.featurize_ms.flood", "device_idle.await_batch.serve",
                                  "loader.read_ms.train", "device_idle.forward.train"))
def test_a_slice_without_the_span_reads_none(program, name):
    program(_Program([_span("other", 0, 10)]))
    assert _get(name, _run([("gemm", 0, MS)])) is None


def test_the_program_recorder_is_read_as_it_records():
    from torch.profiler import ProfilerActivity, profile

    from phoneme_vqa_torch.utils import profiling

    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with profiling.span("engine.featurize"):
                time.sleep(0.002)
    run = _run([])
    run.slice.t0, run.slice.t1 = t0, time.time_ns()
    assert 2.0 <= _get("engine.featurize_ms.flood", run) < 1000
    assert _get("device_idle.await_batch.serve", run) is None


def test_the_cells_list_the_new_metrics():
    bench = manifest.benchmark()
    for cell, names in [(FLOOD, SERVE_METRICS)] + [(c, TRAIN_METRICS) for c in TRAIN]:
        _, layer = manifest.metrics_of(bench, cell)
        assert set(names) <= {m["name"] for m in layer}, cell
    _, layer = manifest.metrics_of(bench, FLOOD)
    assert not set(TRAIN_METRICS) & {m["name"] for m in layer}
