"""The port's span recorder and counters (``phoneme_vqa_torch/utils/profiling.py``)
on the CPU: spans are recorded only inside a ``torch.profiler`` session, on
the clock of its kineto events; the gathered serving engine's dispatcher and
resolver, the train step's phases and the loaders' reads record their spans
(one batch id through a served batch, the resolver's loop tiled, the step's
phases inside ``step`` under ``GRAD_ACCUM_STEPS``); ``stats()`` counts the
queue wait of every claimed request; the garbage collector's hook counts
collections with or without a session.
"""

import gc
import json
import os
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from phoneme_vqa_torch import config as t_config
from phoneme_vqa_torch import train  # noqa: F401  (registers the executors)
from phoneme_vqa_torch.data import synthetic
from phoneme_vqa_torch.data.loader import batch_iterator
from phoneme_vqa_torch.serving import ServingEngine
from phoneme_vqa_torch.utils import profiling
from phoneme_vqa_torch.utils.registry import EXECUTORS

from .fixtures import make_latr_fixture, make_sal_fixture, tiny_latr_yaml, tiny_sal_yaml

TIMEOUT = 120  # seconds a future may take
DISPATCHER = ("engine.collect", "engine.featurize", "engine.encode", "engine.handoff")
RESOLVER = ("engine.await_batch", "decode.replay", "decode.readback", "engine.detokenize",
            "engine.complete")
STEP = ("step.to_device", "step.forward", "step.backward", "step.optimizer")


def session():
    return profile(activities=[ProfilerActivity.CPU])


def executor(family: str, root, mode: str, **over):
    if family == "latr":
        paths = make_latr_fixture(root)
        yaml_path = tiny_latr_yaml(paths, os.path.join(str(root), "ck"), SAVE=False,
                                   max_eval_length=6, **over)
    else:
        paths = make_sal_fixture(root)
        yaml_path = tiny_sal_yaml(paths, os.path.join(str(root), "ck"), SAVE=False,
                                  max_eval_length=6, **over)
    config = t_config.get_config(yaml_path)
    return EXECUTORS.get(config.EXECUTOR)(config, mode, device="cpu"), paths


@pytest.fixture(scope="module")
def latr_eval(tmp_path_factory):
    ex, paths = executor("latr", tmp_path_factory.mktemp("trace_latr"), "eval")
    rows = synthetic.read_qa_csv(paths["val"])
    return ex, [(r["image_id"], r["question"]) for r in rows]


@pytest.fixture(scope="module")
def latr_train(tmp_path_factory):
    ex, _ = executor("latr", tmp_path_factory.mktemp("trace_latr_train"), "train")
    return ex


# -- the recorder ------------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["no_session", "session", "profile_dir"])
def test_spans_are_recorded_only_inside_a_profiler_session(how, tmp_path):
    on = how != "no_session"
    t0 = time.time_ns()
    region = {"no_session": _nothing(), "session": session(),
              "profile_dir": profiling.maybe_trace(str(tmp_path), "region")}[how]
    with region:
        assert profiling.recording() is on
        with profiling.tag(batch=7):
            with profiling.span("outer", rows=3) as outer:
                with profiling.span("inner") as inner:
                    if inner:
                        inner.set(files=2)
                profiling.record("elsewhere", t0, time.time_ns(), k=1)
    got = {s.name: s for s in profiling.spans(t0, time.time_ns())}
    if not on:
        assert not got and not outer and not inner
        return
    assert set(got) == {"outer", "inner", "elsewhere"}
    assert got["inner"].parent is got["outer"] and got["outer"].parent is None
    assert got["elsewhere"].parent is got["outer"]  # the span open on the thread
    assert got["outer"].attrs == {"batch": 7, "rows": 3}
    assert got["inner"].attrs == {"batch": 7, "files": 2}
    assert got["outer"].start <= got["inner"].start <= got["inner"].end <= got["outer"].end
    assert {s.thread for s in got.values()} == {"MainThread"}
    assert not profiling.recording()
    if how == "profile_dir":  # the operator's trace shows each span
        (trace,) = os.listdir(tmp_path)
        with open(tmp_path / trace, encoding="utf-8") as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert {"region", "outer", "inner"} <= names


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_a_site_with_no_session_allocates_nothing():
    def sites(n):
        for i in range(n):
            with profiling.tag(batch=i), profiling.span("x", rows=i) as sp:
                if sp:
                    sp.set(bytes=1)
            profiling.record("y", 0, 1, batch=i)

    sites(100)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        start, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        sites(2000)
        _, peak = tracemalloc.get_traced_memory()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = tracemalloc.Filter(True, profiling.__file__)
    grown = sum(d.size_diff for d in after.filter_traces([here]).compare_to(
        before.filter_traces([here]), "filename"))
    assert grown <= 0 and peak - start < 4096
    assert not profiling.spans(0, 1)


def test_a_span_holds_the_kineto_event_of_its_op():
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with session() as prof:
        with profiling.span("matmul") as sp:
            torch.mm(a, b)
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert events
    for e in events:
        start = int(e.start_ns())
        assert sp.start <= start and start + int(e.duration_ns()) <= sp.end


@pytest.mark.parametrize("on", [False, True], ids=["no_session", "session"])
def test_the_collector_is_counted_and_traced(on):
    profiling.watch_gc()
    profiling.watch_gc()  # once a process
    assert gc.callbacks.count(profiling._on_gc) == 1
    before = profiling.gc_stats()
    t0 = time.time_ns()
    with session() if on else _nothing():
        with profiling.span("work"):
            gc.collect()
    t1 = time.time_ns()
    after = profiling.gc_stats()
    assert after["collections"][2] >= before["collections"][2] + 1
    assert after["seconds"][2] > before["seconds"][2]
    window = profiling.gc_stats(t0, t1)
    assert window["complete"] and window["collections"][2] >= 1
    assert 0 < sum(window["seconds"]) <= (t1 - t0) / 1e9
    traced = [s for s in profiling.spans(t0, t1) if s.name == "gc"]
    if on:
        assert any(s.attrs["generation"] == 2 and s.parent is not None
                   and s.parent.name == "work" for s in traced)
    else:
        assert not traced


# -- the serving engine ------------------------------------------------------------------------

def _serve(ex, requests, traced: bool):
    """The requests through a gathered engine, one by one first (in a
    session, a batch whose spans all opened inside it), then all at once;
    (answers, stats, the spans of the window)."""
    with ServingEngine(ex, *ex.serve_frames, batch_size=4, max_wait_ms=20,
                       max_answer_length=6) as eng:
        t0 = time.time_ns()
        with session() if traced else _nothing():
            eng.submit(*requests[0]).result(timeout=TIMEOUT)
            answers = [f.result(timeout=TIMEOUT)
                       for f in [eng.submit(i, q) for i, q in requests]]
        stats = eng.stats()
    return answers, stats, profiling.spans(t0, time.time_ns())


@pytest.mark.parametrize("traced", [False, True], ids=["no_session", "session"])
def test_engine_spans_and_claim_counters(latr_eval, traced):
    ex, requests = latr_eval
    answers, stats, spans = _serve(ex, requests, traced)
    assert len(answers) == len(requests)
    # every answered request was claimed once, its queue wait counted
    assert stats["claimed"] == stats["served"] == len(requests) + 1
    assert 0 < stats["queue_wait_s"] < (len(requests) + 1) * TIMEOUT
    if not traced:
        assert spans == []
        return
    names = {s.name for s in spans}
    assert set(DISPATCHER + RESOLVER) | {"engine.queue", "decode.sync", "loader.read"} <= names
    assert {s.thread for s in spans if s.name in DISPATCHER} == {"serving-dispatcher"}
    assert {s.thread for s in spans if s.name in RESOLVER} == {"serving-resolver"}
    # one batch id from the gather to the futures' completion
    gathered = {s.attrs["batch"] for s in spans if s.name == "engine.collect" and s.attrs["rows"]}
    by_batch = {}
    for s in spans:
        by_batch.setdefault(s.attrs.get("batch"), set()).add(s.name)
    # (the await open when the engine stops takes no batch)
    assert by_batch.get(None, set()) <= {"gc", "engine.await_batch"}
    whole = [b for b in gathered if set(DISPATCHER + RESOLVER) <= by_batch.get(b, set())]
    assert len(whole) >= 2
    queued = [s for s in spans if s.name == "engine.queue"]
    assert len(queued) == len(requests) + 1 and all(s.end >= s.start for s in queued)
    for s in spans:
        if s.name == "decode.sync":
            assert s.parent.name == "decode.replay"
        if s.name == "decode.replay":
            assert s.attrs["chunks"] >= 1
    # the resolver's spans tile its loop: each opens where the last closed
    loop = [s for s in spans if s.thread == "serving-resolver" and s.parent is None]
    first = next(i for i, s in enumerate(loop) if s.name == "engine.complete")
    for a, b in zip(loop[first:], loop[first + 1:]):
        assert 0 <= b.start - a.end <= 50_000, (a, b)
    assert {s.name for s in loop[first:]} == set(RESOLVER)


# -- the train step and the loaders ----------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_spans_tile_the_step(latr_train, accum):
    ex = latr_train
    ex.config["GRAD_ACCUM_STEPS"] = accum
    try:
        batch, _ = next(batch_iterator(ex.train_data, 8, shuffle=True, seed=1, drop_last=True))
        step = ex.state.step
        t0 = time.time_ns()
        with session():
            loss = ex.train_step(batch)
        spans = [s for s in profiling.spans(t0, time.time_ns()) if s.name.startswith("step")]
    finally:
        ex.config["GRAD_ACCUM_STEPS"] = 1
    assert torch.isfinite(loss)
    (whole,) = [s for s in spans if s.name == "step"]
    parts = [s for s in spans if s is not whole]
    want = [n for i in range(accum) for n in STEP] + (["step.optimizer"] if accum > 1 else [])
    assert [s.name for s in parts] == want + ["step.loss"]
    assert all(s.parent is whole and s.thread == whole.thread for s in parts)
    assert all(s.attrs["step"] == step for s in spans)
    if accum > 1:
        assert [s.attrs.get("micro") for s in parts] == (
            [i for i in range(accum) for _ in STEP] + [None, None])
    bounds = [whole.start] + [t for s in parts for t in (s.start, s.end)] + [whole.end]
    assert bounds == sorted(bounds)


@pytest.mark.parametrize("family", ["latr", "sal"])
def test_a_batch_read_names_its_files(family, tmp_path):
    ex, _ = executor(family, tmp_path, "eval")
    idx = np.array([0, 1, 2, 0])
    t0 = time.time_ns()
    with session():
        batch = ex.val_data.gather(idx)
    reads = [s for s in profiling.spans(t0, time.time_ns()) if s.name == "loader.read"]
    kinds = {"latr": ["pixels"], "sal": ["ocr", "obj"]}[family]
    assert sorted(s.attrs["kind"] for s in reads) == sorted(kinds)
    for s in reads:
        assert s.attrs["files"] == len(idx) and s.attrs["bytes"] > 0
    assert len(batch[next(iter(batch))]) == len(idx)


def test_no_span_after_a_train_epoch_without_a_session(latr_train):
    t0 = time.time_ns()
    assert np.isfinite(latr_train._train_epoch(1))
    assert profiling.spans(t0, time.time_ns()) == []
