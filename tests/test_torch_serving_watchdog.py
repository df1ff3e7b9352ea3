"""The port's serving engines survive a dead device and enforce in-flight
deadlines (the five cases of ``tests/test_serving_watchdog.py``).

A hung card makes a device read block inside a C call: without the stall
watchdog, every in-flight future hangs and stop() deadlocks on join(). A
hanging or raising dispatch / resolve stands in for the failure: futures
fail fast with a clear error, the engine turns unhealthy (submits reject,
``unhealthy_reason`` set), and stop() always returns. A batched or slotted
request whose deadline passes mid-decode resolves TimeoutError at the next
batch / dispatch boundary.
"""

import os
import threading
import time

import pytest

from phoneme_vqa_torch import config as t_config
from phoneme_vqa_torch import train  # noqa: F401  (registers the executors)
from phoneme_vqa_torch.data import synthetic
from phoneme_vqa_torch.serving import ContinuousEngine, ServingEngine
from phoneme_vqa_torch.utils.registry import EXECUTORS

from .fixtures import make_latr_fixture, tiny_latr_yaml


@pytest.fixture(scope="module")
def latr(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wd_latr")
    paths = make_latr_fixture(tmp)
    config = t_config.get_config(tiny_latr_yaml(
        paths, os.path.join(str(tmp), "ck"), NUM_EPOCHS=1, SAVE=False, max_eval_length=10,
        DTYPE="float32"))
    ex = EXECUTORS.get(config.EXECUTOR)(config, "eval", device="cpu")
    rows = synthetic.read_qa_csv(paths["val"])
    return ex, ex.serve_frames[0], rows


def _stop_returns(eng, within_s: float = 10.0):
    t = threading.Thread(target=eng.stop)
    t.start()
    t.join(timeout=within_s)
    assert not t.is_alive(), "stop() did not return"


def test_continuous_hanging_dispatch_fails_fast(latr):
    ex, ocr, rows = latr
    row = rows[0]
    release = threading.Event()
    eng = ContinuousEngine(ex, ocr, num_slots=2, prefill_chunk=2, horizon=2,
                           max_answer_length=10, stall_timeout_s=1.0)
    try:
        real = eng._dispatch

        def hanging(*a, **kw):
            release.wait()  # the dead-device block
            return real(*a, **kw)

        eng._dispatch = hanging
        fut = eng.submit(row["image_id"], row["question"])
        with pytest.raises(RuntimeError, match="device stall"):
            fut.result(timeout=30)
        assert eng.unhealthy_reason is not None
        assert eng.stats()["unhealthy"] is not None
        with pytest.raises(RuntimeError, match="unhealthy"):
            eng.submit(row["image_id"], row["question"])
        _stop_returns(eng)
    finally:
        release.set()  # unblock the abandoned daemon thread


def test_continuous_raising_dispatch_fails_fast(latr):
    ex, ocr, rows = latr
    row = rows[0]
    eng = ContinuousEngine(ex, ocr, num_slots=2, prefill_chunk=2, horizon=2,
                           max_answer_length=10)

    def boom(*a, **kw):
        raise RuntimeError("device exploded")

    eng._dispatch = boom
    fut = eng.submit(row["image_id"], row["question"])
    with pytest.raises(RuntimeError, match="device exploded"):
        fut.result(timeout=30)
    assert "device exploded" in eng.unhealthy_reason
    _stop_returns(eng)


def test_continuous_in_flight_deadline(latr):
    """A slotted request whose deadline passes MID-DECODE expires at the next
    dispatch boundary (TimeoutError + kill mask), and the engine keeps
    serving."""
    ex, ocr, rows = latr
    eng = ContinuousEngine(ex, ocr, num_slots=2, prefill_chunk=2, horizon=1,
                           max_answer_length=20)
    try:
        real = eng._dispatch

        def slow(*a, **kw):
            time.sleep(0.15)  # one dispatch outlives the deadline below
            return real(*a, **kw)

        eng._dispatch = slow
        fut = eng.submit(rows[0]["image_id"], rows[0]["question"], deadline_s=0.05)
        with pytest.raises(TimeoutError, match="mid-decode"):
            fut.result(timeout=60)
        assert eng.stats()["expired"] == 1
        assert eng.unhealthy_reason is None  # expiry is not a failure
        eng._dispatch = real
        # the killed slot is reusable and the engine still answers
        assert isinstance(eng.answer(rows[1]["image_id"], rows[1]["question"], timeout=120),
                          str)
    finally:
        eng.stop()


def test_gathered_hanging_resolve_fails_fast(latr):
    ex, ocr, rows = latr
    row = rows[0]
    release = threading.Event()
    eng = ServingEngine(ex, ocr, batch_size=2, max_wait_ms=5, max_answer_length=10,
                        stall_timeout_s=1.0)
    real_async = ex.infer_async
    try:
        def hanging_async(*a, **kw):
            resolve = real_async(*a, **kw)

            def blocked():
                release.wait()
                return resolve()

            return blocked

        ex.infer_async = hanging_async
        fut = eng.submit(row["image_id"], row["question"])
        with pytest.raises(RuntimeError, match="device stall"):
            fut.result(timeout=30)
        assert eng.unhealthy_reason is not None
        with pytest.raises(RuntimeError, match="unhealthy"):
            eng.submit(row["image_id"], row["question"])
        _stop_returns(eng)
    finally:
        release.set()
        ex.infer_async = real_async


def test_gathered_in_flight_deadline(latr):
    """A batched request whose deadline passes while the batch decodes
    resolves TimeoutError at the batch boundary; the engine keeps serving."""
    ex, ocr, rows = latr
    eng = ServingEngine(ex, ocr, batch_size=2, max_wait_ms=5, max_answer_length=10)
    real_async = ex.infer_async
    try:
        def slow_async(*a, **kw):
            resolve = real_async(*a, **kw)

            def slow():
                time.sleep(0.2)
                return resolve()

            return slow

        ex.infer_async = slow_async
        fut = eng.submit(rows[0]["image_id"], rows[0]["question"], deadline_s=0.05)
        with pytest.raises(TimeoutError, match="mid-decode"):
            fut.result(timeout=60)
        assert eng.stats()["expired"] == 1
        assert eng.unhealthy_reason is None
        ex.infer_async = real_async
        assert isinstance(eng.answer(rows[1]["image_id"], rows[1]["question"], timeout=120),
                          str)
    finally:
        ex.infer_async = real_async
        eng.stop()
