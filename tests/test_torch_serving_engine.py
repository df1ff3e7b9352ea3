"""The port's gathered-batch ``ServingEngine`` against the JAX package's, on
the CPU in f32 at tiny widths: both executors are built from one tiny YAML
(the port's weights carried across from flax by ``models/bridge.py``), and
the engines answer the same requests with the same strings for LaTr, SaL
with an object store, CustomizedSaL (BPE), PhonemeLaTr and PhonemeSaL.
Then the engine's own behaviour, as ``tests/test_serving.py`` pins it for
the JAX engine: buckets, partial batches, admission, the answer cache,
the access log, stats and backpressure, deadlines and shedding, the
Prometheus text, confidence, reload, the graph decoder's chunked decode,
and the knobs that are not ported yet.
"""

import json
import logging
import math
import os
import time

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from phoneme_vqa_torch import config as t_config
from phoneme_vqa_torch import serve as t_serve
from phoneme_vqa_torch import train  # noqa: F401  (registers the executors)
from phoneme_vqa_torch.data import synthetic
from phoneme_vqa_torch.data.loader import batch_iterator
from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.models.generate import build_generate_fn
from phoneme_vqa_torch.serving import GraphDecoder, ServingEngine
from phoneme_vqa_torch.serving import graphs as t_graphs
from phoneme_vqa_torch.utils.registry import EXECUTORS as T_EXECUTORS
from phoneme_vqa_tpu import registry_setup  # noqa: F401
from phoneme_vqa_tpu.config import get_config
from phoneme_vqa_tpu.serving import ServingEngine as JServingEngine
from phoneme_vqa_tpu.utils.registry import EXECUTORS

from .fixtures import (
    ANSWERS,
    QUESTIONS,
    make_latr_fixture,
    make_sal_fixture,
    tiny_latr_yaml,
    tiny_sal_yaml,
)

TIMEOUT = 120  # seconds a future may take: a hang fails, never eats the tier
CUSTOM = dict(n_head=4, num_decoder_layers=2)
FAMILIES = {
    "latr": ("latr", dict()),
    "sal": ("sal", dict()),
    "customized_sal_bpe": ("sal", dict(
        CUSTOM, EXECUTOR="CustomizedSaL_Executor", MODEL_CLASS="CustomizedSaL",
        MODEL_MOD_CONFIG_CLASS="CustomizedSaL_config", DecodeTokenizer="BPE_Tokenizer",
        bpe_step=4, max_vocab_size=300)),
    "phoneme_latr": ("latr", dict(
        CUSTOM, EXECUTOR="PhonemeLaTr_Executor", MODEL_CLASS="PhonemeLaTr",
        MODEL_MOD_CONFIG_CLASS="CustomizedLaTr_config", max_a_length=16)),
    "phoneme_sal": ("sal", dict(
        CUSTOM, EXECUTOR="PhonemeSaL_Executor", MODEL_CLASS="PhonemeSaL",
        MODEL_MOD_CONFIG_CLASS="CustomizedSaL_config", max_a_length=24)),
}


def write_annotations(root) -> str:
    ann = {"annotations": [{"question": q, "answers": [a]} for q, a in zip(QUESTIONS, ANSWERS)]}
    path = os.path.join(str(root), "annotations.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(ann, f, ensure_ascii=False)
    return path


def family_pair(family, root, mode="eval", **over):
    """(JAX executor, port executor, port config, requests) of a family in
    f32 from one tiny YAML, the port's weights the JAX one's. Both share
    the answer vocabulary files (BPE, structured phoneme)."""
    stream, keys = FAMILIES[family]
    root = str(root)
    kw = dict(keys, NUM_EPOCHS=1, SAVE=False, max_eval_length=10, DTYPE="float32",
              vocab_save_path=os.path.join(root, "bpe.json"),
              vocab_path=os.path.join(root, "phoneme_vocab.json"), **over)
    if stream == "latr":
        paths = make_latr_fixture(root)
        kw["annotation_paths"] = [write_annotations(root)]
        yaml_path = tiny_latr_yaml(paths, os.path.join(root, "ck"), **kw)
    else:
        paths = make_sal_fixture(root)
        yaml_path = tiny_sal_yaml(paths, os.path.join(root, "ck"), **kw)
    j_config = get_config(yaml_path)
    j_ex = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="eval")
    t_cfg = t_config.Config(dict(j_config))
    t_ex = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, mode, device="cpu")
    t_ex.load_params(bridge.flax_to_state_dict(
        jax.tree.map(np.asarray, j_ex._ensure_params()), t_ex.model))
    rows = synthetic.read_qa_csv(paths["val"])
    return j_ex, t_ex, t_cfg, [(r["image_id"], r["question"]) for r in rows]


def submit_all(engine, requests):
    futures = [engine.submit(i, q) for i, q in requests]
    return [f.result(timeout=TIMEOUT) for f in futures]


@pytest.fixture(scope="module")
def latr(tmp_path_factory):
    return family_pair("latr", tmp_path_factory.mktemp("serve_latr"))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_answers_equal_the_jax_engine(family, tmp_path):
    j_ex, t_ex, t_cfg, reqs = family_pair(family, tmp_path)
    with JServingEngine(j_ex, *j_ex.serve_frames, batch_size=4, max_wait_ms=20,
                        max_answer_length=10) as eng:
        want = submit_all(eng, reqs)
    with ServingEngine(t_ex, *t_ex.serve_frames, batch_size=4, max_wait_ms=20,
                       max_answer_length=10) as eng:
        got = submit_all(eng, reqs)
        assert eng._graphs and set(eng._decoders) == {4}  # the graph decoder, eager here
    assert got == want and len(got) == 6
    assert got == t_ex.infer(t_ex.val_data, 4, 10)


def test_buckets_equal_a_direct_infer(latr):
    """A lone request decodes at the smallest bucket, a burst at bigger ones,
    and every answer is ``infer``'s."""
    _, t_ex, _, reqs = latr
    want = t_ex.infer(t_ex.val_data, 4, 10)
    with ServingEngine(t_ex, *t_ex.serve_frames, batch_size=4, max_wait_ms=20,
                       max_answer_length=10, buckets=[1, 2, 99]) as eng:
        assert eng.buckets == [1, 2, 4]
        lone = eng.answer(*reqs[0], timeout=TIMEOUT)
        got = submit_all(eng, reqs)
        s = eng.stats()
    assert lone == want[0] and got == want
    assert s["bucket_batches"].get("1") >= 1
    assert sum(s["bucket_batches"].values()) == s["batches"]
    with pytest.raises(ValueError, match="positive"):
        ServingEngine(t_ex, *t_ex.serve_frames, warmup=False, buckets=[0])


def test_partial_batch_flush_and_reuse(latr):
    _, t_ex, _, reqs = latr
    with ServingEngine(t_ex, *t_ex.serve_frames, batch_size=8, max_wait_ms=1,
                       max_answer_length=10) as eng:
        first = eng.answer(*reqs[0], timeout=TIMEOUT)  # flushed by the timeout
        second = eng.answer(*reqs[0], timeout=TIMEOUT)  # the engine keeps serving
    assert first == second and isinstance(first, str)


def test_unknown_image_and_stopped_engine(latr):
    _, t_ex, _, _ = latr
    with ServingEngine(t_ex, *t_ex.serve_frames, batch_size=2, max_wait_ms=1) as eng:
        with pytest.raises(KeyError):
            eng.submit("no-such-image", "câu hỏi?")
        eng.stop()
        with pytest.raises(RuntimeError, match="engine stopped"):
            eng.submit(next(iter(eng._known_ids)), "q")


def test_serve_mode_executor_and_id_coercion(latr, tmp_path):
    """mode='serve' reads no QA CSV and keeps the model on the meta device
    until first use; JSON-style string ids coerce to the store's keys."""
    _, t_ex, t_cfg, reqs = latr
    ex = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "serve", device="cpu")
    assert not hasattr(ex, "val_data")
    assert ex._abstract_params and next(ex.model.parameters()).is_meta
    ocr, obj = ex.serve_frames
    assert obj is None and set(ocr) == set(t_ex.serve_frames[0])
    with ServingEngine(ex, ocr, batch_size=2, max_wait_ms=1, max_answer_length=10) as eng:
        assert not ex._abstract_params  # the random init was drawn at warmup
        got = eng.answer(str(reqs[0][0]), reqs[0][1], timeout=TIMEOUT)
    # the same draws as an eager init from SEED: the rows equal a train-mode
    # executor's (the serve-mode tokenizer has encoded no answers, so rows)
    fresh = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "train", device="cpu")
    for name, p in fresh.model.named_parameters():
        torch.testing.assert_close(dict(ex.model.named_parameters())[name], p, rtol=0, atol=0)
    assert isinstance(got, str)


def test_cancelled_future_does_not_kill_worker(latr):
    _, t_ex, _, reqs = latr
    with ServingEngine(t_ex, *t_ex.serve_frames, batch_size=2, max_wait_ms=50,
                       max_answer_length=10, warmup=False) as eng:
        f = eng.submit(*reqs[0])
        f.cancel()  # may or may not win the race with the worker's claim
        assert isinstance(eng.answer(*reqs[0], timeout=TIMEOUT), str)


class _Stub:
    """An executor stand-in with ``_make_dataset`` and ``infer`` only."""

    def __init__(self, answer="ans", sleep=0.0):
        self.answer = answer
        self.sleep = sleep
        self.calls = []

    def _make_dataset(self, rows, ocr, obj=None):
        if rows[0]["question"] == "boom":
            raise RuntimeError("featurization exploded")
        return list(range(len(rows)))

    def infer(self, ds, bs, ml, return_scores=False):
        self.calls.append((len(ds), bs))
        time.sleep(self.sleep)
        return [self.answer] * len(ds)


def test_admission_edge_cases():
    """Int-store truncation is rejected (int(1.7) must not answer for image
    1); empty stores fail at construction; SaL admission intersects the OCR
    and object stores."""
    with ServingEngine(_Stub(), {1: None, 2: None}, batch_size=1, max_wait_ms=1,
                       warmup=False) as eng:
        with pytest.raises(KeyError):
            eng.submit(1.7, "q")
        assert eng.answer("2", "q", timeout=TIMEOUT) == "ans"  # lossless coercion
    with pytest.raises(ValueError, match="empty"):
        ServingEngine(_Stub(), {}, warmup=False)
    with ServingEngine(_Stub(), {1.0: None, 2.0: None}, {2.0: None, 3.0: None}, batch_size=1,
                       max_wait_ms=1, warmup=False) as eng:
        with pytest.raises(KeyError):
            eng.submit(1.0, "q")  # in the OCR store, not in the object store
        assert eng.answer(2.0, "q", timeout=TIMEOUT) == "ans"


def test_answer_cache():
    """Repeats resolve without a decode; a coerced id hits the same entry;
    the LRU evicts."""
    calls = []

    class _Counting(_Stub):
        def infer(self, ds, bs, ml, return_scores=False):
            calls.append(len(ds))
            return [f"ans{len(calls)}-{i}" for i in range(len(ds))]

    with ServingEngine(_Counting(), {1.0: None, 2.0: None, 3.0: None}, batch_size=1,
                       max_wait_ms=1, warmup=False, cache_size=2) as eng:
        a1 = eng.answer(1.0, "q", timeout=TIMEOUT)
        assert eng.answer(1.0, "q", timeout=TIMEOUT) == a1 and len(calls) == 1
        assert eng.stats()["cache_hits"] == 1
        assert eng.answer("1", "q", timeout=TIMEOUT) == a1 and len(calls) == 1
        eng.answer(2.0, "q", timeout=TIMEOUT)
        eng.answer(3.0, "q", timeout=TIMEOUT)
        n = len(calls)
        eng.answer(1.0, "q", timeout=TIMEOUT)
        assert len(calls) == n + 1  # evicted, decoded again


def test_stopped_engine_rejects_cached_requests():
    eng = ServingEngine(_Stub("a"), {1.0: None}, batch_size=1, max_wait_ms=1, warmup=False,
                        cache_size=4)
    assert eng.answer(1.0, "q", timeout=TIMEOUT) == "a"
    assert eng.answer(1.0, "q", timeout=TIMEOUT) == "a"  # now cached
    eng.stop()
    with pytest.raises(RuntimeError, match="engine stopped"):
        eng.submit(1.0, "q")


def test_access_log_records():
    """ok / cached / error / expired each leave one record with its latency;
    the question text is never logged; a raising sink is disabled."""
    records = []
    with ServingEngine(_Stub("xin chào", sleep=0.1), {1.0: None, 2.0: None}, batch_size=1,
                       max_wait_ms=1, warmup=False, cache_size=4,
                       access_log=records.append) as eng:
        assert eng.answer(1.0, "câu hỏi?", timeout=TIMEOUT) == "xin chào"
        eng.answer(1.0, "câu hỏi?", timeout=TIMEOUT)  # a cache hit
        with pytest.raises(RuntimeError):
            eng.answer(2.0, "boom", timeout=TIMEOUT)
        f1 = eng.submit(1.0, "slow")  # the worker is busy while f2 expires
        time.sleep(0.02)
        f2 = eng.submit(2.0, "q", deadline_s=0.01)
        assert f1.result(timeout=TIMEOUT) == "xin chào"
        with pytest.raises(TimeoutError):
            f2.result(timeout=TIMEOUT)
    by_status: dict = {}
    for r in records:
        by_status.setdefault(r["status"], r)
    assert set(by_status) == {"ok", "cached", "error", "expired"}
    ok = by_status["ok"]
    assert ok["image_id"] == 1.0 and isinstance(ok["image_id"], float)
    assert ok["question_chars"] == len("câu hỏi?") and "question" not in ok
    assert ok["bucket"] == 1 and ok["answer_chars"] == len("xin chào")
    assert ok["latency_ms"] >= 100
    assert by_status["cached"]["latency_ms"] < 100
    assert "featurization exploded" in by_status["error"]["error"]
    assert by_status["expired"]["adapter"] is None
    json.dumps(records)

    def boom(rec):
        raise ValueError("sink died")

    with ServingEngine(_Stub("xin chào"), {1.0: None}, batch_size=1, max_wait_ms=1,
                       warmup=False, access_log=boom) as eng:
        assert eng.answer(1.0, "q", timeout=TIMEOUT) == "xin chào"
        assert eng._access_log is None
        assert eng.answer(1.0, "q2", timeout=TIMEOUT) == "xin chào"


def test_stats_and_backpressure():
    with ServingEngine(_Stub(sleep=0.15), {1.0: None, 2.0: None}, batch_size=2,
                       max_wait_ms=1, warmup=False, max_queue=1) as eng:
        f1 = eng.submit(1.0, "q1")  # claimed; the worker sleeps 150 ms
        time.sleep(0.05)
        f2 = eng.submit(2.0, "q2")  # fills the one-slot queue
        with pytest.raises(RuntimeError, match="queue full"):
            eng.submit(1.0, "q3")
        assert f1.result(timeout=TIMEOUT) == "ans" and f2.result(timeout=TIMEOUT) == "ans"
    s = eng.stats()
    assert s["served"] == 2 and s["failed"] == 0 and s["batches"] == 2
    assert s["p50_ms"] is not None and s["p95_ms"] >= s["p50_ms"]


def test_max_queue_auto_derivation_and_starvation_warning(caplog):
    with ServingEngine(_Stub(), {1.0: None}, batch_size=16, warmup=False, max_queue=-1) as eng:
        assert eng.max_queue == 64 and eng._queue.maxsize == 64
    with ServingEngine(_Stub(), {1.0: None}, batch_size=16, warmup=False, max_queue=0) as eng:
        assert eng.max_queue == 0
    with caplog.at_level(logging.WARNING):
        with ServingEngine(_Stub(), {1.0: None}, batch_size=16, warmup=False,
                           max_queue=8) as eng:
            assert eng.max_queue == 8
    assert any("STARVES the batcher" in r.message for r in caplog.records)


def test_confidence_within_1e6_of_jax(latr):
    """confidence=True: {"answer", "confidence"} dicts; the scores under
    them are within 1e-6 of the JAX executor's, and a cached repeat returns
    the same dict."""
    j_ex, t_ex, _, reqs = latr
    j_ans, j_scores = j_ex.infer(j_ex.val_data, 4, 10, return_scores=True)
    t_ans, t_scores = t_ex.infer(t_ex.val_data, 4, 10, return_scores=True)
    assert t_ans == j_ans
    for t, j in zip(t_scores, j_scores):
        assert abs(math.exp(t) - math.exp(j)) < 1e-6
    with ServingEngine(t_ex, *t_ex.serve_frames, batch_size=4, max_wait_ms=20,
                       max_answer_length=10, confidence=True, cache_size=8) as eng:
        got = submit_all(eng, reqs)
        again = eng.answer(*reqs[0], timeout=TIMEOUT)
    assert [g["answer"] for g in got] == j_ans
    for g, s in zip(got, t_scores):
        assert g["confidence"] == round(math.exp(s), 4) and 0.0 < g["confidence"] <= 1.0
    assert again == got[0] and eng.stats()["cache_hits"] == 1


def test_deadline_expiry_and_prometheus_metrics():
    """A request that expires while queued is shed before featurization,
    counted, and exported; the Prometheus metric names equal the JAX
    engine's."""
    stub = _Stub(sleep=0.4)
    with ServingEngine(stub, {1.0: None, 2.0: None}, batch_size=1, max_wait_ms=1,
                       warmup=False) as eng:
        a = eng.submit(1.0, "first")
        b = eng.submit(2.0, "doomed", deadline_s=0.05)
        c = eng.submit(1.0, "patient")
        assert a.result(timeout=TIMEOUT) == "ans"
        with pytest.raises(TimeoutError, match="deadline"):
            b.result(timeout=TIMEOUT)
        assert c.result(timeout=TIMEOUT) == "ans"
    s = eng.stats()
    assert s["expired"] == 1 and s["served"] == 2
    assert [n for n, _ in stub.calls] == [1, 1]  # b never reached featurization
    text = eng.prometheus_metrics()
    assert "phonovqa_expired_total 1" in text and "phonovqa_served_total 2" in text
    assert 'phonovqa_request_latency_ms{quantile="0.5"}' in text
    assert "# TYPE phonovqa_queue_depth gauge" in text

    class _JStub:
        def _make_dataset(self, qa, ocr, obj=None):
            return list(range(len(qa)))

        def infer(self, ds, bs, ml, return_scores=False):
            return ["ans"] * len(ds)

    with JServingEngine(_JStub(), pd.DataFrame({"image_id": [1.0]}), batch_size=1,
                        max_wait_ms=1, warmup=False) as jeng:
        jeng.answer(1.0, "q", timeout=TIMEOUT)
    with ServingEngine(_Stub(), {1.0: None}, batch_size=1, max_wait_ms=1,
                       warmup=False) as eng:
        eng.answer(1.0, "q", timeout=TIMEOUT)

    def names(text):
        return sorted(line.split(" ")[0] for line in text.splitlines())

    assert names(eng.prometheus_metrics()) == names(jeng.prometheus_metrics())


def test_shed_before_batch_viability():
    """A queued request whose remaining deadline is under the service-time
    EWMA is shed ("cannot be met"); deadline-free traffic is unaffected and
    re-learns the estimate."""
    stub = _Stub(sleep=0.05)
    with ServingEngine(stub, {1.0: None, 2.0: None}, batch_size=1, max_wait_ms=1,
                       warmup=False) as eng:
        assert eng.answer(1.0, "seed", timeout=TIMEOUT) == "ans"
        assert eng.stats()["service_ewma_s"] > 0
        eng._service_ewma = 3600.0  # no finite deadline is viable
        doomed = eng.submit(2.0, "doomed", deadline_s=30.0)
        with pytest.raises(TimeoutError, match="cannot be met"):
            doomed.result(timeout=TIMEOUT)
        assert eng.answer(1.0, "free", timeout=TIMEOUT) == "ans"
        s = eng.stats()
        assert s["expired"] == 1 and s["served"] == 2
        assert [n for n, _ in stub.calls] == [1, 1]
        assert eng._service_ewma < 3600.0


def test_default_deadline_applies():
    with ServingEngine(_Stub("ok"), {1.0: None}, batch_size=1, max_wait_ms=1, warmup=False,
                       default_deadline_s=30) as eng:
        assert eng.submit(1.0, "q").result(timeout=TIMEOUT) == "ok"
        assert eng.stats()["expired"] == 0


def test_hot_reload_stub_and_watcher(tmp_path):
    """reload() swaps weights between batches (new answers, the cache
    cleared, counted); the CLI's watcher reloads once per changed mtime."""

    class _Reloading(_Stub):
        version = 1

        def infer(self, ds, bs, ml, return_scores=False):
            return [f"v{self.version}-{i}" for i in range(len(ds))]

        def _load_trained_checkpoint(self, loadtype):
            assert loadtype in ("best", "last")
            self.version += 1

    with ServingEngine(_Reloading(), {1.0: None}, batch_size=1, max_wait_ms=1, warmup=False,
                       cache_size=8) as eng:
        assert eng.answer(1.0, "q", timeout=TIMEOUT) == "v1-0"
        assert eng.answer(1.0, "q", timeout=TIMEOUT) == "v1-0"  # cached
        info = eng.reload("best")
        assert info["reloaded"] == "best" and info["ms"] >= 0
        assert eng.answer(1.0, "q", timeout=TIMEOUT) == "v2-0"
        assert eng.stats()["reloads"] == 1
    with pytest.raises(RuntimeError, match="engine stopped"):
        eng.reload("best")

    class _Ckpt:
        mtime_value = 100.0

        def mtime(self, name):
            return self.mtime_value

    stub = _Reloading()
    stub.ckpt = _Ckpt()
    with ServingEngine(stub, {1.0: None}, batch_size=1, max_wait_ms=1, warmup=False) as eng:
        t_serve.start_reload_watcher(eng, "best", every_s=0.05)
        time.sleep(0.2)
        assert eng.stats()["reloads"] == 0
        stub.ckpt.mtime_value = 200.0
        deadline = time.monotonic() + 5
        while eng.stats()["reloads"] < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.2)
        assert eng.stats()["reloads"] == 1


def test_reload_swaps_real_weights(latr, tmp_path):
    """Serve checkpoint A, overwrite it with other weights, reload: the
    answers equal a fresh engine's on the new weights, and every parameter
    kept its storage (the graphs read it there)."""
    _, t_ex, t_cfg, reqs = latr
    cfg = t_config.Config({**t_cfg, "SAVE_PATH": str(tmp_path)})
    trainer = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")
    trainer.load_params({n: p.detach().clone() for n, p in t_ex.state.params.items()})
    trainer._save_checkpoint("best")
    served = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "eval", device="cpu")
    served._load_trained_checkpoint("best")
    addresses = t_graphs.param_addresses(served.model)
    with ServingEngine(served, *served.serve_frames, batch_size=4, max_wait_ms=20,
                       max_answer_length=10, cache_size=8) as eng:
        before = submit_all(eng, reqs)
        g = torch.Generator().manual_seed(99)
        trainer.load_params({n: torch.randn(p.shape, generator=g) * 0.5
                             for n, p in trainer.state.params.items()})
        trainer._save_checkpoint("best")
        eng.reload("best")
        after = submit_all(eng, reqs)
    assert t_graphs.param_addresses(served.model) == addresses
    fresh = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "eval", device="cpu")
    fresh._load_trained_checkpoint("best")
    with ServingEngine(fresh, *fresh.serve_frames, batch_size=4, max_wait_ms=20,
                       max_answer_length=10) as eng:
        assert after == submit_all(eng, reqs)
    assert after != before


def test_unported_knobs_raise(latr, tmp_path):
    """A mesh of more than one device is ROADMAP A15 and raises, naming it.
    LoRA adapters and the ViT encoding cache, which raised here before, now
    work: the engine takes adapters (checked against the base), a serve-mode
    executor takes ``VIT_CACHE`` and the engine builds its encoding table,
    and ``serve --adapter`` loads a LoRA run's adapters (held in full in
    tests/test_torch_lora.py and tests/test_torch_vit_cache.py)."""
    _, t_ex, t_cfg, reqs = latr
    cfg = t_config.Config({**t_cfg, "MESH": {"data": 2}})
    with pytest.raises(NotImplementedError, match="A15"):
        T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "serve", device="cpu")
    name = "t5.encoder.block_0.attn.q.weight"
    d_out, d_in = t_ex.model.get_parameter(name).shape
    adapter = {"lora": {name: {"a": torch.zeros(d_in, 2), "b": torch.zeros(2, d_out)}},
               "scale": 1.0}  # b = 0: the merged weights are the base
    with ServingEngine(t_ex, *t_ex.serve_frames, batch_size=4, max_wait_ms=20,
                       max_answer_length=10, adapters={"zero": adapter}) as eng:
        assert submit_all(eng, reqs) == [eng.submit(i, q, adapter="zero").result(timeout=TIMEOUT)
                                         for i, q in reqs]
    answers = {}
    for cache in (False, True):  # serve mode: the tokenizer has seen these questions only
        cfg = t_config.Config({**t_cfg, "VIT_CACHE": cache})
        served = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "serve", device="cpu")
        served.load_params({n: p.detach().clone() for n, p in t_ex.state.params.items()})
        with ServingEngine(served, *served.serve_frames, batch_size=4, max_wait_ms=20,
                           max_answer_length=10) as eng:
            assert (eng._enc_cache is not None) == cache
            answers[cache] = submit_all(eng, reqs)
    assert answers[True] == answers[False]
    trainer = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_config.Config(
        {**t_cfg, "SAVE_PATH": str(tmp_path), "LORA_RANK": 2}), "train", device="cpu")
    trainer._save_checkpoint("best")
    loaded = t_serve.load_adapter(str(tmp_path), "cpu")
    assert set(loaded["lora"]) == set(trainer.state.lora) and loaded["scale"] == 2.0


@pytest.mark.parametrize("family", ["latr", "phoneme_latr"])
def test_graph_decoder_chunks_equal_the_generate(family, tmp_path):
    """The graph decoder's chunked loop (run eagerly on the CPU) gives the
    greedy generate's rows and scores exactly, per bucket, over reloaded
    buffers."""
    _, t_ex, _, _ = family_pair(family, tmp_path, mode="eval")
    model = t_ex.model.eval()
    for bucket in (1, 4):
        batch, _ = next(batch_iterator(t_ex.val_data, bucket, pad_final=True))
        tb = t_ex._device_batch(batch)
        decoder = GraphDecoder(model, tb, 10, with_scores=True)
        assert decoder.graphs is None and len(decoder.chunks) == 3
        want = build_generate_fn(model, 10, with_scores=True)(tb)
        for _ in range(2):
            got = decoder.start(tb)()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
