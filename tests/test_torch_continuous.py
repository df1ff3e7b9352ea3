"""The port's slot-refill ``ContinuousEngine`` against ``executor.infer`` and
the JAX package's ``ContinuousEngine``, on the CPU in f32 at tiny widths
(the executors from one YAML, the weights carried across by
``models/bridge.py``): answers per family, a mid-stream join, deadline
shedding, per-slot speculative decoding (identical and counted; refused
for a custom vocabulary), backpressure over the drained waiting list, the
missing-``step_k`` guard, reload, confidence and the cache, and the triple
stream's confidence pinned against JAX's ``multi_head_greedy_decode``
scores.
"""

import math
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoneme_vqa_torch import config as t_config
from phoneme_vqa_torch.decode.pool import CACHE_KEYS, pool_greedy_decode
from phoneme_vqa_torch.serving import ContinuousEngine
from phoneme_vqa_torch.utils.registry import EXECUTORS as T_EXECUTORS
from phoneme_vqa_tpu.decode.greedy import multi_head_greedy_decode as j_multi_head_greedy
from phoneme_vqa_tpu.serving import ContinuousEngine as JContinuousEngine

from .test_torch_serving_engine import TIMEOUT, family_pair, submit_all

CONT = dict(num_slots=3, prefill_chunk=2, horizon=4, max_answer_length=10)
FAMILIES = ("latr", "sal", "customized_sal_bpe", "phoneme_latr", "phoneme_sal")


@pytest.fixture(scope="module")
def latr(tmp_path_factory):
    return family_pair("latr", tmp_path_factory.mktemp("cont_latr"))


@pytest.mark.parametrize("family", FAMILIES)
def test_answers_equal_infer_and_the_jax_engine(family, tmp_path):
    j_ex, t_ex, _, reqs = family_pair(family, tmp_path)
    want = t_ex.infer(t_ex.val_data, 4, 10)
    with JContinuousEngine(j_ex, *j_ex.serve_frames, **CONT) as eng:
        j_got = submit_all(eng, reqs)
    with ContinuousEngine(t_ex, *t_ex.serve_frames, **CONT) as eng:
        got = submit_all(eng, reqs)
        got2 = submit_all(eng, reqs)  # again with warm slots: the refill path
        s = eng.stats()
    assert got == want == j_got and got2 == want
    assert s["served"] == 2 * len(reqs) and s["failed"] == 0
    assert s["decode_dispatches"] >= 2 and s["p95_ms"] is not None


def test_mid_stream_join(latr):
    """Requests submitted while earlier ones decode join at a dispatch
    boundary and answer identically."""
    _, t_ex, _, reqs = latr
    want = t_ex.infer(t_ex.val_data, 4, 10)
    with ContinuousEngine(t_ex, *t_ex.serve_frames, num_slots=4, prefill_chunk=2, horizon=2,
                          max_answer_length=10) as eng:
        futs = [eng.submit(*r) for r in reqs[:2]]
        time.sleep(0.05)  # let the decode start
        futs += [eng.submit(*r) for r in reqs[2:]]
        got = [f.result(timeout=TIMEOUT) for f in futs]
        assert eng.stats()["decode_dispatches"] >= 2
    assert got == want


def test_deadline_shedding_and_unknown_id(latr):
    _, t_ex, _, reqs = latr
    with ContinuousEngine(t_ex, *t_ex.serve_frames, num_slots=2, prefill_chunk=2, horizon=4,
                          max_answer_length=10) as eng:
        f = eng.submit(*reqs[0], deadline_s=-1.0)
        with pytest.raises(TimeoutError):
            f.result(timeout=TIMEOUT)
        assert eng.stats()["expired"] == 1
        with pytest.raises(KeyError, match="unknown image_id"):
            eng.submit(99999.0, "q")
        with pytest.raises(KeyError, match="unknown adapter"):
            eng.submit(*reqs[0], adapter="x")
        assert isinstance(eng.submit(*reqs[0], adapter=None).result(timeout=TIMEOUT), str)
        assert isinstance(eng.answer(*reqs[0], timeout=TIMEOUT), str)


def test_shed_before_slot_viability(latr):
    _, t_ex, _, reqs = latr
    with ContinuousEngine(t_ex, *t_ex.serve_frames, num_slots=2, prefill_chunk=2, horizon=4,
                          max_answer_length=10) as eng:
        assert isinstance(eng.answer(*reqs[0], timeout=TIMEOUT), str)
        assert eng.stats()["service_ewma_s"] > 0
        eng._service_ewma = 3600.0  # no finite deadline is viable
        f = eng.submit(*reqs[1], deadline_s=30.0)
        with pytest.raises(TimeoutError, match="cannot be met"):
            f.result(timeout=TIMEOUT)
        assert eng.stats()["expired"] == 1
        assert isinstance(eng.answer(*reqs[1], timeout=TIMEOUT), str)
        assert eng.stats()["served"] == 2 and eng._service_ewma < 3600.0


def test_speculative_slots_identical_and_counted(latr):
    """spec_k > 1: answers and confidences equal ``infer``'s; the accept
    rate is counted."""
    _, t_ex, _, reqs = latr
    want, want_scores = t_ex.infer(t_ex.val_data, 4, 10, return_scores=True)
    with ContinuousEngine(t_ex, *t_ex.serve_frames, **CONT, confidence=True,
                          spec_k=3) as eng:
        assert eng.spec_k == 3
        got = submit_all(eng, reqs)
        got2 = submit_all(eng, reqs)
        s = eng.stats()
    assert [g["answer"] for g in got] == want and got2 == got
    for g, sc in zip(got, want_scores):
        assert abs(g["confidence"] - math.exp(sc)) < 1e-3
    assert s["spec_k"] == 3 and s["spec_tokens_per_step"] >= 0.1


def test_speculative_refused_for_custom_vocab(tmp_path):
    _, t_ex, _, reqs = family_pair("customized_sal_bpe", tmp_path)
    want = t_ex.infer(t_ex.val_data, 4, 10)
    with ContinuousEngine(t_ex, *t_ex.serve_frames, **CONT, spec_k=4) as eng:
        assert eng.spec_k == 0  # refused: the drafts' vocabulary is not the answers'
        got = submit_all(eng, reqs)
    assert got == want


def test_backpressure_counts_drained_waiting_list(latr):
    """max_queue bounds queued + drained-but-unslotted requests together."""
    _, t_ex, _, reqs = latr

    class _DrainOnly(ContinuousEngine):
        def _run(self):
            while self._drain_queue(block=True):
                time.sleep(0.001)
            for r in self._waiting:
                r.future.set_exception(RuntimeError("drain-only worker stopped"))

    bound = 5
    with _DrainOnly(t_ex, *t_ex.serve_frames, num_slots=2, prefill_chunk=2, horizon=4,
                    max_answer_length=10, warmup=False, max_queue=bound) as eng:
        futs = [eng.submit(reqs[i % len(reqs)][0], f"q{i}") for i in range(bound)]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and len(eng._waiting) < bound:
            time.sleep(0.01)
        assert len(eng._waiting) == bound and eng._queue.qsize() == 0
        with pytest.raises(RuntimeError, match="queue full"):
            eng.submit(reqs[0][0], "one too many")
    for f in futs:
        with pytest.raises(RuntimeError, match="drain-only"):
            f.result(timeout=10)


def test_missing_step_k_fails_fast(latr):
    _, t_ex, _, _ = latr

    class _NoStepK:
        pass

    class _FakeEx:
        model = _NoStepK()

    with pytest.raises(ValueError, match="decode_step_k"):
        ContinuousEngine(_FakeEx(), t_ex.serve_frames[0], num_slots=2, warmup=False)


def test_reload_swaps_real_weights(latr, tmp_path):
    """Serve checkpoint A, overwrite it, reload while requests are in
    flight: each resolves, and afterwards the answers are ``infer``'s on
    the new weights."""
    _, t_ex, t_cfg, reqs = latr
    cfg = t_config.Config({**t_cfg, "SAVE_PATH": str(tmp_path)})
    trainer = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")
    trainer.load_params({n: p.detach().clone() for n, p in t_ex.state.params.items()})
    trainer._save_checkpoint("best")
    served = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "eval", device="cpu")
    served._load_trained_checkpoint("best")
    with ContinuousEngine(served, *served.serve_frames, num_slots=4, prefill_chunk=2,
                          horizon=4, max_answer_length=10, cache_size=8) as eng:
        before = submit_all(eng, reqs[:4])
        g = torch.Generator().manual_seed(99)
        trainer.load_params({n: torch.randn(p.shape, generator=g) * 0.5
                             for n, p in trainer.state.params.items()})
        trainer._save_checkpoint("best")
        inflight = [eng.submit(*r) for r in reqs[:4]]
        eng.reload("best")
        for f in inflight:  # each under exactly one set of weights
            assert isinstance(f.result(timeout=TIMEOUT), str)
        after = submit_all(eng, reqs[:4])
        assert eng.stats()["reloads"] == 1
    assert after == served.infer(served.val_data, 4, 10)[:4]
    assert before  # served under A without interruption


def test_confidence_and_cache(latr):
    _, t_ex, _, reqs = latr
    want_ans, want_scores = t_ex.infer(t_ex.val_data, 4, 10, return_scores=True)
    with ContinuousEngine(t_ex, *t_ex.serve_frames, num_slots=4, prefill_chunk=2, horizon=4,
                          max_answer_length=10, confidence=True, cache_size=8) as eng:
        got = submit_all(eng, reqs[:4])
        again = eng.answer(*reqs[0], timeout=TIMEOUT)
        assert eng.stats()["cache_hits"] == 1
    assert [g["answer"] for g in got] == want_ans[:4]
    for g, s in zip(got, want_scores):
        assert 0.0 < g["confidence"] <= 1.0
        assert abs(g["confidence"] - math.exp(s)) < 1e-3
    assert again == got[0]
    assert "phonovqa_decode_dispatches_total" in eng.prometheus_metrics()


def test_triple_stream_confidence_matches_jax_multi_head_scores(tmp_path):
    """The triple stream's confidence (a step's log-probability summed over
    onset, rhyme and tone, the mean over steps x 3) pinned against JAX's
    ``multi_head_greedy_decode``: the pool decode's ``with_scores`` on a
    scripted step (rows end at their onset's EOS at different steps, one
    never), and the continuous engine's confidence for PhonemeLaTr against
    the JAX executor's scores."""
    n, t, vocabs, eos = 6, 10, (7, 9, 5), 1
    g = np.random.RandomState(0)
    script = [g.randn(n, t, v).astype(np.float32) for v in vocabs]
    for row, step in ((0, 2), (2, 0), (3, 5), (4, 8)):  # row 1 and 5 never end
        script[0][row, step, eos] = 50.0

    def j_step(tokens, cache, i):
        return tuple(jnp.asarray(sc)[:, i] + tokens[:, c:c + 1] * 0.01
                     for c, sc in enumerate(script)), cache

    want_rows, want_scores = j_multi_head_greedy(j_step, (), n, t, 3, 0, eos, 2,
                                                 with_scores=True)
    # the pool's "cache" carries each slot's row id, so a step reads its script
    rows_id = torch.arange(n, dtype=torch.float32)[None, :, None]
    pool = {name: rows_id.clone() for name in CACHE_KEYS}

    def t_step(tokens, cache, pos, enc_mask):
        row = cache["ck"][0, :, 0].long()
        return tuple(torch.from_numpy(sc)[row, pos][:, None] + tokens[:, :, c:c + 1] * 0.01
                     for c, sc in enumerate(script)), cache

    rows, scores = pool_greedy_decode(t_step, pool, torch.ones(n, 1), 3, t, 0, eos, 2,
                                      num_components=3, with_scores=True)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-6, atol=1e-6)

    j_ex, t_ex, _, reqs = family_pair("phoneme_latr", tmp_path)
    j_ans, j_scores = j_ex.infer(j_ex.val_data, 4, 10, return_scores=True)
    with ContinuousEngine(t_ex, *t_ex.serve_frames, **CONT, confidence=True) as eng:
        got = submit_all(eng, reqs)
    assert [x["answer"] for x in got] == j_ans
    for x, sc in zip(got, j_scores):  # the engine rounds to 4 decimals
        assert abs(x["confidence"] - math.exp(sc)) <= 5e-5 + 1e-6
