"""The port's decode variants against the JAX package's on scripted steps,
on the CPU in f32: beam search (single-stream and over triples, with
scores, ``bos_triple``, finished beams, a scored mid-sequence pad, a head
narrower than the beam), ``filter_logits`` bit for bit, ``sample_decode``'s
degenerate modes, support, seed determinism and variation, and the
prompt-lookup drafts.

A scripted step reads its logits from a seeded table at (step, token) plus
a multiple of the tokens it has written into its cache, so a beam that
reorders its cache wrongly decodes other tokens. Both sides read the same
numpy tables; the port's step writes its cache in place, as the models'
steps do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoneme_vqa_torch import decode as t_decode
from phoneme_vqa_torch.decode import beam as t_beam
from phoneme_vqa_torch.decode import sample as t_sample
from phoneme_vqa_tpu.decode import beam as j_beam
from phoneme_vqa_tpu.decode import sample as j_sample
from phoneme_vqa_tpu.decode import speculative as j_spec

B, T, PAD, EOS, BOS = 3, 9, 0, 1, 2
V = 9
VOCABS = (9, 11, 5)  # onset, rhyme, tone
HIST = 0.25  # a power of two: the history term is exact in f32


def _tables(seed, vocabs=(V,)):
    rng = np.random.RandomState(seed)
    tables = [(rng.randn(T, VOCABS[0] if len(vocabs) > 1 else V, v) * 2).astype(np.float32)
              for v in vocabs]
    for t in tables:
        t[:, :, EOS] += 0.8  # answers end within the buffer now and then
    return tables


def _cache(rows, np_mod):
    """A stacked cache the scripted step writes its tokens into (axis 1 the
    rows), and a static cross part."""
    return {"k": np_mod.zeros((1, rows, 1, T, 1), dtype=np_mod.float32),
            "v": np_mod.zeros((1, rows, 1, T, 1), dtype=np_mod.float32),
            "ck": np_mod.ones((1, rows, 1, 3, 1), dtype=np_mod.float32),
            "cv": np_mod.ones((1, rows, 1, 3, 1), dtype=np_mod.float32)}


def _jax_step(tables, heads: bool):
    tabs = [jnp.asarray(t) for t in tables]

    def step(tokens, cache, i):
        first = tokens[:, 0] if heads else tokens
        hist = HIST * cache["k"][0, :, 0, :, 0].sum(-1)
        logits = tuple(jnp.take(t, i, axis=0)[first] + hist[:, None] for t in tabs)
        cache = dict(cache, k=cache["k"].at[0, :, 0, i, 0].set(first.astype(jnp.float32)))
        return (logits if heads else logits[0]), cache

    return step


def _port_step(tables, heads: bool):
    tabs = [torch.from_numpy(t) for t in tables]

    def step(tokens, cache, i):
        first = tokens[:, 0] if heads else tokens
        hist = HIST * cache["k"][0, :, 0, :, 0].sum(-1)
        logits = tuple(t[i][first] + hist[:, None] for t in tabs)
        cache["k"][0, :, 0, i, 0] = first.float()  # in place, as the models write
        return (logits if heads else logits[0]), cache

    return step


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_decode_matches_jax(k, seed):
    tables = _tables(seed)
    want, want_s = j_beam.beam_decode(_jax_step(tables, False), _cache(B * k, jnp), B, k, T, BOS,
                                      EOS, PAD, with_scores=True)
    got, got_s = t_beam.beam_decode(_port_step(tables, False), _cache(B * k, torch), B, k, T,
                                    BOS, EOS, PAD, "cpu", with_scores=True)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_allclose(got_s.numpy(), _np(want_s), rtol=1e-6, atol=1e-6)
    plain = t_beam.beam_decode(_port_step(tables, False), _cache(B * k, torch), B, k, T, BOS,
                               EOS, PAD, "cpu")
    torch.testing.assert_close(plain, got, atol=0, rtol=0)
    for row in got.tolist():  # a finished beam emits only pad after its EOS
        if EOS in row:
            assert set(row[row.index(EOS) + 1:]) <= {PAD}


def test_beam_of_one_is_greedy():
    tables = _tables(3)
    want, want_s = t_decode.greedy_decode(_port_step(tables, False), _cache(B, torch), B, T,
                                          BOS, EOS, PAD, "cpu", with_scores=True)
    got, got_s = t_beam.beam_decode(_port_step(tables, False), _cache(B, torch), B, 1, T, BOS,
                                    EOS, PAD, "cpu", with_scores=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(got_s, want_s, atol=1e-6, rtol=1e-6)


def test_beam_counts_a_scored_mid_sequence_pad():
    """A pad emitted before EOS was scored, so it counts in the mean, as in
    the JAX package's test of the same case."""
    t = np.full((T, V, V), -5.0, np.float32)
    t[0, :, PAD] = 5.0  # step 0 emits pad (not finished)
    t[1, :, EOS] = 5.0  # step 1 ends the row
    args = (1, 2, T, BOS, EOS, PAD)
    want, want_s = j_beam.beam_decode(_jax_step([t], False), _cache(2, jnp), *args,
                                      with_scores=True)
    got, got_s = t_beam.beam_decode(_port_step([t], False), _cache(2, torch), *args, "cpu",
                                    with_scores=True)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert got[0, 1:3].tolist() == [PAD, EOS]
    np.testing.assert_allclose(got_s.numpy(), _np(want_s), rtol=1e-6)
    row = t[0, 0].astype(np.float64)
    lp = lambda r, tok: r[tok] - np.log(np.exp(r - r.max()).sum()) - r.max()
    # two scored emissions, the pad included (f32 log-softmax: atol)
    np.testing.assert_allclose(float(got_s[0]), (lp(row, PAD) + lp(t[1, 0].astype(np.float64),
                                                                     EOS)) / 2, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("bos_triple", [None, (BOS, 0, 0)])
def test_multi_head_beam_decode_matches_jax(k, bos_triple):
    tables = _tables(10 + k, VOCABS)
    want, want_s = j_beam.multi_head_beam_decode(
        _jax_step(tables, True), _cache(B * k, jnp), B, k, T, BOS, EOS, PAD, with_scores=True,
        bos_triple=bos_triple)
    got, got_s = t_beam.multi_head_beam_decode(
        _port_step(tables, True), _cache(B * k, torch), B, k, T, BOS, EOS, PAD, "cpu",
        with_scores=True, bos_triple=bos_triple)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_allclose(got_s.numpy(), _np(want_s), rtol=1e-6, atol=1e-6)
    if k == 1:
        greedy, greedy_s = t_decode.multi_head_greedy_decode(
            _port_step(tables, True), _cache(B, torch), B, T, 3, BOS, EOS, PAD, "cpu",
            with_scores=True)
        if bos_triple is None:
            torch.testing.assert_close(got, greedy, atol=0, rtol=0)
            torch.testing.assert_close(got_s, greedy_s, atol=1e-6, rtol=1e-6)


def test_a_head_narrower_than_the_beam_raises():
    tables = _tables(4, VOCABS)
    with pytest.raises(ValueError, match="head 2 .tone."):
        t_beam.multi_head_beam_decode(_port_step(tables, True), _cache(B * 6, torch), B, 6, T,
                                      BOS, EOS, PAD, "cpu")


def test_the_beam_reorder_builds_new_tensors_and_never_moves_cross_kv():
    cache = _cache(4, torch)
    cache["k"][0, :, 0, 0, 0] = torch.arange(4.0)
    dynamic, static = t_beam.split_static(cache)
    assert set(static) == {"ck", "cv"} and set(dynamic) == {"k", "v"}
    got = t_beam.gather_beams(dynamic, torch.tensor([[1, 1], [0, 1]]), 2, 2)
    assert got["k"][0, :, 0, 0, 0].tolist() == [1.0, 1.0, 2.0, 3.0]
    assert got["k"].data_ptr() != cache["k"].data_ptr()
    expanded = t_beam.expand_to_beams({"k": torch.arange(6.0).view(1, 2, 1, 3, 1),
                                       "m": torch.tensor([[1, 0], [1, 1]])}, 3)
    assert expanded["k"].shape == (1, 6, 1, 3, 1) and expanded["m"].tolist() == \
        [[1, 0]] * 3 + [[1, 1]] * 3


# -- sampling ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 0, 1.0), (1.3, 5, 1.0), (1.0, 1, 1.0), (1.0, 0, 0.9),
    (0.8, 7, 0.6), (1.0, 0, 0.01), (2.0, 40, 0.95)])
def test_filter_logits_equals_jax_bit_for_bit(temperature, top_k, top_p):
    rng = np.random.RandomState(top_k + int(100 * top_p))
    logits = (rng.randn(6, 37) * 3).astype(np.float32)
    logits[0, :8] = logits[0, 8]  # ties
    logits[1] = np.round(logits[1])
    want = _np(j_sample.filter_logits(jnp.asarray(logits), temperature, top_k, top_p))
    got = t_sample.filter_logits(torch.from_numpy(logits), temperature, top_k, top_p)
    np.testing.assert_array_equal(got.numpy(), want)


def _sample(tables, **kw):
    return t_sample.sample_decode(_port_step(tables, False), _cache(B, torch), B, T, BOS, EOS,
                                  PAD, "cpu", **kw)


@pytest.mark.parametrize("mode", [dict(temperature=0.0), dict(top_k=1),
                                  dict(temperature=0.0, top_k=5, top_p=0.5)])
def test_degenerate_sampling_is_greedy_and_equals_jax(mode):
    tables = _tables(5)
    greedy, greedy_s = t_decode.greedy_decode(_port_step(tables, False), _cache(B, torch), B, T,
                                              BOS, EOS, PAD, "cpu", with_scores=True)
    got, got_s = _sample(tables, with_scores=True, **mode)
    torch.testing.assert_close(got, greedy, atol=0, rtol=0)
    torch.testing.assert_close(got_s, greedy_s, atol=0, rtol=0)
    want = j_sample.sample_decode(_jax_step(tables, False), _cache(B, jnp), B, T, BOS, EOS, PAD,
                                  **mode)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_sampling_is_seeded_varies_between_calls_and_keeps_the_support():
    tables = _tables(6)
    for t in tables:
        t[:, :, EOS] = -30.0  # no early stop: every step is drawn
    kw = dict(temperature=1.5, top_k=3)
    gen = lambda call: t_sample.sample_generator(13, call, "cpu")
    first = _sample(tables, generator=gen(0), **kw)
    torch.testing.assert_close(_sample(tables, generator=gen(0), **kw), first, atol=0, rtol=0)
    assert not torch.equal(_sample(tables, generator=gen(1), **kw), first)
    torch.testing.assert_close(_sample(tables, seed=13, **kw), _sample(tables, seed=13, **kw),
                               atol=0, rtol=0)
    # every drawn token lies among the 3 highest logits of its step
    seen = []
    step = _port_step(tables, False)

    def recording(tokens, cache, i):
        logits, cache = step(tokens, cache, i)
        seen.append(logits.clone())
        return logits, cache

    for call in range(4):
        seen.clear()
        out = t_sample.sample_decode(recording, _cache(B, torch), B, T, BOS, EOS, PAD, "cpu",
                                     generator=gen(call), **kw)
        for i, logits in enumerate(seen):
            top3 = logits.topk(3, dim=-1).indices
            assert (top3 == out[:, i + 1, None]).any(-1).all(), (call, i)


def test_sampled_scores_are_the_raw_distributions():
    tables = _tables(8)
    seen = []
    step = _port_step(tables, False)

    def recording(tokens, cache, i):
        logits, cache = step(tokens, cache, i)
        seen.append(logits.clone())
        return logits, cache

    out, scores = t_sample.sample_decode(recording, _cache(B, torch), B, T, BOS, EOS, PAD, "cpu",
                                         temperature=1.7, top_k=5, with_scores=True)
    for r in range(B):
        lps = []
        for i, logits in enumerate(seen):
            tok = int(out[r, i + 1])
            lps.append(float(torch.log_softmax(logits[r].double(), -1)[tok]))
            if tok == EOS:
                break
        np.testing.assert_allclose(float(scores[r]), np.mean(lps), rtol=1e-5)


# -- prompt-lookup drafts ------------------------------------------------------------------


def test_draft_from_pair_equals_jax():
    rng = np.random.RandomState(0)
    src = rng.randint(0, 6, (8, 15)).astype(np.int32)
    valid = np.ones_like(src, bool)
    valid[2, 9:] = False
    valid[5, :] = False
    cur = rng.randint(0, 6, 8).astype(np.int32)
    prev = rng.randint(0, 6, 8).astype(np.int32)
    have_prev = np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)
    src[3, -1] = cur[3]  # a match at the last position: no continuation
    for num_draft in (1, 3, 5):
        want = j_spec.draft_from_pair(*map(jnp.asarray, (src, valid, cur, prev, have_prev)),
                                      num_draft, PAD)
        got = t_decode.draft_from_pair(*map(torch.from_numpy, (src.astype(np.int64), valid,
                                                               cur.astype(np.int64),
                                                               prev.astype(np.int64),
                                                               have_prev)), num_draft, PAD)
        np.testing.assert_array_equal(got.numpy(), _np(want))


def test_prompt_lookup_draft_equals_jax_and_prefers_the_bigram():
    src = np.array([[5, 7, 8, 3, 7, 9, 4, 4], [6, 6, 6, 2, 3, 4, 5, 7]], np.int64)
    mask = np.ones_like(src)
    mask[1, 6:] = 0
    out = np.array([[BOS, 3, 7, 0, 0], [BOS, 6, 2, 3, 0]], np.int64)
    pos = np.array([2, 3], np.int64)
    want = j_spec.make_prompt_lookup_draft(jnp.asarray(src), 3, PAD, jnp.asarray(mask))(
        jnp.asarray(out), jnp.asarray(pos))
    got = t_decode.make_prompt_lookup_draft(torch.from_numpy(src), 3, PAD,
                                            torch.from_numpy(mask))(torch.from_numpy(out),
                                                                     torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    # (3, 7) occurs at 3..4, so the drafts follow it (9, 4, 4), not the
    # first 7 (8, 3, 7); the second row's continuation stops at the mask
    assert got.tolist() == [[9, 4, 4], [4, PAD, PAD]]
