"""The port's K-token decode step (``decode_step_k``) and the decodes built
on it against the JAX package's, on the CPU in f32 at tiny widths:

* ``decode_step_k`` of the T5 decoder, the custom decoder and the phoneme
  triple decoder against flax's on the same cache at per-row positions,
  one row's window running past the buffer's end: every logit, and the
  cache the step writes (each slot but T-1, where the JAX package sums the
  overrunning K/V and the port drops them; no query reads that slot);
* one K-token window equals K one-token steps;
* ``speculative_greedy_decode`` with wrong, oracle, ragged and prompt-lookup
  drafts gives greedy's rows, and the JAX function's; oracle drafts take
  one trip a window;
* ``pool_greedy_decode`` gives batch greedy's rows and scores, and the JAX
  function's, with fewer slots than rows.

Flax initializes the weights; ``phoneme_vqa_torch.models.bridge`` copies
them into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoneme_vqa_torch import decode as t_decode
from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.models import custom_decoder as t_cd
from phoneme_vqa_torch.models import phoneme as t_phoneme
from phoneme_vqa_torch.models import t5 as t_t5
from phoneme_vqa_tpu.decode import pool as j_pool
from phoneme_vqa_tpu.decode import speculative as j_spec
from phoneme_vqa_tpu.models import custom_decoder as j_cd
from phoneme_vqa_tpu.models import phoneme as j_phoneme
from phoneme_vqa_tpu.models import t5 as j_t5

ATOL = RTOL = 1e-4  # f32 on both sides, sums in another order
B, LE, D, H, T, K = 3, 11, 32, 4, 10, 4
POS = np.array([0, 3, 8])  # row 2's window (8..11) runs past T = 10
T5_CFG = dict(vocab_size=37, d_model=D, d_kv=8, num_heads=H, d_ff=64, num_layers=2,
              num_decoder_layers=2, dropout_rate=0.0)
CD_CFG = dict(vocab_size=29, d_model=D, num_heads=H, num_layers=2, d_ff=64, dropout_rate=0.0,
              pad_id=0, bos_id=1, eos_id=2)
PH_CFG = dict(onset_vocab=12, rhyme_vocab=17, tone_vocab=6, d_model=40, num_heads=H,
              num_layers=2, d_ff=64, dropout_rate=0.0, pad_id=2, bos_id=3, eos_id=4)


def _enc(seed=0, d=D):
    rng = np.random.RandomState(seed)
    enc_out = rng.randn(B, LE, d).astype(np.float32)
    enc_mask = np.ones((B, LE), np.int32)
    enc_mask[1, 7:] = 0
    return enc_out, enc_mask


def _random_cache(cache, seed=1):
    """The cache's layout filled with seeded numbers: the step reads the
    self-attention slots before each row's window."""
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*np.shape(v)).astype(np.float32) for n, v in cache.items()}


def _port_cache(cache):
    return {n: torch.from_numpy(np.array(v)) for n, v in cache.items()}


@pytest.fixture(scope="module")
def t5_pair():
    j_model = j_t5.T5(j_t5.T5Config(dtype=jnp.float32, **T5_CFG))
    enc_out, enc_mask = _enc()
    params = jax.tree.map(np.asarray, j_model.init(
        jax.random.PRNGKey(0), enc_out, np.zeros((B, 2), np.int32), enc_mask)["params"])
    t_model = t_t5.T5(t_t5.T5Config(dtype=torch.float32, **T5_CFG), "cpu").eval()
    bridge.load_flax_params(t_model, params)
    return j_model, params, t_model


@pytest.fixture(scope="module")
def cd_pair():
    j_model = j_cd.CustomDecoder(j_cd.CustomDecoderConfig(dtype=jnp.float32, **CD_CFG))
    enc_out, enc_mask = _enc()
    params = jax.tree.map(np.asarray, j_model.init(
        jax.random.PRNGKey(0), np.ones((B, 3), np.int32), enc_out, enc_mask)["params"])
    t_model = t_cd.CustomDecoder(t_cd.CustomDecoderConfig(dtype=torch.float32, **CD_CFG),
                                 "cpu").eval()
    bridge.load_flax_params(t_model, params)
    return j_model, params, t_model


@pytest.fixture(scope="module")
def triple_pair():
    j_model = j_phoneme.PhonemeTripleDecoder(
        j_phoneme.PhonemeDecoderConfig(dtype=jnp.float32, **PH_CFG))
    enc_out, enc_mask = _enc(d=40)
    params = jax.tree.map(np.asarray, j_model.init(
        jax.random.PRNGKey(0), np.full((B, 3, 3), 5, np.int32), enc_out, enc_mask)["params"])
    t_model = t_phoneme.PhonemeTripleDecoder(
        t_phoneme.PhonemeDecoderConfig(dtype=torch.float32, **PH_CFG), "cpu").eval()
    bridge.load_flax_params(t_model, params)
    return j_model, params, t_model


def _check_step_k(want, j_cache, got, t_cache):
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32 and g.shape[:2] == (B, K)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
    for name in ("k", "v"):  # every slot but T-1 (no query reads it)
        np.testing.assert_allclose(t_cache[name][:, :, :, : T - 1].numpy(),
                                   np.asarray(j_cache[name])[:, :, :, : T - 1],
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    # the rows whose window ends inside the buffer: slot T-1 too
    np.testing.assert_allclose(t_cache["k"][:, :2].numpy(), np.asarray(j_cache["k"])[:, :2],
                               atol=ATOL, rtol=RTOL)


def test_t5_decode_step_k_matches_flax_at_per_row_positions(t5_pair):
    j_model, params, t_model = t5_pair
    enc_out, enc_mask = _enc()
    cache, full_bias = j_model.apply({"params": params}, enc_out, T,
                                     method=j_t5.T5.init_cache)
    cache = _random_cache(cache)
    tokens = np.random.RandomState(2).randint(2, 37, (B, K)).astype(np.int32)
    want, j_cache = j_model.apply({"params": params}, tokens, cache, POS.astype(np.int32),
                                  full_bias, enc_mask, method=j_t5.T5.decode_step_k)
    with torch.no_grad():
        _, t_bias = t_model.init_cache(torch.from_numpy(enc_out), T)
        np.testing.assert_allclose(t_bias.numpy(), np.asarray(full_bias), atol=1e-6)
        got, t_cache = t_model.decode_step_k(torch.from_numpy(tokens).long(), _port_cache(cache),
                                             torch.from_numpy(POS), t_bias,
                                             torch.from_numpy(enc_mask))
    assert got.shape == (B, K, 37)
    _check_step_k(want, j_cache, got, t_cache)


def test_custom_decoder_step_k_matches_flax_at_per_row_positions(cd_pair):
    j_model, params, t_model = cd_pair
    enc_out, enc_mask = _enc()
    cache = _random_cache(j_model.apply({"params": params}, enc_out, T,
                                        method=j_cd.CustomDecoder.init_cache))
    tokens = np.random.RandomState(3).randint(3, 29, (B, K)).astype(np.int32)
    want, j_cache = j_model.apply({"params": params}, tokens, cache, POS.astype(np.int32),
                                  enc_mask, method=j_cd.CustomDecoder.step_k)
    with torch.no_grad():
        got, t_cache = t_model.step_k(torch.from_numpy(tokens).long(), _port_cache(cache),
                                      torch.from_numpy(POS), torch.from_numpy(enc_mask))
    _check_step_k(want, j_cache, got, t_cache)


def test_triple_decoder_step_k_matches_flax_at_per_row_positions(triple_pair):
    j_model, params, t_model = triple_pair
    enc_out, enc_mask = _enc(d=40)
    cache = _random_cache(j_model.apply({"params": params}, enc_out, T,
                                        method=j_phoneme.PhonemeTripleDecoder.init_cache))
    rng = np.random.RandomState(4)
    triples = np.stack([rng.randint(5, v, (B, K)) for v in (12, 17, 6)], -1).astype(np.int32)
    want, j_cache = j_model.apply({"params": params}, triples, cache, POS.astype(np.int32),
                                  enc_mask, method=j_phoneme.PhonemeTripleDecoder.step_k)
    with torch.no_grad():
        got, t_cache = t_model.step_k(torch.from_numpy(triples).long(), _port_cache(cache),
                                      torch.from_numpy(POS), torch.from_numpy(enc_mask))
    assert [g.shape[-1] for g in got] == [12, 17, 6]
    _check_step_k(want, j_cache, got, t_cache)


def test_per_row_pe_rows_are_clamped_at_the_table_end():
    pe = torch.arange(12.0).view(6, 2)
    got = t_cd.per_row_pe_rows(pe, torch.tensor([0, 4]), 3)
    assert got[:, :, 0].tolist() == [[0.0, 2.0, 4.0], [8.0, 10.0, 10.0]]


def test_a_window_equals_its_one_token_steps(t5_pair, cd_pair):
    """K teacher-forced one-token steps from position p and one K-token
    window at p give the same logits and the same cache."""
    enc_out, enc_mask = _enc()
    tokens = torch.from_numpy(np.random.RandomState(5).randint(3, 29, (B, 6)))
    mask = torch.from_numpy(enc_mask)
    for name, model in (("t5", t5_pair[2]), ("custom", cd_pair[2])):
        with torch.no_grad():
            if name == "t5":
                cache, bias = model.init_cache(torch.from_numpy(enc_out), T)
                step = lambda tok, c, i: model.decode_step(tok, c, i, bias, mask)
                step_k = lambda tok, c, p: model.decode_step_k(tok, c, p, bias, mask)
            else:
                cache = model.init_cache(torch.from_numpy(enc_out), T)
                step = lambda tok, c, i: model.step(tok, c, i, mask)
                step_k = lambda tok, c, p: model.step_k(tok, c, p, mask)
            ones = {n: v.clone() for n, v in cache.items()}
            seen = []
            for i in range(6):
                logits, ones = step(tokens[:, i], ones, i)
                seen.append(logits)
            window = {n: v.clone() for n, v in cache.items()}
            _, window = step_k(tokens[:, :2], window, torch.zeros(B, dtype=torch.long))
            got, window = step_k(tokens[:, 2:6], window, torch.full((B,), 2))
        torch.testing.assert_close(got, torch.stack(seen[2:6], 1), atol=ATOL, rtol=RTOL)
        for n in ("k", "v"):
            torch.testing.assert_close(window[n], ones[n], atol=ATOL, rtol=RTOL)


# -- speculative decoding ------------------------------------------------------------------


def _t5_decodes(t5_pair):
    """The port's and the JAX package's greedy and speculative decodes of
    the tiny T5 from the same encoder output."""
    j_model, params, t_model = t5_pair
    enc_out, enc_mask = _enc(7)
    t_mask = torch.from_numpy(enc_mask)

    def port(draft_fn=None, with_scores=False, count=None):
        with torch.no_grad():
            cache, bias = t_model.init_cache(torch.from_numpy(enc_out), T)
            if draft_fn is None:
                step = lambda tok, c, i: t_model.decode_step(tok, c, i, bias, t_mask)
                return t_decode.greedy_decode(step, cache, B, T, 0, 1, 0, "cpu",
                                              with_scores=with_scores)

            def step_k(tok, c, pos):
                if count is not None:
                    count.append(1)
                return t_model.decode_step_k(tok, c, pos, bias, t_mask)

            return t_decode.speculative_greedy_decode(step_k, draft_fn, cache, B, T, K, 0, 1, 0,
                                                      "cpu", with_scores=with_scores)

    def jax_spec(draft_fn):
        cache, bias = j_model.apply({"params": params}, enc_out, T, method=j_t5.T5.init_cache)

        def step_k(tok, c, pos):
            return j_model.apply({"params": params}, tok, c, pos, bias, enc_mask,
                                 method=j_t5.T5.decode_step_k)

        return np.asarray(j_spec.speculative_greedy_decode(step_k, draft_fn, cache, B, T, K, 0,
                                                           1, 0))

    return port, jax_spec


def _oracle(rows: np.ndarray, lib):
    """Drafts read from the greedy rows: every draft right."""

    src = torch.from_numpy(rows) if lib is torch else jnp.asarray(rows, jnp.int32)

    def draft(out, pos):
        if lib is torch:
            idx = (pos[:, None] + 1 + torch.arange(K - 1)[None, :]).clamp(max=T - 1)
            return src.gather(1, idx)
        idx = jnp.minimum(pos[:, None] + 1 + jnp.arange(K - 1)[None, :], T - 1)
        return jnp.take_along_axis(src, idx, axis=1)

    return draft


def test_speculative_decode_gives_greedy_rows_with_any_draft(t5_pair):
    port, jax_spec = _t5_decodes(t5_pair)
    greedy, greedy_scores = port(with_scores=True)
    rows = greedy.numpy()
    wrong = lambda lib: lambda out, pos: (torch.full((B, K - 1), 36) if lib is torch
                                          else jnp.full((B, K - 1), 36, jnp.int32))

    def ragged(lib):  # rows 0 and 2 drafted right, row 1 wrong
        oracle, bad = _oracle(rows, lib), wrong(lib)
        pick = np.array([True, False, True])[:, None]
        return lambda out, pos: (torch.where(torch.from_numpy(pick), oracle(out, pos),
                                             bad(out, pos)) if lib is torch else
                                 jnp.where(pick, oracle(out, pos), bad(out, pos)))

    src = np.random.RandomState(3).randint(1, 37, (B, 12))
    src[:, 2:2 + T - 1] = rows[:, 1:]  # the answers occur in the source
    lookup = lambda lib: (t_decode.make_prompt_lookup_draft(torch.from_numpy(src), K - 1, 0)
                          if lib is torch else
                          j_spec.make_prompt_lookup_draft(jnp.asarray(src, jnp.int32), K - 1, 0))
    for name, make in (("wrong", wrong), ("oracle", lambda lib: _oracle(rows, lib)),
                       ("ragged", ragged), ("prompt lookup", lookup)):
        got, scores = port(make(torch), with_scores=True)
        np.testing.assert_array_equal(got.numpy(), rows, err_msg=name)
        np.testing.assert_allclose(scores.numpy(), greedy_scores.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(jax_spec(make(jnp)), rows, err_msg=name)


def test_oracle_drafts_take_one_trip_a_window(t5_pair):
    port, _ = _t5_decodes(t5_pair)
    rows = port().numpy()
    lengths = [row.tolist().index(1) if 1 in row.tolist()[1:] else T - 1 for row in rows]
    trips = []
    port(_oracle(rows, torch), count=trips)
    assert len(trips) == max(-(-n // K) for n in lengths)
    wrong_trips = []
    port(lambda out, pos: torch.full((B, K - 1), 36), count=wrong_trips)
    assert len(wrong_trips) == max(lengths)


# -- the pool decode -----------------------------------------------------------------------


# stop ids that these seeded models' greedy rows emit at different steps,
# so rows end at several lengths and slots refill mid-stream
T5_POOL_EOS, TRIPLE_POOL_EOS = 21, 0


@pytest.mark.parametrize("num_slots", [1, 2, 5])
def test_pool_decode_gives_batch_greedy_rows_and_jax_rows(t5_pair, num_slots):
    """Five rows through fewer slots (refills), rows of several lengths."""
    j_model, params, t_model = t5_pair
    n = 5
    enc_out = np.random.RandomState(8).randn(n, LE, D).astype(np.float32)
    enc_mask = np.ones((n, LE), np.int32)
    enc_mask[3, 4:] = 0
    with torch.no_grad():
        cache, bias = t_model.init_cache(torch.from_numpy(enc_out), T)
        t_mask = torch.from_numpy(enc_mask)
        greedy, greedy_s = t_decode.greedy_decode(
            lambda tok, c, i: t_model.decode_step(tok, c, i, bias, t_mask),
            {k: v.clone() for k, v in cache.items()}, n, T, 0, T5_POOL_EOS, 0, "cpu",
            with_scores=True)
        got, got_s = t_decode.pool_greedy_decode(
            lambda tok, c, pos, m: t_model.decode_step_k(tok, c, pos, bias, m), cache, t_mask,
            num_slots, T, 0, T5_POOL_EOS, 0, with_scores=True)
    lengths = {row.index(T5_POOL_EOS) if T5_POOL_EOS in row else T for row in greedy.tolist()}
    assert len(lengths) >= 3, lengths
    torch.testing.assert_close(got, greedy, atol=0, rtol=0)
    torch.testing.assert_close(got_s, greedy_s, atol=1e-5, rtol=1e-5)
    j_cache, j_bias = j_model.apply({"params": params}, enc_out, T, method=j_t5.T5.init_cache)
    want = j_pool.pool_greedy_decode(
        lambda tok, c, pos, m: j_model.apply({"params": params}, tok, c, pos, j_bias, m,
                                             method=j_t5.T5.decode_step_k),
        j_cache, jnp.asarray(enc_mask), num_slots, T, 0, T5_POOL_EOS, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pool_decode_over_triples_gives_batch_greedy_rows(triple_pair):
    _, _, t_model = triple_pair
    n = 4
    enc_out = np.random.RandomState(9).randn(n, LE, 40).astype(np.float32)
    mask = torch.ones((n, LE), dtype=torch.int32)
    with torch.no_grad():
        cache = t_model.init_cache(torch.from_numpy(enc_out), T)
        greedy = t_decode.multi_head_greedy_decode(
            lambda tok, c, i: t_model.step(tok, c, i, mask),
            {k: v.clone() for k, v in cache.items()}, n, T, 3, 3, TRIPLE_POOL_EOS, 2, "cpu")
        got = t_decode.pool_greedy_decode(
            lambda tok, c, pos, m: t_model.step_k(tok, c, pos, m), cache, mask, 3, T, 3,
            TRIPLE_POOL_EOS, 2, num_components=3)
    onsets = greedy[..., 0].tolist()
    assert len({r.index(TRIPLE_POOL_EOS, 1) if TRIPLE_POOL_EOS in r[1:] else T
                for r in onsets}) >= 2
    torch.testing.assert_close(got, greedy, atol=0, rtol=0)
