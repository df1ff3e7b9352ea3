"""The port's triple-stream phoneme pieces against the JAX package's on the
CPU, in f32 at tiny widths with a ``d_model`` not divisible by 3 (40: onset
width 14, rhyme and tone 13), so that a slice or concatenation error shows:

* ``StructuredPhonemeTokenizer``: the vocabulary built from an annotation
  file, ``encode`` / ``decode`` over Vietnamese, capitals, digits, foreign
  letters and ``q``-onset words, a saved and loaded vocabulary, ``decode``
  total over special ids in every slot;
* ``PhonemeTripleDecoder``: the three heads' teacher-forced logits and the
  cached ``step`` logits at every position of a 20-step run, the PE table;
* ``multi_head_greedy_decode`` on a scripted step function (rows stop only
  on an onset EOS, pad afterwards, the loop exits early, the scores);
* the weight bridge over ``PhonemeLaTr.init`` and ``PhonemePreSTU.init``
  trees: every leaf mapped, strict both ways.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoneme_vqa_torch.decode import greedy as t_greedy
from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.models import custom_decoder as t_cd
from phoneme_vqa_torch.models import phoneme as t_phoneme
from phoneme_vqa_torch.models import t5 as t_t5
from phoneme_vqa_torch.tokenizers import StructuredPhonemeTokenizer
from phoneme_vqa_torch.utils.registry import TOKENIZERS as T_TOKENIZERS
from phoneme_vqa_tpu.decode import greedy as j_greedy
from phoneme_vqa_tpu.models import customized as j_customized
from phoneme_vqa_tpu.models import phoneme as j_phoneme
from phoneme_vqa_tpu.tokenizers import phoneme_structured as j_structured

from .fixtures import ANSWERS, QUESTIONS

ATOL = RTOL = 1e-4  # f32 on both sides, sums in another order
B, T, LM, D, H, LAYERS, FF = 3, 9, 19, 40, 4, 2, 64
ONSET_V, RHYME_V, TONE_V = 30, 50, 8
PAD, BOS, EOS = 2, 3, 4

SENTENCES = ANSWERS + QUESTIONS + [
    "Quán Phở HÀ NỘI", "quý khách quốc lộ 1A", "giờ mở cửa 7:30", "wifi free 24/7",
    "Nguyễn Huệ", "zalo: 0903 123 456", "quả quýt", "gì giữa giếng", "đường Lê Lợi",
]


def _write_annotations(root) -> str:
    """Every sentence but the last, whose words stay out of the vocabulary."""
    ann = {"annotations": [{"question": s, "answers": [s]} for s in SENTENCES[:-1]]}
    path = os.path.join(str(root), "annotations.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(ann, f, ensure_ascii=False)
    return path


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    root = tmp_path_factory.mktemp("structured")
    ann = _write_annotations(root)
    return (j_structured.StructuredPhonemeTokenizer(annotation_paths=[ann]),
            StructuredPhonemeTokenizer(vocab_path=str(root / "port_vocab.json"),
                                       annotation_paths=[ann]),
            root)


def test_built_vocabulary_equals_jax_and_aligns_the_specials(tokenizers):
    j_tok, t_tok, _ = tokenizers
    assert t_tok.vocab == j_tok.vocab
    for part in ("onset", "rhyme", "tone"):
        assert [t_tok.vocab[part][s] for s in ("none", "<_>", "<pad>", "<bos>", "<eos>")] == \
            list(range(5)), part
    assert (t_tok.onset_size, t_tok.rhyme_size, t_tok.tone_size) == \
        (j_tok.onset_size, j_tok.rhyme_size, j_tok.tone_size)
    assert (t_tok.pad_id, t_tok.bos_id, t_tok.eos_id) == (PAD, BOS, EOS)
    assert T_TOKENIZERS.get("StructuredPhonemeTokenizer") is StructuredPhonemeTokenizer


@pytest.mark.parametrize("max_length", [6, 30])
def test_encode_and_decode_equal_jax(tokenizers, max_length):
    j_tok, t_tok, _ = tokenizers
    for s in SENTENCES:
        got = t_tok.encode(s, max_length)
        assert got == j_tok.encode(s, max_length), s
        assert len(got) == max_length and got[0] == [BOS] * 3
        assert t_tok.decode(got) == j_tok.decode(np.asarray(got)), s
    np.testing.assert_array_equal(t_tok.batch_encode(SENTENCES, max_length),
                                  j_tok.batch_encode(SENTENCES, max_length))
    np.testing.assert_array_equal(t_tok.create_mask(t_tok(SENTENCES, max_length)),
                                  j_tok.create_mask(j_tok(SENTENCES, max_length)))


def test_decode_recomposes_lowercased_vietnamese(tokenizers):
    _, t_tok, _ = tokenizers
    for s in ("quán phở hà nội", "quả quýt", "gì giữa giếng", "số 5 nguyễn huệ"):
        assert t_tok.decode(t_tok.encode(s, 40)) == s
    assert t_tok.decode(t_tok.encode("Quán Phở HÀ NỘI", 40)) == "quán phở hà nội"


def test_a_saved_vocabulary_loads_to_the_same_ids(tokenizers):
    j_tok, t_tok, root = tokenizers
    path = str(root / "port_vocab.json")
    assert os.path.isfile(path)  # the build saved it
    loaded = StructuredPhonemeTokenizer(vocab_path=path)  # no annotations: read back
    assert loaded.vocab == t_tok.vocab
    j_loaded = j_structured.StructuredPhonemeTokenizer(vocab_path=path)
    for s in SENTENCES:
        assert loaded.encode(s, 24) == t_tok.encode(s, 24) == j_loaded.encode(s, 24)


def test_decode_is_total_on_special_ids_in_every_slot(tokenizers):
    j_tok, t_tok, _ = tokenizers
    rng = np.random.RandomState(0)
    rows = np.stack([rng.randint(0, 5, (40, 3)), rng.randint(0, 8, (40, 3))], 0)
    rows[..., 0] = np.where(rows[..., 0] == EOS, 5, rows[..., 0])  # no early stop
    rows[1, :, 0] = rng.randint(5, t_tok.onset_size, 40)  # real onsets, special rhymes
    rows[1, ::3, 1:] = rng.randint(0, 5, (14, 2))
    for row in rows:
        got = t_tok.decode(row)
        assert isinstance(got, str) and "<" not in got
        assert got == j_tok.decode(row)
    # an onset EOS ends the answer; an EOS in rhyme or tone does not
    row = np.asarray(t_tok.encode("quán phở", 12))
    row[2, 1:] = EOS
    assert t_tok.decode(row) == j_tok.decode(row)
    row[2, 0] = EOS
    assert t_tok.decode(row) == "quán" == j_tok.decode(row)


# -- the triple decoder ------------------------------------------------------------


def _cfgs(**over):
    kw = {**dict(onset_vocab=ONSET_V, rhyme_vocab=RHYME_V, tone_vocab=TONE_V, d_model=D,
                 num_heads=H, num_layers=LAYERS, d_ff=FF, dropout_rate=0.0), **over}
    return j_phoneme.PhonemeDecoderConfig(dtype=jnp.float32, **kw), \
        t_phoneme.PhonemeDecoderConfig(dtype=torch.float32, **kw)


def _inputs(seed=0, t=T):
    rng = np.random.RandomState(seed)
    triples = np.stack([rng.randint(5, v, (B, t)) for v in (ONSET_V, RHYME_V, TONE_V)],
                       -1).astype(np.int32)
    memory = rng.randn(B, LM, D).astype(np.float32)
    mem_mask = np.ones((B, LM), np.int32)
    mem_mask[1, 12:] = 0
    tgt_mask = np.ones((B, t), np.int32)
    tgt_mask[0, 5:] = 0
    return triples, memory, mem_mask, tgt_mask


@pytest.fixture(scope="module")
def decoders():
    j_cfg, t_cfg = _cfgs()
    triples, memory, mem_mask, tgt_mask = _inputs()
    j_model = j_phoneme.PhonemeTripleDecoder(j_cfg)
    params = jax.tree.map(np.asarray, j_model.init(
        jax.random.PRNGKey(0), triples, memory, mem_mask, tgt_mask)["params"])
    t_model = t_phoneme.PhonemeTripleDecoder(t_cfg, "cpu").eval()
    bridge.load_flax_params(t_model, params)
    return j_model, params, t_model


def test_widths_follow_the_thirds_of_d_model(decoders):
    _, params, t_model = decoders
    assert (t_model.cfg.onset_dim, t_model.cfg.rt_dim) == (14, 13)
    assert t_model.onset_embed.weight.shape == (ONSET_V, 14)
    assert t_model.rhyme_embed.weight.shape == (RHYME_V, 13)
    assert t_model.tone_embed.weight.shape == (TONE_V, 13)
    assert params["shared_lm_head"]["kernel"].shape == (D, D)
    assert "pe" not in t_model.state_dict()
    np.testing.assert_array_equal(t_model.pe.numpy(), t_cd.sinusoidal_table(5000, D))


def test_teacher_forced_logits_of_the_three_heads_match_flax(decoders):
    j_model, params, t_model = decoders
    triples, memory, mem_mask, tgt_mask = _inputs(1)
    want = j_model.apply({"params": params}, triples, memory, mem_mask, tgt_mask)
    with torch.no_grad():
        got = t_model(*map(torch.from_numpy, (triples, memory, mem_mask, tgt_mask)))
    assert len(got) == 3
    for name, g, w, v in zip(("onset", "rhyme", "tone"), got, want, (ONSET_V, RHYME_V, TONE_V)):
        assert g.dtype == torch.float32 and g.shape == (B, T, v), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL, err_msg=name)


def test_the_pe_is_added_unscaled(decoders):
    """The triple decoder adds the PE to the raw embeddings (the custom
    decoder scales its embedding by sqrt(d))."""
    _, _, t_model = decoders
    triples = torch.from_numpy(_inputs(2)[0])
    x = torch.cat([t_model.onset_embed(triples[..., 0]), t_model.rhyme_embed(triples[..., 1]),
                   t_model.tone_embed(triples[..., 2])], -1)
    torch.testing.assert_close(t_model._embed(triples, offset=3), x + t_model.pe[3:3 + T][None])


def test_cached_step_logits_match_flax_over_20_steps(decoders):
    """20 steps over the stacked cache, each fed the JAX side's argmax
    triple: the three heads' logits at every position."""
    j_model, params, t_model = decoders
    _, memory, mem_mask, _ = _inputs(3)
    max_len = 21
    cache = j_model.apply({"params": params}, memory, max_len,
                          method=j_phoneme.PhonemeTripleDecoder.init_cache)
    with torch.no_grad():
        t_cache = t_model.init_cache(torch.from_numpy(memory), max_len)
    assert t_cache["k"].shape == (LAYERS, B, H, max_len, D // H)
    triples = np.full((B, 3), BOS, np.int32)
    for i in range(max_len - 1):
        want, cache = j_model.apply({"params": params}, triples, cache, i, mem_mask,
                                    method=j_phoneme.PhonemeTripleDecoder.step)
        with torch.no_grad():
            got, t_cache = t_model.step(torch.from_numpy(triples).long(), t_cache, i,
                                        torch.from_numpy(mem_mask))
        for c, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL,
                                       err_msg=f"step {i} head {c}")
        triples = np.stack([np.asarray(w).argmax(-1) for w in want], -1).astype(np.int32)


def test_dropout_draws_from_the_shared_stream():
    """After the PE and at the four sites of every layer; reproducible from
    (seed, step); the identity in eval mode."""
    rng = t_t5.DropoutRNG()
    model = t_phoneme.PhonemeTripleDecoder(_cfgs(dropout_rate=0.1)[1], "cpu", rng=rng)
    drops = [m for m in model.modules() if isinstance(m, t_t5.Dropout)]
    assert len(drops) == 1 + LAYERS and all(m.rng is rng for m in drops)
    args = tuple(map(torch.from_numpy, _inputs()))
    with torch.no_grad():
        rng.reseed(13, 0)
        a = model.train()(*args)
        rng.reseed(13, 0)
        for x, y in zip(model(*args), a):
            torch.testing.assert_close(x, y, atol=0, rtol=0)
        rng.reseed(13, 1)
        assert not torch.equal(model(*args)[0], a[0])
        plain = model.eval()(*args)
        assert not torch.equal(plain[0], a[0])


# -- multi_head_greedy_decode ---------------------------------------------------------

V_SCRIPT = 7


def _script(n_steps=9, seed=0):
    """Per step and head, (B, V) logits with the argmax scripted: row 0
    emits an onset EOS at step 2; row 1 an EOS in its rhyme and tone at
    steps 0-1 (which does not stop it) and an onset EOS at step 4; row 2 an
    onset EOS at step 5. Random logits elsewhere, argmax kept off EOS."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(n_steps, 3, B, V_SCRIPT).astype(np.float32)
    logits[..., EOS] = -5.0

    def put(step, head, row, token):
        logits[step, head, row, token] = 5.0

    put(2, 0, 0, EOS)
    for step in (0, 1):
        put(step, 1, 1, EOS)
        put(step, 2, 1, EOS)
    put(4, 0, 1, EOS)
    put(5, 0, 2, EOS)
    return logits


def test_multi_head_greedy_decode_matches_jax_and_stops_on_the_onset():
    logits = _script()
    max_len = 10
    calls = []

    def t_step(tokens, cache, i):
        calls.append(i)
        assert tokens.shape == (B, 3)
        return tuple(torch.from_numpy(logits[i, c]) for c in range(3)), cache

    def j_step(tokens, cache, i):
        table = jnp.asarray(logits)
        return tuple(table[i, c] for c in range(3)), cache

    got, got_scores = t_greedy.multi_head_greedy_decode(
        t_step, None, B, max_len, 3, BOS, EOS, PAD, "cpu", with_scores=True)
    want, want_scores = jax.jit(lambda: j_greedy.multi_head_greedy_decode(
        j_step, jnp.zeros(()), B, max_len, 3, BOS, EOS, PAD, with_scores=True))()
    assert got.shape == (B, max_len, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores), rtol=1e-6)
    assert calls == list(range(6))  # every row done after step 5: no step 6
    out = got.numpy()
    assert (out[:, 0] == BOS).all()
    assert out[0, 3, 0] == EOS and (out[0, 4:] == PAD).all()
    assert (out[1, 1:3, 1:] == EOS).all() and (out[1, 1:3, 0] != EOS).all()
    assert out[1, 5, 0] == EOS and (out[1, 6:] == PAD).all()
    assert out[2, 6, 0] == EOS and (out[2, 7:] == PAD).all()
    # scores: the mean log-probability per emitted id, over steps x 3
    lp = torch.log_softmax(torch.from_numpy(logits), -1).numpy()
    chosen = [sum(lp[i, c, 0, out[0, i + 1, c]] for c in range(3)) for i in range(3)]
    np.testing.assert_allclose(float(got_scores[0]), sum(chosen) / 9, rtol=1e-5)


def test_multi_head_greedy_decode_runs_to_the_length_without_an_eos():
    logits = _script()
    logits[..., EOS] = -5.0  # nobody stops
    calls = []

    def step(tokens, cache, i):
        calls.append(i)
        return tuple(torch.from_numpy(logits[i, c]) for c in range(3)), cache

    out = t_greedy.multi_head_greedy_decode(step, None, B, 8, 3, BOS, EOS, PAD, "cpu")
    assert calls == list(range(7))
    np.testing.assert_array_equal(out[:, 1:].numpy(), logits[:7].argmax(-1).transpose(2, 0, 1))


# -- the bridge over PhonemeLaTr / PhonemePreSTU trees ------------------------------

FAMILY_CFG = {
    "t5_vocab_size": 256, "d_model": D, "d_kv": 8, "num_heads": H, "d_ff": 64,
    "num_encoder_layers": 2, "num_t5_decoder_layers": 2, "dropout_rate": 0.0,
    "vit_image_size": 32, "vit_patch_size": 16, "vit_hidden_size": 32, "vit_num_layers": 2,
    "vit_num_heads": 4, "vit_mlp_dim": 64, "DTYPE": "float32",
    "max_2d_position_embeddings": 1024, "n_head": H, "num_decoder_layers": LAYERS,
}


def _phoneme_configs(builder):
    j_base = builder[0]().build(FAMILY_CFG)
    t_base = builder[1]().build(FAMILY_CFG)
    kw = dict(onset_vocab=ONSET_V, rhyme_vocab=RHYME_V, tone_vocab=TONE_V, pad_id=PAD,
              bos_id=BOS, eos_id=EOS)
    j_cfg = j_phoneme.PhonemeLaTrConfig(
        t5=j_base.t5, vit=j_base.vit, freeze_vit=True,
        phoneme_decoder=j_phoneme.phoneme_decoder_from_yaml(FAMILY_CFG, j_base.t5, **kw))
    t_cfg = t_phoneme.PhonemeLaTrConfig(
        t5=t_base.t5, vit=t_base.vit, freeze_vit=True,
        phoneme_decoder=t_phoneme.phoneme_decoder_from_yaml(FAMILY_CFG, t_base.t5, **kw))
    return j_cfg, t_cfg


def _family_batch(b=1):
    rng = np.random.RandomState(0)
    return {
        "pixel_values": rng.randn(b, 3, 32, 32).astype(np.float32),
        "coordinates": rng.randint(0, 1000, (b, 6, 6)).astype(np.int32),
        "input_ids": rng.randint(3, 256, (b, 8)).astype(np.int32),
        "src_attention_mask": np.ones((b, 8), np.int32),
        "tokenized_ocr": rng.randint(3, 256, (b, 6)).astype(np.int32),
        "ocr_attention_mask": np.ones((b, 6), np.int32),
    }


@pytest.fixture(scope="module", params=["PhonemeLaTr", "PhonemePreSTU"])
def family_tree(request):
    from phoneme_vqa_torch.models import customized as t_customized
    builder = (j_customized.CustomizedLaTr_config, t_customized.CustomizedLaTr_config) \
        if request.param == "PhonemeLaTr" else \
        (j_customized.CustomizedPreSTU_config, t_customized.CustomizedPreSTU_config)
    j_cfg, t_cfg = _phoneme_configs(builder)
    j_model = getattr(j_phoneme, request.param)(j_cfg)
    labels = np.full((1, 4, 3), BOS, np.int32)
    params = j_model.init(jax.random.PRNGKey(0), _family_batch(), labels,
                          np.ones((1, 4), np.int32))["params"]
    return request.param, t_cfg, jax.tree.map(np.asarray, params)


def test_bridge_maps_every_leaf_of_the_triple_decoder_tree(family_tree):
    name, t_cfg, params = family_tree
    assert sorted(params["decoder"]) == sorted(
        ["onset_embed", "rhyme_embed", "tone_embed", "shared_lm_head", "onset_lm_head",
         "rhyme_lm_head", "tone_lm_head"] + [f"layer_{i}" for i in range(LAYERS)])
    assert sorted(params["t5"]) == ["encoder", "shared"]  # no stock T5 decoder
    assert ("spatial" in params) == (name == "PhonemeLaTr")
    model = getattr(t_phoneme, name)(t_cfg, device="cpu")
    bridge.load_flax_params(model, params)
    state = model.state_dict()
    assert len(state) == len(jax.tree.leaves(params))
    dec = params["decoder"]
    np.testing.assert_array_equal(state["decoder.shared_lm_head.weight"].numpy(),
                                  dec["shared_lm_head"]["kernel"].T)
    np.testing.assert_array_equal(state["decoder.tone_embed.weight"].numpy(),
                                  dec["tone_embed"]["embedding"])
    np.testing.assert_array_equal(state["decoder.layer_1.cross_attn.v.bias"].numpy(),
                                  dec["layer_1"]["cross_attn"]["v"]["bias"])


def test_bridge_is_strict_on_the_triple_decoder_tree(family_tree):
    name, t_cfg, params = family_tree
    model = getattr(t_phoneme, name)(t_cfg, device="cpu")
    dec = params["decoder"]
    with pytest.raises(KeyError, match="decoder.rhyme_lm_head.bias"):
        bridge.flax_to_state_dict(dict(params, decoder=dict(
            dec, rhyme_lm_head={"kernel": dec["rhyme_lm_head"]["kernel"]})), model)
    with pytest.raises(KeyError, match="decoder/layer_5"):
        bridge.flax_to_state_dict(dict(params, decoder=dict(dec, layer_5=dec["layer_0"])), model)
    # the onset and rhyme embeddings differ in width: swapped, they do not fit
    with pytest.raises(KeyError, match="decoder/onset_embed"):
        bridge.flax_to_state_dict(dict(params, decoder=dict(
            dec, onset_embed=dec["rhyme_embed"])), model)
