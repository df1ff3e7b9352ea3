"""The port's custom answer decoder against the JAX package's on the CPU, in
f32 at tiny widths: teacher-forced logits, the step-by-step cached logits of
greedy decoding, the sinusoidal table, the dropout sites, and the weight
bridge over a ``PhonemeSaL.init`` tree (in both block layouts).

Flax initializes the weights; ``phoneme_vqa_torch.models.bridge`` copies
them into the port; the same numpy inputs go through both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.models import custom_decoder as t_cd
from phoneme_vqa_torch.models import customized as t_customized
from phoneme_vqa_torch.models import phoneme as t_phoneme
from phoneme_vqa_torch.models import t5 as t_t5
from phoneme_vqa_tpu.models import custom_decoder as j_cd
from phoneme_vqa_tpu.models import customized as j_customized
from phoneme_vqa_tpu.models import phoneme as j_phoneme
from phoneme_vqa_tpu.models.scan_utils import stack_block_params

ATOL = RTOL = 1e-4  # f32 on both sides, sums in another order
B, T, LM, D, H, LAYERS, FF, V = 3, 7, 19, 32, 4, 2, 64, 253


def _cfgs(**over):
    kw = {**dict(vocab_size=V, d_model=D, num_heads=H, num_layers=LAYERS, d_ff=FF,
                 dropout_rate=0.0, pad_id=0, bos_id=1, eos_id=2), **over}
    return j_cd.CustomDecoderConfig(dtype=jnp.float32, **kw), \
        t_cd.CustomDecoderConfig(dtype=torch.float32, **kw)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, V, (B, T)).astype(np.int32)
    memory = rng.randn(B, LM, D).astype(np.float32)
    mem_mask = np.ones((B, LM), np.int32)
    mem_mask[1, 12:] = 0
    tgt_mask = np.ones((B, T), np.int32)
    tgt_mask[0, 4:] = 0
    return ids, memory, mem_mask, tgt_mask


@pytest.fixture(scope="module")
def pair():
    j_cfg, t_cfg = _cfgs()
    ids, memory, mem_mask, tgt_mask = _inputs()
    j_model = j_cd.CustomDecoder(j_cfg)
    params = jax.tree.map(np.asarray, j_model.init(
        jax.random.PRNGKey(0), ids, memory, mem_mask, tgt_mask)["params"])
    t_model = t_cd.CustomDecoder(t_cfg, "cpu").eval()
    bridge.load_flax_params(t_model, params)
    return j_model, params, t_model


def test_sinusoidal_table_equals_jax_and_is_not_a_parameter(pair):
    np.testing.assert_array_equal(t_cd.sinusoidal_table(64, D), j_cd.sinusoidal_table(64, D))
    _, _, t_model = pair
    assert "pe" not in t_model.state_dict()
    np.testing.assert_array_equal(t_model.pe.numpy(), j_cd.sinusoidal_table(5000, D))
    # building on the meta device and moving with to_empty keeps the table exact
    with torch.device("meta"):
        moved = t_cd.CustomDecoder(_cfgs()[1], "meta")
    moved = moved.to_empty(device="cpu")
    torch.testing.assert_close(moved.pe, t_model.pe, atol=0, rtol=0)


def test_teacher_forced_logits_match_flax(pair):
    j_model, params, t_model = pair
    ids, memory, mem_mask, tgt_mask = _inputs(1)
    want = np.asarray(j_model.apply({"params": params}, ids, memory, mem_mask, tgt_mask))
    with torch.no_grad():
        got = t_model(torch.from_numpy(ids), torch.from_numpy(memory),
                      torch.from_numpy(mem_mask), torch.from_numpy(tgt_mask))
    assert got.dtype == torch.float32 and got.shape == (B, T, V)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_cached_step_logits_match_flax(pair):
    """Greedy decoding step by step over the stacked cache: the logits of
    every step, fed the JAX side's argmax tokens, and the tokens."""
    j_model, params, t_model = pair
    _, memory, mem_mask, _ = _inputs(2)
    max_len = 9
    cache = j_model.apply({"params": params}, memory, max_len, method=j_cd.CustomDecoder.init_cache)
    with torch.no_grad():
        t_cache = t_model.init_cache(torch.from_numpy(memory), max_len)
    assert t_cache["k"].shape == (LAYERS, B, H, max_len, D // H)
    tokens = np.full((B,), 1, np.int32)
    for i in range(max_len - 1):
        want, cache = j_model.apply({"params": params}, tokens, cache, i, mem_mask,
                                    method=j_cd.CustomDecoder.step)
        with torch.no_grad():
            got, t_cache = t_model.step(torch.from_numpy(tokens).long(), t_cache, i,
                                        torch.from_numpy(mem_mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL,
                                   err_msg=f"step {i}")
        tokens = np.asarray(want).argmax(-1).astype(np.int32)
        assert (got.argmax(-1).numpy() == tokens).all(), i


def test_dropout_sites_draw_from_the_shared_stream():
    """After the PE, on the three residual branches and inside the FFN of
    every layer: 1 + 4 x layers calls in a forward, all from one stream; the
    identity in eval mode."""
    rng = t_t5.DropoutRNG()
    model = t_cd.CustomDecoder(_cfgs(dropout_rate=0.1)[1], "cpu", rng=rng)
    calls = []
    for name, m in model.named_modules():
        if isinstance(m, t_t5.Dropout):
            assert m.rng is rng and m.rate == 0.1, name
            m.register_forward_hook(lambda m, i, o, name=name: calls.append(name))
    ids, memory, mem_mask, tgt_mask = map(torch.from_numpy, _inputs())
    with torch.no_grad():
        rng.reseed(13, 0)
        a = model.train()(ids, memory, mem_mask, tgt_mask)
        rng.reseed(13, 0)
        torch.testing.assert_close(model(ids, memory, mem_mask, tgt_mask), a, atol=0, rtol=0)
        rng.reseed(13, 1)
        assert not torch.equal(model(ids, memory, mem_mask, tgt_mask), a)
        n = len(calls)
        rng.reseed(13, 0)
        plain = model.eval()(ids, memory, mem_mask, tgt_mask)
        rng.reseed(13, 1)
        torch.testing.assert_close(model(ids, memory, mem_mask, tgt_mask), plain, atol=0, rtol=0)
    assert n == 3 * (1 + 4 * LAYERS)
    assert calls[:n].count("layer_1.drop") == 3 * 4 and calls[:n].count("pe_drop") == 3
    assert not torch.equal(plain, a)


# -- the bridge over a PhonemeSaL tree -------------------------------------------

SAL_CFG = {
    "t5_vocab_size": 512, "d_model": D, "d_kv": 8, "num_heads": H, "d_ff": 64,
    "num_encoder_layers": 2, "num_t5_decoder_layers": 2, "dropout_rate": 0.0,
    "DTYPE": "float32", "ocr_hidden": 16, "obj_hidden": 8, "max_q_length": 6,
    "max_ocr_length": 10, "n_head": H, "num_decoder_layers": LAYERS,
}


def _sal_batch(b=2):
    rng = np.random.RandomState(0)
    ints = lambda *s: rng.randint(3, 512, s).astype(np.int32)
    return {
        "input_ids": ints(b, 6), "src_attention_mask": np.ones((b, 6), np.int32),
        "tokenized_ocr": ints(b, 10), "ocr_attention_mask": np.ones((b, 10), np.int32),
        "ocr_coordinates": rng.uniform(0, 1, (b, 10, 4)).astype(np.float32),
        "ocr_features": rng.randn(b, 10, 16).astype(np.float32),
        "tokenized_obj": ints(b, 5), "obj_attention_mask": np.ones((b, 5), np.int32),
        "obj_coordinates": rng.uniform(0, 1, (b, 5, 4)).astype(np.float32),
        "obj_features": rng.randn(b, 5, 8).astype(np.float32),
    }


@pytest.fixture(scope="module")
def phoneme_tree():
    j_model = j_phoneme.PhonemeSaL(j_customized.CustomizedSaL_config().build(SAL_CFG, V, 0, 1, 2))
    labels = np.ones((1, 5), np.int32)
    params = j_model.init(jax.random.PRNGKey(0), {k: v[:1] for k, v in _sal_batch().items()},
                          labels, labels)["params"]
    return jax.tree.map(np.asarray, params)


def _port_phoneme_sal():
    cfg = t_customized.CustomizedSaL_config().build(SAL_CFG, V, 0, 1, 2)
    return t_phoneme.PhonemeSaL(cfg, device="cpu")


def _flax_leaf(tree, name):
    """The flax leaf a port parameter name comes from, in the port's layout."""
    *scope, leaf = name.split(".")
    node = tree
    for key in scope:
        node = node[key]
    if leaf == "weight" and "kernel" in node:
        return node["kernel"].T
    if leaf == "weight":
        return node["scale"] if "scale" in node else node["embedding"] if "embedding" in node \
            else node["weight"]
    return node[leaf]


def test_bridge_round_trip_over_a_phoneme_sal_tree(phoneme_tree):
    params = phoneme_tree
    # flax creates only what is called: the backbone is encoder-only
    assert sorted(params) == ["decoder", "obj_bbox_projector", "obj_feature_projector",
                              "obj_norm", "ocr_bbox_projector", "ocr_feature_projector",
                              "ocr_norm", "rel2d", "t5"]
    assert sorted(params["t5"]) == ["encoder", "shared"]
    model = _port_phoneme_sal()
    assert not hasattr(model.t5, "decoder") and not hasattr(model.t5, "lm_head")
    bridge.load_flax_params(model, params)
    n = 0
    for name, p in model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), _flax_leaf(params, name), err_msg=name)
        n += 1
    assert n == sum(1 for _ in jax.tree.leaves(params))
    assert "decoder.layer_1.ln3.bias" in model.state_dict()
    # the SCAN_LAYERS layout of the encoder loads the same weights
    stacked = jax.tree.map(np.asarray, stack_block_params(params))
    other = bridge.load_flax_params(_port_phoneme_sal(), stacked)
    for name, p in model.state_dict().items():
        torch.testing.assert_close(other.state_dict()[name], p, atol=0, rtol=0)


def test_bridge_is_strict_on_the_decoder_tree(phoneme_tree):
    model = _port_phoneme_sal()
    dec = phoneme_tree["decoder"]
    with pytest.raises(KeyError, match="decoder.lm_head.bias"):
        bridge.flax_to_state_dict(dict(phoneme_tree, decoder=dict(
            dec, lm_head={"kernel": dec["lm_head"]["kernel"]})), model)
    with pytest.raises(KeyError, match="decoder/layer_9"):
        bridge.flax_to_state_dict(dict(phoneme_tree, decoder=dict(
            dec, layer_9=dec["layer_0"])), model)
    # a stock T5 decoder has no place in the encoder-only backbone
    with pytest.raises(KeyError, match="t5/decoder"):
        bridge.flax_to_state_dict(dict(phoneme_tree, t5=dict(
            phoneme_tree["t5"], decoder={"final_ln": {"weight": np.ones(D, np.float32)}})),
            model)
