"""The port's LaTr against the flax LaTr on the CPU, in f32 at tiny widths.

Flax initializes the weights; ``phoneme_vqa_torch.models.bridge`` copies them
into the port; the same numpy batch goes through both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_batch, _tiny_yaml_config
from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.models import latr as t_latr
from phoneme_vqa_torch.models import t5 as t_t5
from phoneme_vqa_torch.models import vit as t_vit
from phoneme_vqa_torch.models.generate import make_generate_fn as t_make_generate_fn
from phoneme_vqa_torch.models.spatial import SpatialModule as TSpatial
from phoneme_vqa_tpu.models import latr as j_latr
from phoneme_vqa_tpu.models import t5 as j_t5
from phoneme_vqa_tpu.models.generate import make_generate_fn as j_make_generate_fn
from phoneme_vqa_tpu.models.scan_utils import stack_block_params
from phoneme_vqa_tpu.models.spatial import SpatialModule as JSpatial
from phoneme_vqa_tpu.models.vit import ViT as JViT

ATOL = RTOL = 1e-4
VOCAB = 512


def _config(**over):
    cfg = dict(_tiny_yaml_config(VOCAB))
    cfg.update(DTYPE="float32", dropout_rate=0.0, **over)
    return cfg


def _batch(b=3, seed=0):
    batch = _make_batch(b, VOCAB, 32, seed=seed)
    batch["ocr_attention_mask"][:, 9:] = 0  # padded OCR tail
    batch["src_attention_mask"][1:, 5:] = 0  # shorter questions
    batch["label_attention_mask"][0, 6:] = 0
    return batch


@pytest.fixture(scope="module")
def pair():
    cfg = _config()
    batch = _batch()
    j_model = j_latr.LaTr(j_latr.LaTr_config().build(cfg))
    model_batch = {k: v[:1] for k, v in batch.items() if not k.startswith("label")}
    params = j_model.init(
        jax.random.PRNGKey(0), model_batch, batch["label_ids"][:1, :-1],
        batch["label_attention_mask"][:1, :-1],
    )["params"]
    params = jax.tree.map(np.asarray, params)
    t_model = t_latr.LaTr(t_latr.LaTr_config().build(cfg), device="cpu").eval()
    bridge.load_flax_params(t_model, params)
    return cfg, batch, j_model, params, t_model


def _tb(batch):
    return t_latr.to_device_batch(batch, "cpu")


def test_teacher_forced_logits_match_flax(pair):
    cfg, batch, j_model, params, t_model = pair
    model_batch = {k: v for k, v in batch.items() if not k.startswith("label")}
    labels, label_mask = batch["label_ids"][:, :-1], batch["label_attention_mask"][:, :-1]
    want = np.asarray(j_model.apply({"params": params}, model_batch, labels, label_mask))
    with torch.no_grad():
        got = t_model(_tb(batch), torch.from_numpy(labels), torch.from_numpy(label_mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("with_scores", [False, True])
def test_greedy_tokens_identical_to_make_generate_fn(pair, with_scores):
    cfg, batch, j_model, params, t_model = pair
    model_batch = {k: v for k, v in batch.items() if not k.startswith("label")}
    want = jax.jit(j_make_generate_fn(j_model, 10, with_scores=with_scores))(params, model_batch)
    got = t_make_generate_fn(t_model, 10, with_scores=with_scores)(_tb(batch))
    if with_scores:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_encode_for_generate_cache_matches_flax(pair):
    cfg, batch, j_model, params, t_model = pair
    model_batch = {k: v for k, v in batch.items() if not k.startswith("label")}
    cache, full_bias, enc_mask = j_model.apply(
        {"params": params}, model_batch, 10, method=j_latr.LaTr.encode_for_generate
    )
    with torch.no_grad():
        t_cache, t_bias, t_mask = t_model.encode_for_generate(_tb(batch), 10)
    assert tuple(t_cache["k"].shape) == cache["k"].shape  # (L, B, H, T, d)
    for name in ("ck", "cv"):
        np.testing.assert_allclose(t_cache[name].numpy(), np.asarray(cache[name]),
                                   atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(t_bias.numpy(), np.asarray(full_bias), atol=1e-6)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(enc_mask))


def test_submodules_match_flax(pair):
    cfg, batch, j_model, params, t_model = pair
    j_cfg = j_latr.LaTr_config().build(cfg)
    t_cfg = t_latr.LaTr_config().build(cfg)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, j_cfg.t5.d_model).astype(np.float32)

    def check(j_module, sub, t_module, *inputs):
        want = np.asarray(j_module.apply({"params": sub}, *(jnp.asarray(i) for i in inputs)))
        bridge.load_flax_params(t_module, sub)
        with torch.no_grad():
            got = t_module(*(torch.from_numpy(i) for i in inputs))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)

    block = params["t5"]["encoder"]["block_0"]
    check(j_t5.RMSNorm(j_cfg.t5.layer_norm_epsilon, jnp.float32), block["ln0"],
          t_t5.RMSNorm(t_cfg.t5.d_model, t_cfg.t5.layer_norm_epsilon, torch.float32), x)
    check(j_t5.T5FFN(j_cfg.t5), block["ffn"], t_t5.T5FFN(t_cfg.t5), x)
    pixels = batch["pixel_values"]
    check(JViT(j_cfg.vit), params["vit"], t_vit.ViT(t_cfg.vit), pixels)
    coords = rng.randint(-5, 1100, (2, 7, 6)).astype(np.int32)  # clipped to [0, 1023]
    check(JSpatial(1024, j_cfg.t5.d_model, jnp.float32), params["spatial"],
          TSpatial(1024, t_cfg.t5.d_model, torch.float32), coords)


def test_relu_ffn_matches_flax():
    j_cfg = j_t5.T5Config(d_model=16, d_ff=24, feed_forward_proj="relu", dtype=jnp.float32)
    x = np.random.RandomState(5).randn(2, 3, 16).astype(np.float32)
    j_ffn = j_t5.T5FFN(j_cfg)
    sub = jax.tree.map(np.asarray, j_ffn.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    t_ffn = t_t5.T5FFN(t_t5.T5Config(d_model=16, d_ff=24, feed_forward_proj="relu",
                                     dtype=torch.float32))
    bridge.load_flax_params(t_ffn, sub)
    t_ffn.eval()  # flax's apply is deterministic: no dropout
    with torch.no_grad():
        got = t_ffn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_ffn.apply({"params": sub}, x)), atol=ATOL,
                               rtol=RTOL)


def test_bridge_accepts_scan_layers_layout(pair):
    cfg, batch, j_model, params, t_model = pair
    stacked = jax.tree.map(np.asarray, stack_block_params(params))
    assert "blocks" in stacked["t5"]["encoder"] and "blocks" in stacked["vit"]
    other = t_latr.LaTr(t_latr.LaTr_config().build(cfg), device="cpu")
    bridge.load_flax_params(other, stacked)
    for name, p in t_model.state_dict().items():
        torch.testing.assert_close(other.state_dict()[name], p, atol=0, rtol=0)


def test_bridge_raises_on_leftover_and_unmapped_leaves(pair):
    cfg, batch, j_model, params, t_model = pair
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray"):
        bridge.flax_to_state_dict(extra, t_model)
    missing = {k: v for k, v in params.items() if k != "spatial"}
    with pytest.raises(KeyError, match="spatial.tables"):
        bridge.flax_to_state_dict(missing, t_model)


def test_default_device_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_latr.build_latr(_config())
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_latr.LaTr(t_latr.LaTr_config().build(_config()))


def test_build_latr_is_seeded():
    a = t_latr.build_latr(_config(), device="cpu", seed=3)
    b = t_latr.build_latr(_config(), device="cpu", seed=3)
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.isfinite(p).all(), name
        torch.testing.assert_close(p, q, atol=0, rtol=0)
