"""The port's SaL slice against the JAX package on the CPU, in f32 at tiny
widths: the SaL kernel's plain version, the 2D position bias, the model,
greedy decoding, the data layer and the serving engine.

Flax initializes the weights; ``phoneme_vqa_torch.models.bridge`` copies them
into the port; the same numpy inputs go through both.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from phoneme_vqa_torch import config as t_config
from phoneme_vqa_torch import train  # noqa: F401  (registers the executors)
from phoneme_vqa_torch.data import adapters as t_adapters
from phoneme_vqa_torch.data import synthetic as t_synthetic
from phoneme_vqa_torch.data.sal import SaLDataset as TSaLDataset
from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.models import latr as t_latr
from phoneme_vqa_torch.models import rel_bias_2d as t_rb
from phoneme_vqa_torch.models import sal as t_sal
from phoneme_vqa_torch.models import t5 as t_t5
from phoneme_vqa_torch.models.generate import make_generate_fn as t_make_generate_fn
from phoneme_vqa_torch.ops import attention as t_attn
from phoneme_vqa_torch.ops import flash_attention as t_flash
from phoneme_vqa_torch.ops import sal_fused_attention as t_sfa
from phoneme_vqa_torch.serving import ServingEngine
from phoneme_vqa_torch.tokenizers.backbone import FallbackSubwordTokenizer as TTok
from phoneme_vqa_torch.utils.registry import EXECUTORS as T_EXECUTORS
from phoneme_vqa_torch.utils.registry import MODEL_CONFIGS as T_MODEL_CONFIGS
from phoneme_vqa_torch.utils.registry import MODELS as T_MODELS
from phoneme_vqa_tpu import registry_setup  # noqa: F401
from phoneme_vqa_tpu.config import get_config
from phoneme_vqa_tpu.data.adapters import textlayout_obj_adapt as j_obj_adapt
from phoneme_vqa_tpu.data.adapters import textlayout_ocr_adapt as j_ocr_adapt
from phoneme_vqa_tpu.data.sal import SaLDataset as JSaLDataset
from phoneme_vqa_tpu.models import rel_bias_2d as j_rb
from phoneme_vqa_tpu.models import sal as j_sal
from phoneme_vqa_tpu.models.generate import make_generate_fn as j_make_generate_fn
from phoneme_vqa_tpu.models.scan_utils import stack_block_params
from phoneme_vqa_tpu.ops import attention as j_attn
from phoneme_vqa_tpu.ops import sal_fused_attention as j_sfa
from phoneme_vqa_tpu.tokenizers.backbone import FallbackSubwordTokenizer as JTok
from phoneme_vqa_tpu.utils.registry import EXECUTORS

from .fixtures import make_sal_fixture, tiny_sal_yaml

ATOL = RTOL = 1e-4
ATTN_TOL = 2e-5  # f32 attention on both sides, sums in another order
VOCAB = 512
LQ, LOCR, LOBJ, LA = 6, 10, 5, 5
CFG = {
    "t5_vocab_size": VOCAB, "d_model": 32, "d_kv": 8, "num_heads": 4, "d_ff": 64,
    "num_encoder_layers": 2, "num_t5_decoder_layers": 2, "dropout_rate": 0.0,
    "DTYPE": "float32", "ocr_hidden": 16, "obj_hidden": 8,
    "max_q_length": LQ, "max_ocr_length": LOCR,
}


# -- the kernel's plain version ------------------------------------------------


def _attn_inputs(b, h, l, d, seed=0, fully_masked_row=False):
    """The inputs of tests/test_sal_fused_attention.py: f32 tables, a question
    block and a tail of sentinel cells, a masked tail in row 1."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, l, d).astype(np.float32) for _ in range(3))
    bias1d = (rng.randn(h, l, l) * 0.5).astype(np.float32)
    cb = np.zeros((h, 122, 122), np.float32)
    cb[:, :121, :121] = (rng.randn(h, 121, 121) * 0.3).astype(np.float32)
    cell = rng.randint(0, 121, (b, l)).astype(np.int32)
    cell[:, : min(5, l // 3)] = t_sfa.SENTINEL
    cell[:, l - max(1, l // 8):] = t_sfa.SENTINEL
    mask = np.ones((b, l), np.int32)
    if b > 1:
        mask[1, (3 * l) // 4:] = 0
    if fully_masked_row:
        mask[-1] = 0
    return q, k, v, bias1d, cb, cell, mask


@pytest.mark.parametrize("shape", [(3, 4, 37, 16), (2, 2, 336, 64), (1, 3, 8, 24)])
def test_plain_version_matches_jax_pallas_kernel(shape):
    args = _attn_inputs(*shape)
    want = np.asarray(j_sfa.sal_fused_attention(*map(jnp.asarray, args), interpret=True))
    got = t_sfa.sal_reference_attention(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("shape", [(3, 4, 37, 16), (2, 2, 336, 64), (2, 3, 8, 24)])
def test_plain_version_matches_jax_reference_with_a_fully_masked_row(shape):
    args = _attn_inputs(*shape, seed=1, fully_masked_row=True)
    want = np.asarray(j_sfa.sal_reference_attention(*map(jnp.asarray, args)))
    got = t_sfa.sal_reference_attention(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, atol=ATTN_TOL, rtol=ATTN_TOL)


def test_materialize_clamps_cells_and_equals_jax():
    _, _, _, bias1d, cb, cell, _ = _attn_inputs(2, 3, 19, 8, seed=2)
    cell[0, 3] = 200  # past the sentinel: reads the sentinel row and column
    want = np.asarray(j_sfa.materialize_sal_bias(jnp.asarray(bias1d), jnp.asarray(cb),
                                                 jnp.asarray(cell)))
    got = t_sfa.FusedSalBias(*map(torch.from_numpy, (bias1d, cb, cell))).materialize()
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_wrapper_and_dispatch_take_the_plain_version():
    q, k, v, bias1d, cb, cell, mask = map(torch.from_numpy, _attn_inputs(2, 3, 21, 8, seed=3))
    want = t_sfa.sal_reference_attention(q, k, v, bias1d, cb, cell, mask)
    before = (t_sfa.LAUNCHES, t_flash.LAUNCHES)
    torch.testing.assert_close(t_sfa.sal_fused_attention(q, k, v, bias1d, cb, cell, mask), want)
    fused = t_sfa.FusedSalBias(bias1d, cb, cell)
    torch.testing.assert_close(
        t_attn.dot_product_attention(q, k, v, fused, key_mask=mask.bool()), want)
    # no key mask: every key attends
    torch.testing.assert_close(
        t_attn.dot_product_attention(q, k, v, fused),
        t_sfa.sal_reference_attention(q, k, v, bias1d, cb, cell, None))
    assert (t_sfa.LAUNCHES, t_flash.LAUNCHES) == before  # no kernel on the CPU


# -- the 2D position bias ------------------------------------------------------


def test_grid_distance_table_equal():
    got, want = t_rb._grid_distance_table(), j_rb._grid_distance_table()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _ocr_coords(b, l_ocr, seed=0):
    coords = np.random.RandomState(seed).uniform(0.0, 1.0, (b, l_ocr, 4)).astype(np.float32)
    coords[:, -2:] = 0.0  # PAD boxes: cell 0
    coords[:, -3] = 0.9999  # the EOS box: cell 120
    coords[0, 0] = 1.0  # a centre on the far edge, clipped into the grid
    return coords


def test_position_bias_factors_and_materialization_equal_flax():
    h, b, l_ocr, seq, max_ques = 4, 2, 7, 16, 4
    coords = _ocr_coords(b, l_ocr)
    j_mod = j_rb.Sal2DPositionBias(num_heads=h)
    params = j_mod.init(jax.random.PRNGKey(0), seq, jnp.asarray(coords), max_ques, l_ocr)
    want = j_mod.apply(params, seq, jnp.asarray(coords), max_ques, l_ocr)
    t_mod = t_rb.Sal2DPositionBias(h)
    bridge.load_flax_params(t_mod, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = t_mod(seq, torch.from_numpy(coords), max_ques, l_ocr)
    for name in ("bias1d", "cell_bias", "cell"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    cells = got.cell.numpy()
    assert (cells[:, :max_ques] == t_sfa.SENTINEL).all()
    assert (cells[:, max_ques + l_ocr:] == t_sfa.SENTINEL).all()
    assert (cells[:, max_ques + l_ocr - 2: max_ques + l_ocr] == 0).all()  # PAD boxes
    assert (cells[:, max_ques + l_ocr - 3] == 120).all()  # EOS box
    np.testing.assert_array_equal(got.materialize().numpy(), np.asarray(want.materialize()))


def test_position_bias_rejects_augmentation():
    with pytest.raises(NotImplementedError):
        t_rb.Sal2DPositionBias(4, augmentation=True)


# -- the model -----------------------------------------------------------------


def _batch(b=3, seed=0):
    rng = np.random.RandomState(seed)
    ints = lambda *s: rng.randint(3, VOCAB, s).astype(np.int32)
    batch = {
        "input_ids": ints(b, LQ),
        "src_attention_mask": np.ones((b, LQ), np.int32),
        "tokenized_ocr": ints(b, LOCR),
        "ocr_attention_mask": np.ones((b, LOCR), np.int32),
        "ocr_coordinates": _ocr_coords(b, LOCR, seed),
        "ocr_features": rng.randn(b, LOCR, CFG["ocr_hidden"]).astype(np.float32),
        "tokenized_obj": ints(b, LOBJ),
        "obj_attention_mask": np.ones((b, LOBJ), np.int32),
        "obj_coordinates": rng.uniform(0, 1, (b, LOBJ, 4)).astype(np.float32),
        "obj_features": rng.randn(b, LOBJ, CFG["obj_hidden"]).astype(np.float32),
        "label_ids": ints(b, LA),
        "label_attention_mask": np.ones((b, LA), np.int32),
    }
    batch["src_attention_mask"][1:, 4:] = 0  # shorter questions
    batch["ocr_attention_mask"][:, -2:] = 0  # the PAD tail of the OCR stream
    batch["obj_attention_mask"][0, 3:] = 0
    batch["label_attention_mask"][0, 3:] = 0
    return batch


def _model_batch(batch):
    return {k: v for k, v in batch.items() if not k.startswith("label")}


@pytest.fixture(scope="module")
def pair():
    batch = _batch()
    j_model = j_sal.SaL(j_sal.SaL_config().build(CFG))
    params = j_model.init(
        jax.random.PRNGKey(0), {k: v[:1] for k, v in _model_batch(batch).items()},
        batch["label_ids"][:1], batch["label_attention_mask"][:1],
    )["params"]
    params = jax.tree.map(np.asarray, params)
    t_model = t_sal.SaL(t_sal.SaL_config().build(CFG), device="cpu").eval()
    bridge.load_flax_params(t_model, params)
    return batch, j_model, params, t_model


def _tb(batch):
    return t_latr.to_device_batch(batch, "cpu", t_sal.BATCH_KEYS)


def test_registry_and_config_match_jax():
    assert T_MODELS.get("SaL") is t_sal.SaL
    t_cfg = T_MODEL_CONFIGS.get("SaL_config")().build(CFG, 600)
    j_cfg = j_sal.SaL_config().build(CFG, 600)
    for field in ("ocr_hidden", "obj_hidden", "max_ques", "max_ocr"):
        assert getattr(t_cfg, field) == getattr(j_cfg, field), field
    assert t_cfg.t5.vocab_size == j_cfg.t5.vocab_size == 600


def test_parameter_set_equals_the_flax_tree(pair):
    batch, j_model, params, t_model = pair
    assert "rel_bias" not in params["t5"]["encoder"]
    assert t_model.t5.encoder.rel_bias is None
    assert set(t_model.state_dict()) == set(bridge.flax_to_state_dict(params, t_model))


def test_teacher_forced_logits_match_flax(pair):
    batch, j_model, params, t_model = pair
    want = np.asarray(j_model.apply({"params": params}, _model_batch(batch),
                                    batch["label_ids"], batch["label_attention_mask"]))
    with torch.no_grad():
        got = t_model(_tb(batch), torch.from_numpy(batch["label_ids"]),
                      torch.from_numpy(batch["label_attention_mask"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_encoder_without_rel_bias_needs_a_position_bias(pair):
    batch, j_model, params, t_model = pair
    with torch.no_grad(), pytest.raises(ValueError, match="position_bias"):
        t_model.t5.encode(torch.zeros(1, 4, CFG["d_model"]))


@pytest.mark.parametrize("jax_path", ["materialized", "pallas_interpret"])
def test_greedy_tokens_identical_to_jax(pair, jax_path, monkeypatch):
    batch, j_model, params, t_model = pair
    gen = j_make_generate_fn(j_model, 8)
    if jax_path == "materialized":
        want = jax.jit(gen)(params, _model_batch(batch))
    else:
        # both switches: the fused branch needs SAL_FUSED and (a TPU or
        # interpret mode); count the Pallas calls to show it was reached
        calls = []
        kernel = j_sfa.sal_fused_attention
        monkeypatch.setattr(j_sfa, "sal_fused_attention",
                            lambda *a, **kw: calls.append(1) or kernel(*a, **kw))
        saved = (j_attn.SAL_FUSED_ENABLED, j_sfa.INTERPRET)
        j_attn.enable_sal_fused(True)
        j_sfa.set_interpret(True)
        try:
            want = gen(params, _model_batch(batch))  # unjitted: the interpreter inside
        finally:
            j_attn.enable_sal_fused(saved[0])
            j_sfa.set_interpret(saved[1])
        assert len(calls) == CFG["num_encoder_layers"]
    got = t_make_generate_fn(t_model, 8)(_tb(batch))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bridge_is_strict_on_the_sal_tree_in_both_layouts(pair):
    batch, j_model, params, t_model = pair
    stacked = jax.tree.map(np.asarray, stack_block_params(params))
    assert "blocks" in stacked["t5"]["encoder"]
    other = t_sal.SaL(t_sal.SaL_config().build(CFG), device="cpu")
    bridge.load_flax_params(other, stacked)
    for name, p in t_model.state_dict().items():
        torch.testing.assert_close(other.state_dict()[name], p, atol=0, rtol=0)
    for tree in (params, stacked):
        with pytest.raises(KeyError, match="stray"):
            bridge.flax_to_state_dict(dict(tree, stray={"bias": np.zeros(2, np.float32)}),
                                      t_model)
        with pytest.raises(KeyError, match="rel2d.scp.weight"):
            bridge.flax_to_state_dict(
                dict(tree, rel2d={"rel1d": tree["rel2d"]["rel1d"]}), t_model)
    # a LaTr-style encoder table has no place in the SaL model
    extra = dict(params, t5=dict(params["t5"], encoder=dict(
        params["t5"]["encoder"], rel_bias={"rel_embedding": np.zeros((32, 4), np.float32)})))
    with pytest.raises(KeyError, match="rel_bias"):
        bridge.flax_to_state_dict(extra, t_model)


def test_default_device_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_sal.build_sal(CFG)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_sal.SaL(t_sal.SaL_config().build(CFG))


def test_build_sal_is_seeded_with_unit_norms():
    a = t_sal.build_sal(CFG, device="cpu", seed=3)
    b = t_sal.build_sal(CFG, device="cpu", seed=3)
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.isfinite(p).all(), name
        torch.testing.assert_close(p, q, atol=0, rtol=0)
    norms = [n for n, m in a.named_modules() if isinstance(m, t_t5.RMSNorm)]
    assert "ocr_norm" in norms and "obj_norm" in norms
    for n in norms:
        assert (a.get_submodule(n).weight == 1).all(), n
    assert a.ocr_feature_projector.bias.abs().max() == 0
    assert a.ocr_feature_projector.weight.std() > 0


# -- data layer and serving ----------------------------------------------------


@pytest.fixture(scope="module")
def fixture_paths(tmp_path_factory):
    return make_sal_fixture(tmp_path_factory.mktemp("sal"))


def test_synthetic_fixture_files_identical(fixture_paths, tmp_path):
    mine = t_synthetic.make_sal_fixture(tmp_path)
    for split in ("train", "val", "predict"):
        with open(mine[split], encoding="utf-8") as a, \
                open(fixture_paths[split], encoding="utf-8") as b:
            assert a.read() == b.read()
    for sub in ("ocr_features", "obj_features"):
        assert sorted(os.listdir(mine[sub])) == sorted(os.listdir(fixture_paths[sub]))
        for name in os.listdir(mine[sub]):
            a = np.load(os.path.join(mine[sub], name), allow_pickle=True).tolist()
            b = np.load(os.path.join(fixture_paths[sub], name), allow_pickle=True).tolist()
            assert sorted(a) == sorted(b)
            for key in a:
                np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))


@pytest.mark.parametrize("scale", [1, 1000])
def test_obj_adapter_equals_the_jax_frame(fixture_paths, scale):
    want = j_obj_adapt(fixture_paths["obj_features"], h_scale=scale, w_scale=scale)
    got = t_adapters.textlayout_obj_adapt(fixture_paths["obj_features"], h_scale=scale,
                                          w_scale=scale)
    assert sorted(got) == sorted(want["image_id"])
    for _, row in want.iterrows():
        labels, boxes = got[row["image_id"]]
        assert labels == list(row["obj_labels"])
        np.testing.assert_array_equal(np.asarray(boxes), np.asarray(row["obj_bboxes"]))


@pytest.mark.parametrize(
    "max_ocr_element,max_ocr_length,max_obj_element,max_obj_length",
    [(6, 12, 4, 8), (2, 5, 1, 3), (32, 128, 32, 128)],
)
def test_sal_dataset_element_equal(fixture_paths, max_ocr_element, max_ocr_length,
                                   max_obj_element, max_obj_length):
    kw = dict(ocr_hidden=512, obj_hidden=64, max_ocr_element=max_ocr_element,
              max_ocr_length=max_ocr_length, max_obj_element=max_obj_element,
              max_obj_length=max_obj_length, max_input_length=8, max_output_length=10)
    paths = (fixture_paths["ocr_features"], fixture_paths["obj_features"])
    qa = pd.read_csv(fixture_paths["train"])[["image_id", "question", "answer", "filename"]]
    # a row whose image only the OCR store holds: the inner join drops it
    qa = pd.concat([qa, qa.iloc[:1].assign(image_id=7.0)], ignore_index=True)
    want = JSaLDataset(qa, j_ocr_adapt(paths[0], 1, 1), j_obj_adapt(paths[1], 1, 1),
                       JTok(512), *paths, **kw).dataset
    ocr_store = t_adapters.textlayout_ocr_adapt(paths[0], 1, 1)
    ocr_store[7.0] = ocr_store[0.0]
    rows = t_synthetic.read_qa_csv(fixture_paths["train"]) + [
        dict(t_synthetic.read_qa_csv(fixture_paths["train"])[0], image_id=7.0)]
    got = TSaLDataset(rows, ocr_store, t_adapters.textlayout_obj_adapt(paths[1], 1, 1),
                      TTok(512), *paths, **kw).dataset
    assert len(got) == len(want) == 12
    assert sorted(got.arrays) == sorted(want.arrays)
    for name, array in want.arrays.items():
        assert got.arrays[name].dtype == array.dtype, name
        np.testing.assert_array_equal(got.arrays[name], array, err_msg=name)
    assert got.image_ids == list(want.image_ids)
    idx = np.arange(len(want))[::-1]
    for name in ("ocr_features", "obj_features"):
        np.testing.assert_array_equal(got.gather(idx)[name], want.gather(idx)[name],
                                      err_msg=name)


def test_serving_engine_answers_equal_jax_executor_infer(fixture_paths, tmp_path):
    yaml_path = tiny_sal_yaml(fixture_paths, str(tmp_path / "ck"), SAVE=False,
                              max_eval_length=10)
    config = get_config(yaml_path)
    ex = EXECUTORS.get(config.EXECUTOR)(config, mode="eval")
    want = ex.infer(ex.val_data, 4, 10)
    params = jax.tree.map(np.asarray, ex._inference_params())

    # the port's executor in eval mode: its offline tokenizer, which decodes
    # only pieces it has encoded, has encoded the val answers as the JAX
    # executor's has
    t_ex = T_EXECUTORS.get(config.EXECUTOR)(t_config.Config(dict(config)), "eval",
                                            device="cpu")
    t_ex.load_params(bridge.flax_to_state_dict(params, t_ex.model))
    ocr_store, obj_store = t_ex.serve_frames
    rows = t_synthetic.read_qa_csv(config.qa_val_path)
    requests = [(r["image_id"], r["question"]) for r in rows]
    with ServingEngine(t_ex, ocr_store, obj_store, batch_size=4, max_wait_ms=20,
                       max_answer_length=10) as engine:
        futures = [engine.submit(i, q) for i, q in requests]
        got = [f.result(timeout=120) for f in futures]  # one full batch and one padded
    assert got == want
    # an image that only the OCR store holds
    fewer = {k: v for k, v in obj_store.items() if k != requests[0][0]}
    with ServingEngine(t_ex, ocr_store, fewer, batch_size=4, warmup=False) as other:
        with pytest.raises(KeyError, match="object"):
            other.submit(*requests[0])
