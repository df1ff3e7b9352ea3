"""The port's data layer, decode loop and serving engine against the JAX
package on the CPU, and the port's import isolation."""

import dataclasses
import os
import subprocess
import sys

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
from phoneme_vqa_torch.data.latr import LaTrDataset as TLaTrDataset
from phoneme_vqa_torch.decode import greedy as t_greedy
from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.models import latr as t_latr
from phoneme_vqa_torch.serving import ServingEngine
from phoneme_vqa_torch.tokenizers import backbone as t_backbone
from phoneme_vqa_torch.tokenizers.backbone import FallbackSubwordTokenizer as TTok
from phoneme_vqa_torch.utils.registry import MODEL_CONFIGS as T_MODEL_CONFIGS
from phoneme_vqa_torch.utils.registry import EXECUTORS as T_EXECUTORS
from phoneme_vqa_torch.utils.registry import MODELS as T_MODELS
from phoneme_vqa_tpu import registry_setup  # noqa: F401
from phoneme_vqa_tpu.config import get_config
from phoneme_vqa_tpu.data.adapters import textlayout_ocr_adapt as j_ocr_adapt
from phoneme_vqa_tpu.data.latr import LaTrDataset as JLaTrDataset
from phoneme_vqa_tpu.decode import greedy as j_greedy
from phoneme_vqa_tpu.models import latr as j_latr
from phoneme_vqa_tpu.tokenizers import backbone as j_backbone
from phoneme_vqa_tpu.tokenizers.backbone import FallbackSubwordTokenizer as JTok
from phoneme_vqa_tpu.utils.registry import EXECUTORS

from .fixtures import make_latr_fixture, tiny_latr_yaml

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fixture_paths(tmp_path_factory):
    return make_latr_fixture(tmp_path_factory.mktemp("latr"))


def test_tokenizer_ids_identical():
    texts = ["<pad> quán phở hà nội", "số điện thoại là gì </s>", "", "abcdefghij k"]
    j, t = JTok(512), TTok(512)
    for text in texts:
        assert t(text, padding="max_length", max_length=12, truncation=True) == \
            j(text, padding="max_length", max_length=12, truncation=True)
    words = ["quán", "phở", "nguyễn"]
    for split in (False, True):
        assert t(words, is_split_into_words=split, add_special_tokens=False) == \
            j(words, is_split_into_words=split, add_special_tokens=False)
    ids = t("quán phở hà nội")["input_ids"]
    j("quán phở hà nội")
    assert t.batch_decode([ids]) == j.batch_decode([ids])


def test_backbone_tokenizer_loaders_agree():
    name = "VietAI/vit5-base"  # the LaTr presets' backbone_name
    j, t = j_backbone.load_backbone_tokenizer(name, 512), t_backbone.load_backbone_tokenizer(name, 512)
    assert type(t).__name__ == type(j).__name__
    text = "<pad> quán phở hà nội"
    assert t(text)["input_ids"] == j(text)["input_ids"]


@pytest.mark.parametrize("preset", ["latr.yaml", "customizedlatr.yaml", "sal.yaml"])
def test_config_presets_and_model_dims_match_jax(preset):
    path = os.path.join(REPO_ROOT, "configs", preset)
    want, got = get_config(path), t_config.get_config(path)
    assert isinstance(got, t_config.Config)
    assert {k: v for k, v in got.items() if k != "DEVICE"} == \
        {k: v for k, v in want.items() if k != "DEVICE"}
    assert t_config.Config({"MESH": {"data": -1}}).MESH.data == -1  # a plain dict will do
    if got.MODEL_CLASS != "LaTr":
        return
    assert T_MODELS.get("LaTr") is t_latr.LaTr
    t_cfg = T_MODEL_CONFIGS.get(got.MODEL_MOD_CONFIG_CLASS)().build(got)
    j_cfg = j_latr.LaTr_config().build(want)
    for part in ("t5", "vit"):
        t_part, j_part = getattr(t_cfg, part), getattr(j_cfg, part)
        for field in dataclasses.fields(t_part):
            if field.name != "dtype":
                assert getattr(t_part, field.name) == getattr(j_part, field.name), field.name
    assert t_cfg.max_2d_position_embeddings == j_cfg.max_2d_position_embeddings


def test_synthetic_fixture_files_identical(fixture_paths, tmp_path):
    mine = t_synthetic.make_latr_fixture(tmp_path)
    for split in ("train", "val", "predict"):
        with open(mine[split], encoding="utf-8") as a, \
                open(fixture_paths[split], encoding="utf-8") as b:
            assert a.read() == b.read()
    for sub in ("ocr", "img"):
        assert sorted(os.listdir(mine[sub])) == sorted(os.listdir(fixture_paths[sub]))
        for name in os.listdir(mine[sub]):
            a = np.load(os.path.join(mine[sub], name), allow_pickle=True).tolist()
            b = np.load(os.path.join(fixture_paths[sub], name), allow_pickle=True).tolist()
            for key in a:
                np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))


@pytest.mark.parametrize("max_ocr_element,max_ocr_length", [(8, 12), (2, 5), (50, 100)])
def test_featurized_arrays_element_equal(fixture_paths, max_ocr_element, max_ocr_length):
    kw = dict(max_ocr_element=max_ocr_element, max_ocr_length=max_ocr_length,
              max_input_length=8, max_output_length=10)
    qa = pd.read_csv(fixture_paths["train"])[["image_id", "question", "answer", "filename"]]
    want = JLaTrDataset(qa, j_ocr_adapt(fixture_paths["ocr"]), JTok(512),
                        fixture_paths["img"], **kw).dataset
    got = TLaTrDataset(t_synthetic.read_qa_csv(fixture_paths["train"]),
                       t_adapters.textlayout_ocr_adapt(fixture_paths["ocr"]), TTok(512),
                       fixture_paths["img"], **kw).dataset
    assert sorted(got.arrays) == sorted(want.arrays)
    for name, array in want.arrays.items():
        assert got.arrays[name].dtype == array.dtype, name
        np.testing.assert_array_equal(got.arrays[name], array, err_msg=name)
    assert got.image_ids == want.image_ids
    idx = np.arange(len(want))
    np.testing.assert_array_equal(got.gather(idx)["pixel_values"], want.gather(idx)["pixel_values"])


@pytest.mark.parametrize("with_scores", [False, True])
def test_greedy_decode_semantics_match_jax(with_scores):
    """A scripted step function (EOS at different steps per row, one row
    never ends) through both loops: bos first, pads after EOS, scores."""
    b, v, t = 4, 11, 8
    script = np.random.RandomState(0).randn(t, b, v).astype(np.float32)
    script[2, 0, 1] = 50.0  # row 0 emits EOS at step 2
    script[0, 2, 1] = 50.0  # row 2 at step 0
    script[4, 1, 1] = 50.0  # row 1 at step 4; row 3 never
    j_step = lambda tok, cache, i: (jnp.asarray(script)[i] + tok[:, None] * 0.01, cache)
    t_step = lambda tok, cache, i: (torch.from_numpy(script[i]) + tok[:, None] * 0.01, cache)
    want = j_greedy.greedy_decode(j_step, (), b, t, 0, 1, 0, with_scores=with_scores)
    got = t_greedy.greedy_decode(t_step, (), b, t, 0, 1, 0, "cpu", with_scores=with_scores)
    if with_scores:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serving_engine_answers_equal_jax_executor_infer(fixture_paths, tmp_path):
    yaml_path = tiny_latr_yaml(
        fixture_paths, str(tmp_path / "ck"), NUM_EPOCHS=1, SAVE=False, max_eval_length=10
    )
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
    rows = t_synthetic.read_qa_csv(config.qa_val_path)
    requests = [(r["image_id"], r["question"]) for r in rows]
    with ServingEngine(t_ex, *t_ex.serve_frames, batch_size=4, max_wait_ms=20,
                       max_answer_length=10) as engine:
        futures = [engine.submit(i, q) for i, q in requests]
        got = [f.result(timeout=120) for f in futures]  # one full batch and one padded
    assert got == want
    assert len(got) == len(requests)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import phoneme_vqa_torch\n"
        "for m in pkgutil.walk_packages(phoneme_vqa_torch.__path__, 'phoneme_vqa_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'phoneme_vqa_tpu', 'pandas', 'yaml', 'transformers')]\n"
        "assert not bad, bad\n"
        "print(' '.join(n for n in sys.modules if n.startswith('phoneme_vqa_torch.')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    imported = set(out.stdout.split())
    assert len(imported) >= 30  # every submodule was imported
    for name in ("ops._build", "ops.flash_attention", "ops.sal_fused_attention",
                 "models.rel_bias_2d", "models.sal", "data.sal", "serving.engine"):
        assert f"phoneme_vqa_torch.{name}" in imported, name
