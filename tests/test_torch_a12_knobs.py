"""The last four A12 knobs in the port, on the CPU at tiny widths:

* ``FEATURE_CACHE`` (``phoneme_vqa_torch/data/feature_cache.py``): keys by
  content, a round trip, a corrupt entry rebuilt, the tokenizer tag
  following the vocabulary; a cache hit gives arrays equal to the JAX
  package's LaTr and SaL datasets (and the same lazy features); the
  adapted-frame cache; the CLI;
* ``NUMWORKERS`` (``data/loader.py: prefetch``): the same batches and the
  same epoch losses; where the producer raises, JAX's prefetch ends the
  epoch quietly and the port's raises (ROADMAP C);
* ``PROFILE_DIR``: a Chrome trace of the first epoch on the CPU;
* ``DEBUG_NANS``: a NaN weight raises ``FloatingPointError`` in the JAX
  executor and in the port, which names the module; a NaN that only the
  backward makes names the autograd node;
* ``UNPORTED`` holds only ``SCAN_LAYERS`` and ``FLASH``.
"""

import json
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from phoneme_vqa_torch import config as t_config
from phoneme_vqa_torch import run as t_run
from phoneme_vqa_torch import train  # noqa: F401  (registers the executors)
from phoneme_vqa_torch.data import adapters as t_adapters
from phoneme_vqa_torch.data import feature_cache as fc
from phoneme_vqa_torch.data import loader as t_loader
from phoneme_vqa_torch.data import synthetic as t_synthetic
from phoneme_vqa_torch.data.latr import LaTrDataset as TLaTrDataset
from phoneme_vqa_torch.data.sal import SaLDataset as TSaLDataset
from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.tokenizers.backbone import FallbackSubwordTokenizer as TTok
from phoneme_vqa_torch.train.base_executor import UNPORTED
from phoneme_vqa_torch.utils import profiling
from phoneme_vqa_torch.utils.registry import EXECUTORS as T_EXECUTORS
from phoneme_vqa_tpu import registry_setup  # noqa: F401
from phoneme_vqa_tpu.config import get_config
from phoneme_vqa_tpu.data import loader as j_loader
from phoneme_vqa_tpu.data.adapters import textlayout_obj_adapt as j_obj_adapt
from phoneme_vqa_tpu.data.adapters import textlayout_ocr_adapt as j_ocr_adapt
from phoneme_vqa_tpu.data.latr import LaTrDataset as JLaTrDataset
from phoneme_vqa_tpu.data.sal import SaLDataset as JSaLDataset
from phoneme_vqa_tpu.tokenizers.backbone import FallbackSubwordTokenizer as JTok
from phoneme_vqa_tpu.utils.registry import EXECUTORS

from .fixtures import make_latr_fixture, make_sal_fixture, tiny_latr_yaml


@pytest.fixture(scope="module")
def latr_paths(tmp_path_factory):
    return make_latr_fixture(tmp_path_factory.mktemp("a12_latr"))


@pytest.fixture(scope="module")
def sal_paths(tmp_path_factory):
    return make_sal_fixture(tmp_path_factory.mktemp("a12_sal"))


def _qa_frame(path):
    return pd.read_csv(path)[["image_id", "question", "answer", "filename"]]


# -- FEATURE_CACHE ----------------------------------------------------------------------

def test_rows_fingerprint_is_content_keyed():
    rows = [{"image_id": 1.0, "question": "q", "answer": "a", "texts": ["x"],
             "bboxes": [[0.1, 0.2, 0.3, 0.4]]}]
    same = [dict(rows[0], bboxes=[list(np.float64([0.1, 0.2, 0.3, 0.4]))])]
    assert fc.rows_fingerprint(rows) == fc.rows_fingerprint(same)
    assert fc.rows_fingerprint(rows) != fc.rows_fingerprint([dict(rows[0], answer="b")])
    assert fc.rows_fingerprint(rows + same) != fc.rows_fingerprint(rows)


def test_get_or_build_round_trip(tmp_path):
    calls = []

    def build():
        calls.append(1)
        return {"x": np.arange(6, dtype=np.int32).reshape(3, 2)}, [1.0, 2.0, 3.0]

    parts = {"cls": "T", "n": 3}
    first = fc.get_or_build(str(tmp_path), parts, build)
    again = fc.get_or_build(str(tmp_path), parts, build)
    assert len(calls) == 1
    np.testing.assert_array_equal(again[0]["x"], first[0]["x"])
    assert isinstance(again[0]["x"], np.memmap) and again[1] == [1.0, 2.0, 3.0]
    fc.get_or_build(str(tmp_path), dict(parts, n=4), build)  # another key: a miss
    assert len(calls) == 2
    assert fc.get_or_build(None, parts, build)[1] == [1.0, 2.0, 3.0] and len(calls) == 3


def test_corrupt_entry_rebuilds(tmp_path):
    calls = []

    def build():
        calls.append(1)
        return {"x": np.ones(4, np.float32)}, None

    fc.get_or_build(str(tmp_path), {"k": 1}, build)
    entry = next(d for d in os.listdir(tmp_path) if not d.startswith("."))
    with open(tmp_path / entry / "x.npy", "wb") as f:
        f.write(b"not an array")
    arrays, _ = fc.get_or_build(str(tmp_path), {"k": 1}, build)
    assert len(calls) == 2
    np.testing.assert_array_equal(arrays["x"], np.ones(4, np.float32))
    arrays, _ = fc.get_or_build(str(tmp_path), {"k": 1}, build)  # the rebuilt entry reads
    assert len(calls) == 2


def test_tokenizer_tag_follows_the_vocab():
    class Vocab:
        def __init__(self, vocab):
            self._vocab = vocab

        def get_vocab(self):
            return self._vocab

    assert fc.tokenizer_tag(Vocab({"a": 1})) == fc.tokenizer_tag(Vocab({"a": 1}))
    assert fc.tokenizer_tag(Vocab({"a": 1})) != fc.tokenizer_tag(Vocab({"a": 2}))
    assert fc.tokenizer_tag(TTok(512)) != fc.tokenizer_tag(TTok(513))


def test_latr_cache_hit_equals_the_jax_dataset(latr_paths, tmp_path):
    kw = dict(max_ocr_element=8, max_ocr_length=12, max_input_length=8, max_output_length=10)
    want = JLaTrDataset(_qa_frame(latr_paths["train"]), j_ocr_adapt(latr_paths["ocr"]),
                        JTok(512), latr_paths["img"], **kw).dataset
    rows = t_synthetic.read_qa_csv(latr_paths["train"])
    store = t_adapters.textlayout_ocr_adapt(latr_paths["ocr"])
    cache = str(tmp_path / "fc")
    for _ in range(2):  # a miss, then a hit
        got = TLaTrDataset(rows, store, TTok(512), latr_paths["img"], cache_dir=cache,
                           **kw).dataset
    assert all(isinstance(a, np.memmap) for a in got.arrays.values())
    assert sorted(got.arrays) == sorted(want.arrays)
    for name, array in want.arrays.items():
        np.testing.assert_array_equal(got.arrays[name], array, err_msg=name)
    assert got.image_ids == want.image_ids
    idx = np.arange(len(want))
    np.testing.assert_array_equal(got.gather(idx)["pixel_values"],
                                  want.gather(idx)["pixel_values"])
    assert len([d for d in os.listdir(cache) if not d.startswith(".")]) == 1
    # another answer encoder's tag is another entry
    TLaTrDataset(rows, store, TTok(512), latr_paths["img"], cache_dir=cache, cache_tag="x", **kw)
    assert len([d for d in os.listdir(cache) if not d.startswith(".")]) == 2


def test_sal_cache_hit_equals_the_jax_dataset(sal_paths, tmp_path):
    kw = dict(ocr_hidden=512, obj_hidden=64, max_ocr_element=6, max_ocr_length=12,
              max_obj_element=4, max_obj_length=8, max_input_length=8, max_output_length=10)
    want = JSaLDataset(_qa_frame(sal_paths["train"]),
                       j_ocr_adapt(sal_paths["ocr_features"], h_scale=1, w_scale=1),
                       j_obj_adapt(sal_paths["obj_features"], h_scale=1, w_scale=1),
                       JTok(512), sal_paths["ocr_features"], sal_paths["obj_features"], **kw)
    cache = str(tmp_path / "fc")
    stores = (t_adapters.textlayout_ocr_adapt(sal_paths["ocr_features"], 1, 1, cache),
              t_adapters.textlayout_obj_adapt(sal_paths["obj_features"], 1, 1, cache))
    for _ in range(2):
        got = TSaLDataset(t_synthetic.read_qa_csv(sal_paths["train"]), *stores, TTok(512),
                          sal_paths["ocr_features"], sal_paths["obj_features"],
                          cache_dir=cache, **kw)
    for name, array in want.dataset.arrays.items():
        np.testing.assert_array_equal(got.dataset.arrays[name], array, err_msg=name)
    idx = np.arange(len(want.dataset))
    for name in ("ocr_features", "obj_features"):
        np.testing.assert_array_equal(got.dataset.gather(idx)[name],
                                      want.dataset.gather(idx)[name])


def test_adapted_frame_cache(sal_paths, tmp_path, monkeypatch):
    cache = str(tmp_path / "fc")
    plain = t_adapters.textlayout_ocr_adapt(sal_paths["ocr_features"], 1, 1)
    miss = t_adapters.textlayout_ocr_adapt(sal_paths["ocr_features"], 1, 1, cache)
    monkeypatch.setattr(t_adapters, "_load_npy_dict", lambda path: 1 / 0)  # a hit reads none
    hit = t_adapters.textlayout_ocr_adapt(sal_paths["ocr_features"], 1, 1, cache)
    assert plain == miss == hit
    entries = [f for f in os.listdir(cache) if f.startswith("adapt_")]
    assert len(entries) == 1
    # the JAX package's adapted frame holds the same words and boxes
    frame = j_ocr_adapt(sal_paths["ocr_features"], h_scale=1, w_scale=1)
    for _, row in frame.iterrows():
        texts, boxes = hit[float(row["image_id"])]
        assert list(row["texts"]) == texts
        np.testing.assert_array_equal(np.asarray(row["bboxes"]), np.asarray(boxes))
    with pytest.raises(ZeroDivisionError):  # other scales: another entry
        t_adapters.textlayout_ocr_adapt(sal_paths["ocr_features"], 1000, 1000, cache)


def test_knobs_through_the_cli(latr_paths, tmp_path):
    """``python -m phoneme_vqa_torch.run`` with FEATURE_CACHE, NUMWORKERS and
    PROFILE_DIR: train writes the cache and a trace and trains the weights
    of a run without them bit for bit; predict hits the cache. (The offline
    fallback tokenizer decodes only pieces it has encoded, so a predict
    that hits the cache decodes the same ids to other strings, as in the
    JAX package: ROADMAP C.)"""
    cache, prof = str(tmp_path / "fc"), str(tmp_path / "prof")

    def run(name, mode, **over):
        cfg = get_config(tiny_latr_yaml(latr_paths, str(tmp_path / name), NUM_EPOCHS=1, **over))
        path = str(tmp_path / f"{name}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(dict(cfg), f)
        return t_run.main(["--config-file", path, "--mode", mode, "--device", "cpu"])

    knobs = dict(FEATURE_CACHE=cache, NUMWORKERS=2, PROFILE_DIR=prof)
    assert run("on", "train", **knobs) == run("off", "train")
    for ckpt in ("best_ckp", "last_ckp"):
        on = torch.load(tmp_path / "on" / ckpt, weights_only=True)["params"]
        off = torch.load(tmp_path / "off" / ckpt, weights_only=True)["params"]
        assert all(torch.equal(on[n], off[n]) for n in off)
    entries = sorted(d for d in os.listdir(cache) if not d.startswith("adapt_"))
    assert len(entries) == 2  # train and val
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].startswith("train_epoch")
    with open(os.path.join(prof, traces[0]), encoding="utf-8") as f:
        assert "train_epoch" in f.read()
    results = run("on", "predict", **knobs)
    assert sorted(d for d in os.listdir(cache) if not d.startswith("adapt_")) == entries
    assert [r["gts"] for r in results] == [r["gts"] for r in run("off", "predict")]


# -- NUMWORKERS ---------------------------------------------------------------------------

def test_prefetch_gives_the_same_batches():
    ds = t_loader.ArrayDataset({"x": np.arange(23), "y": np.arange(46).reshape(23, 2)})
    plain = list(t_loader.batch_iterator(ds, 4, shuffle=True, seed=3))
    ahead = list(t_loader.prefetch(t_loader.batch_iterator(ds, 4, shuffle=True, seed=3), 3))
    assert len(plain) == len(ahead) == 6
    for (a, n_a), (b, n_b) in zip(plain, ahead):
        assert n_a == n_b and all(np.array_equal(a[k], b[k]) for k in a)


def test_prefetch_raises_where_jax_truncates():
    def failing():
        yield 1
        yield 2
        raise OSError("feature file unreadable")

    assert list(j_loader.prefetch(failing(), 2)) == [1, 2]  # JAX: the epoch ends quietly
    got = []
    with pytest.raises(OSError, match="unreadable"):
        for item in t_loader.prefetch(failing(), 2):
            got.append(item)
    assert got == [1, 2]
    early = t_loader.prefetch(iter(range(1000)), 2)  # a consumer that stops early
    assert next(early) == 0
    early.close()


def test_numworkers_epochs_are_bit_identical(latr_paths, tmp_path):
    losses = []
    for workers in (0, 2):
        cfg = t_config.Config(get_config(tiny_latr_yaml(
            latr_paths, str(tmp_path / f"w{workers}"), SAVE=False, NUMWORKERS=workers,
            NUM_EPOCHS=2)))
        ex = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")
        losses.append([ex._train_epoch(e) for e in (1, 2)]
                      + [ex.infer(ex.val_data, 4, 8)])
    assert losses[0] == losses[1]


# -- PROFILE_DIR, DEBUG_NANS ------------------------------------------------------------------

def test_profile_dir_writes_a_trace_on_the_cpu(tmp_path):
    with profiling.maybe_trace(str(tmp_path), "region"):
        torch.ones(8, 8) @ torch.ones(8, 8)
    (trace,) = os.listdir(tmp_path)
    with open(tmp_path / trace, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "region" for e in events)
    with profiling.maybe_trace(None, "off"):  # no directory: no trace
        pass
    assert os.listdir(tmp_path) == [trace]


def test_debug_nans_raises_where_jax_raises(latr_paths, tmp_path):
    """A NaN in one T5 block's FFN output weight: JAX (jax_debug_nans) and the
    port raise FloatingPointError in the train step; the port names the
    module."""
    name = "t5.encoder.block_1.ffn.wo.weight"
    j_config = get_config(tiny_latr_yaml(latr_paths, str(tmp_path / "jax"), SAVE=False,
                                         DEBUG_NANS=True, MESH={"data": 1, "model": 1}))
    try:
        j_ex = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="train")
        params = jax.tree.map(np.asarray, j_ex.state.params)
        kernel = params["t5"]["encoder"]["block_1"]["ffn"]["wo"]["kernel"].copy()
        kernel[0, 0] = np.nan
        params["t5"]["encoder"]["block_1"]["ffn"]["wo"]["kernel"] = kernel
        j_ex.state = j_ex.state.replace(params=jax.tree.map(jax.numpy.asarray, params))
        batch = j_ex.train_data.gather(np.arange(8))
        with pytest.raises(FloatingPointError):
            j_ex.train_step(j_ex.state, j_ex._shard(batch))
    finally:
        jax.config.update("jax_debug_nans", False)
    t_cfg = t_config.Config({**j_config, "SAVE_PATH": str(tmp_path / "port")})
    t_ex = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "train", device="cpu")
    try:
        full = bridge.flax_to_state_dict(params, t_ex.model)
        t_ex.load_params(full)
        with pytest.raises(FloatingPointError, match="encoder.block_1.ffn.wo"):
            t_ex.train_step(batch)
    finally:
        t_ex.nan_check.close()
    assert not torch.is_anomaly_enabled()


def test_debug_nans_names_the_backward_node():
    """sqrt(x * 0) is finite forward; backward, sqrt's gradient at 0 is inf
    and the product's node turns inf * 0 into the first NaN."""
    x = torch.zeros(3, requires_grad=True)
    check = profiling.NanCheck(torch.nn.Identity())
    try:
        with pytest.raises(FloatingPointError, match="MulBackward0"):
            profiling.backward(torch.sqrt(x * 0).sum())
    finally:
        check.close()


def test_unported_holds_scan_layers_and_flash_only(latr_paths, tmp_path):
    assert [key for key, _, _ in UNPORTED] == ["SCAN_LAYERS", "FLASH"]
    cfg = t_config.Config(get_config(tiny_latr_yaml(latr_paths, str(tmp_path), DEBUG_NANS=True)))
    with pytest.raises(ValueError, match="DEBUG_NANS is refused in serve mode"):
        T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "serve", device="cpu")
    # serving over a mesh is ported: in one process without a group a serve
    # MESH raises the ValueError that names torchrun, as train mode does
    cfg = t_config.Config({**cfg, "DEBUG_NANS": False, "MESH": {"data": 2}})
    with pytest.raises(ValueError, match="launch with torchrun"):
        T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "serve", device="cpu")
