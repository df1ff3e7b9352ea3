"""The port's LaTr executor against the JAX package's, on the CPU in f32 at
tiny widths: two epochs of training from the same (bridged) initial
parameters give the same per-epoch losses, metric dicts and
``results.json``; the checkpoints, resume, eval/predict, the CLI and the
knobs the port does not have yet.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from phoneme_vqa_torch import config as t_config
from phoneme_vqa_torch import evaluation as t_evaluation
from phoneme_vqa_torch import run as t_run
from phoneme_vqa_torch.data import loader as t_loader
from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.train import base_executor as t_base
from phoneme_vqa_torch.train.latr_executor import LaTrExecutor
from phoneme_vqa_torch.utils.registry import EXECUTORS as T_EXECUTORS
from phoneme_vqa_tpu import evaluation as j_evaluation
from phoneme_vqa_tpu import registry_setup  # noqa: F401
from phoneme_vqa_tpu.config import get_config
from phoneme_vqa_tpu.data import loader as j_loader
from phoneme_vqa_tpu.utils.registry import EXECUTORS

from .fixtures import make_latr_fixture, tiny_latr_yaml

LOSS_TOL = 1e-5


def _metrics(path):
    with open(os.path.join(path, "metrics.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def _port_config(j_config, save_path, **over):
    return t_config.Config({**j_config, "SAVE_PATH": save_path, **over})


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX executor and the port's, both from the JAX executor's initial
    parameters, trained 2 epochs (one step each: 12 rows, batch 8) with
    their checkpoints in separate directories."""
    root = tmp_path_factory.mktemp("latr_fixture")
    paths = make_latr_fixture(root)
    j_save, t_save = str(root / "jax_ckpts"), str(root / "port_ckpts")
    j_config = get_config(tiny_latr_yaml(paths, j_save, NUM_EPOCHS=2))
    j_ex = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="train")
    initial = jax.tree.map(np.asarray, j_ex.state.params)

    t_cfg = _port_config(j_config, t_save)
    t_ex = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "train", device="cpu")
    t_ex.load_params(bridge.flax_to_state_dict(initial, t_ex.model))
    j_ex.run()
    t_ex.run()
    return paths, j_config, t_cfg, j_save, t_save, t_ex


def test_two_epochs_match_the_jax_executor(trained):
    _, _, _, j_save, t_save, _ = trained
    want, got = _metrics(j_save), _metrics(t_save)
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [1, 2]
    for w, g in zip(want, got):
        assert set(g) == set(w)
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        assert g["step"] == w["step"]
        for key in ("F1", "Accuracy", "CIDEr", "ROUGE", "BLEU"):
            assert g[key] == w[key], key


def test_predict_results_json_matches_the_jax_executor(trained):
    _, j_config, t_cfg, j_save, t_save, _ = trained
    j_results = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="predict",
                                                 predicttype="best").run()
    t_results = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "predict", predicttype="best",
                                                device="cpu").run()
    assert t_results == j_results
    with open(os.path.join(j_save, "results.json"), encoding="utf-8") as a, \
            open(os.path.join(t_save, "results.json"), encoding="utf-8") as b:
        assert json.load(b) == json.load(a)
    assert set(t_results[0]) == {"gens", "gts"} and len(t_results) == 6


def test_eval_mode_matches_the_jax_executor(trained):
    _, j_config, t_cfg, _, _, _ = trained
    want = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="eval", evaltype="last").run()
    got = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "eval", evaltype="last", device="cpu").run()
    assert set(got) == {"F1", "Accuracy", "CIDEr", "ROUGE", "BLEU"}
    assert {k: np.asarray(v).tolist() for k, v in got.items()} == \
        {k: np.asarray(v).tolist() for k, v in want.items()}


def test_checkpoints_hold_the_masters_and_resume_at_the_next_epoch(trained, tmp_path):
    _, j_config, _, _, t_save, t_ex = trained
    assert os.path.isfile(os.path.join(t_save, "last_ckp"))
    assert os.path.isfile(os.path.join(t_save, "best_ckp"))
    saved = torch.load(os.path.join(t_save, "last_ckp"), weights_only=True)
    assert (saved["step"], saved["epoch"], saved["step_in_epoch"]) == (2, 2, 0)
    assert set(saved["params"]) == {n for n, _ in t_ex.model.named_parameters()}
    assert not any(n.startswith("vit.") for n in saved["opt_state"]["mu"])

    save = str(tmp_path / "resumed")
    shutil.copytree(t_save, save)
    os.remove(os.path.join(save, "results.json"))
    cfg = _port_config(j_config, save, NUM_EPOCHS=3)
    ex = LaTrExecutor(cfg, "train", device="cpu")
    assert (ex.state.step, ex.state.epoch) == (2, 2)
    assert ex.state.opt_state["count"] == 2
    for name, p in saved["params"].items():
        torch.testing.assert_close(ex.state.params[name], p, atol=0, rtol=0)
    for name, m in saved["opt_state"]["nu"].items():
        torch.testing.assert_close(ex.state.opt_state["nu"][name], m, atol=0, rtol=0)
    ex.run()
    assert [r["epoch"] for r in _metrics(save)] == [1, 2, 3]
    assert torch.load(os.path.join(save, "last_ckp"), weights_only=True)["epoch"] == 3


def test_an_unreadable_last_checkpoint_falls_back_to_best(trained, tmp_path):
    _, j_config, _, _, t_save, _ = trained
    save = str(tmp_path / "broken")
    shutil.copytree(t_save, save)
    with open(os.path.join(save, "last_ckp"), "wb") as f:
        f.write(b"not a checkpoint")
    ex = LaTrExecutor(_port_config(j_config, save), "train", device="cpu")
    best = torch.load(os.path.join(save, "best_ckp"), weights_only=True)
    assert (ex.state.step, ex.state.epoch) == (best["step"], best["epoch"])


@pytest.mark.parametrize("mode", ["eval", "predict"])
def test_a_missing_checkpoint_raises(trained, tmp_path, monkeypatch, mode):
    _, j_config, _, _, _, _ = trained
    monkeypatch.chdir(tmp_path)  # no ./models fallback here either
    ex = LaTrExecutor(_port_config(j_config, str(tmp_path / "empty")), mode, device="cpu")
    with pytest.raises(FileNotFoundError, match="_ckp is required"):
        ex.run()


def test_eval_loads_from_the_models_fallback(trained, tmp_path, monkeypatch):
    _, j_config, t_cfg, _, t_save, _ = trained
    monkeypatch.chdir(tmp_path)
    os.makedirs("models")
    shutil.copy(os.path.join(t_save, "best_ckp"), os.path.join("models", "best_ckp"))
    want = LaTrExecutor(t_cfg, "eval", evaltype="best", device="cpu").run()
    got = LaTrExecutor(_port_config(j_config, str(tmp_path / "elsewhere")), "eval",
                       evaltype="best", device="cpu").run()
    assert got == want


KNOB_VALUES = {"MESH": {"data": 2, "model": 1}, "FLASH": False, "SAL_FUSED": False}
KNOBS = [(key, KNOB_VALUES.get(key, True)) for key, _, _ in t_base.UNPORTED]


@pytest.mark.parametrize("key,value", KNOBS)
def test_every_knob_the_port_lacks_raises(trained, key, value):
    _, j_config, t_cfg, _, _, _ = trained
    with pytest.raises(NotImplementedError, match=f"{key}.*ROADMAP"):
        LaTrExecutor(t_config.Config({**t_cfg, key: value}), "train", device="cpu")


# the decode knobs, each held against the JAX executor with the same knob
DECODE_KNOBS = {
    # the pool decode: 2 slots over pools of 5 rows (refills, 2 pools)
    "EVAL_CONTINUOUS": dict(EVAL_CONTINUOUS=True, EVAL_SLOTS=2, EVAL_POOL_ROWS=5),
    "SAMPLE": dict(SAMPLE=True, TEMPERATURE=0.0),  # temperature 0: greedy
    "SPEC_DECODE": dict(SPEC_DECODE=3),
    "PREDICT_SCORES": dict(PREDICT_SCORES=True),
}


@pytest.mark.parametrize("key", list(DECODE_KNOBS))
def test_decode_knob_matches_the_jax_executor(trained, tmp_path, key):
    """Predict and ``infer`` with the knob, the port's executor from its
    trained checkpoint and the JAX one from its own: the same results.json
    (confidences within 1e-5), and greedy's answers."""
    _, j_config, t_cfg, j_save, t_save, _ = trained
    knob = DECODE_KNOBS[key]
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(j_save, j_dir)
    shutil.copytree(t_save, t_dir)
    greedy = T_EXECUTORS.get(t_cfg.EXECUTOR)(_port_config(t_cfg, t_dir), "predict",
                                             predicttype="best", device="cpu")
    greedy._load_trained_checkpoint("best")
    greedy_answers = greedy.infer(greedy.predict_data, 4, 10)
    for score in (True, False) if key == "PREDICT_SCORES" else (True,):
        j_cfg = get_config_dict(j_config, SAVE_PATH=j_dir, get_predict_score=score, **knob)
        want = EXECUTORS.get(j_config.EXECUTOR)(j_cfg, mode="predict", predicttype="best").run()
        t_ex = T_EXECUTORS.get(t_cfg.EXECUTOR)(_port_config(t_cfg, t_dir, get_predict_score=score,
                                                            **knob),
                                               "predict", predicttype="best", device="cpu")
        got = t_ex.run()
        assert [r["gens"] for r in got] == [r["gens"] for r in want]
        assert set(got[0]) == set(want[0]) == {"gens"} | ({"gts"} if score else set()) | (
            {"confidence"} if key == "PREDICT_SCORES" else set())
        if key == "PREDICT_SCORES":
            np.testing.assert_allclose([r["confidence"] for r in got],
                                       [r["confidence"] for r in want], rtol=1e-5, atol=1e-5)
            assert all(0.0 < r["confidence"] <= 1.0 for r in got)
        else:
            assert got == want
        with open(os.path.join(t_dir, "results.json"), encoding="utf-8") as f:
            assert json.load(f) == got
    # infer in batches of 4 (3 batches, the last one padded) against greedy
    if key == "PREDICT_SCORES":
        answers, scores = t_ex.infer(t_ex.predict_data, 4, 10, return_scores=True)
        assert len(scores) == len(answers) == len(greedy_answers)
    else:
        answers = t_ex.infer(t_ex.predict_data, 4, 10)
    assert answers == greedy_answers
    assert t_ex._use_pool_decode() is (key == "EVAL_CONTINUOUS")


def get_config_dict(j_config, **over):
    """The JAX executor's config with ``over`` set."""
    return type(j_config)({**j_config, **over})


def test_single_device_mesh_and_default_knobs_are_accepted():
    t_base.check_unported(t_config.Config({"MESH": {"data": -1, "model": 1}, "GRAD_ACCUM_STEPS": 1,
                                           "SPEC_DECODE": 0, "NUMWORKERS": 0}))


def test_missing_train_keys_are_all_named(trained):
    _, _, t_cfg, _, _, _ = trained
    cfg = t_config.Config({k: v for k, v in t_cfg.items() if k not in ("LR", "ocr_path")})
    with pytest.raises(ValueError, match=r"\['LR', 'ocr_path'\]"):
        LaTrExecutor(cfg, "train", device="cpu")


def test_cli_trains_and_predicts_on_the_cpu(tmp_path):
    paths = make_latr_fixture(tmp_path)
    yaml_path = tiny_latr_yaml(paths, str(tmp_path / "ck"), NUM_EPOCHS=1)
    t_run.main(["--config-file", yaml_path, "--mode", "train", "--device", "cpu"])
    results = t_run.main(["--config-file", yaml_path, "--mode", "predict", "--device", "cpu",
                          "--predicttype", "last"])
    assert len(results) == 6 and os.path.isfile(str(tmp_path / "ck" / "results.json"))
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA card"):
            t_run.main(["--config-file", yaml_path, "--mode", "eval"])


@pytest.mark.parametrize("shuffle,drop_last,pad_final", [
    (False, False, True), (False, False, False), (True, True, True), (True, False, True),
])
def test_batch_order_matches_the_jax_loader(shuffle, drop_last, pad_final):
    arrays = {"x": np.arange(23, dtype=np.int32)}
    args = dict(shuffle=shuffle, seed=14, drop_last=drop_last, pad_final=pad_final)
    want = [(b["x"].tolist(), n) for b, n in
            j_loader.batch_iterator(j_loader.ArrayDataset(arrays), 5, **args)]
    got = [(b["x"].tolist(), n) for b, n in
           t_loader.batch_iterator(t_loader.ArrayDataset(arrays), 5, **args)]
    assert got == want
    assert t_loader.num_batches(23, 5, drop_last) == j_loader.num_batches(23, 5, drop_last)


def test_metric_suite_matches_jax():
    gts = {"0_": ["quán phở hà nội"], "1_": ["7 giờ sáng"], "2_": ["biển hiệu"],
           "3_": ["số 5 nguyễn huệ"]}
    gens = {"0_": ["quán phở"], "1_": ["7 giờ sáng"], "2_": [""], "3_": ["số 5 huệ nguyễn"]}
    want, want_each = j_evaluation.compute_scores(gts, gens)
    got, got_each = t_evaluation.compute_scores(gts, gens)
    assert {k: np.asarray(v).tolist() for k, v in got.items()} == \
        {k: np.asarray(v).tolist() for k, v in want.items()}
    for k in want_each:
        np.testing.assert_array_equal(np.asarray(got_each[k]), np.asarray(want_each[k]))
