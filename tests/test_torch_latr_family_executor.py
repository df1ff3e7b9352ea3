"""The port's CustomizedLaTr executor against the JAX package's, on the CPU
in f32 at tiny widths (``tiny_latr_yaml``): two epochs from the JAX
executor's initial parameters give the same per-epoch losses, metric dicts,
eval-mode scores and ``results.json``; ``NUM_FREEZE_EPOCH``'s masters and
adam moments follow optax's; beam decode (``isgreedy: false, num_beam:
3``) trains, evaluates and predicts as the JAX executor does (CustomizedLaTr
and PhonemeLaTr); the CLI trains, evaluates and predicts on the CPU.

The helpers here serve the other executor files of the LaTr / PreSTU family
(``tests/test_torch_phoneme_latr_executor.py``, ``test_torch_prestu_executor.py``,
``test_torch_customized_prestu_executor.py``,
``test_torch_phoneme_prestu_executor.py``), one model a file, so that
``--dist loadfile`` spreads them over the workers.
"""

import json
import os
import re

import jax
import numpy as np
import optax
import pytest
import torch

from phoneme_vqa_torch import config as t_config
from phoneme_vqa_torch import run as t_run
from phoneme_vqa_torch.data import adapters as t_adapters
from phoneme_vqa_torch.data import synthetic as t_synthetic
from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.serving import ServingEngine
from phoneme_vqa_torch.utils.registry import EXECUTORS as T_EXECUTORS
from phoneme_vqa_tpu import registry_setup  # noqa: F401
from phoneme_vqa_tpu.config import get_config
from phoneme_vqa_tpu.utils.registry import EXECUTORS

from .fixtures import ANSWERS, QUESTIONS, make_latr_fixture, tiny_latr_yaml

LOSS_TOL = 1e-5
CUSTOM = dict(n_head=4, num_decoder_layers=2, LR=3e-3, warmup_step=2)
# answers of up to 12 triples ("0123456789" is one a character)
PHONEME = dict(CUSTOM, max_a_length=16, max_eval_length=16, max_predict_length=16)
CASES = {
    "customized_latr": dict(CUSTOM, EXECUTOR="CustomizedLaTr_Executor",
                            MODEL_CLASS="CustomizedLaTr",
                            MODEL_MOD_CONFIG_CLASS="CustomizedLaTr_config",
                            DecodeTokenizer="BPE_Tokenizer", bpe_step=4, max_vocab_size=300),
    "phoneme_latr": dict(PHONEME, EXECUTOR="PhonemeLaTr_Executor", MODEL_CLASS="PhonemeLaTr",
                         MODEL_MOD_CONFIG_CLASS="CustomizedLaTr_config"),
    "prestu": dict(EXECUTOR="PreSTU_Executor", MODEL_CLASS="PreSTU",
                   MODEL_MOD_CONFIG_CLASS="PreSTU_config"),
    "customized_prestu": dict(CUSTOM, EXECUTOR="CustomizedPreSTU_Executor",
                              MODEL_CLASS="CustomizedPreSTU",
                              MODEL_MOD_CONFIG_CLASS="CustomizedPreSTU_config",
                              DecodeTokenizer="CharTokenizer"),
    "phoneme_prestu": dict(PHONEME, EXECUTOR="PhonemePreSTU_Executor",
                           MODEL_CLASS="PhonemePreSTU",
                           MODEL_MOD_CONFIG_CLASS="CustomizedPreSTU_config"),
}
LATR_CASES = ("customized_latr", "phoneme_latr")


def write_annotations(root) -> str:
    """The structured vocabulary's source, as tests/test_executor_phoneme.py
    writes it: the fixture's questions and answers."""
    ann = {"annotations": [{"question": q, "answers": [a]} for q, a in zip(QUESTIONS, ANSWERS)]}
    path = os.path.join(str(root), "annotations.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(ann, f, ensure_ascii=False)
    return path


def metrics(path):
    with open(os.path.join(path, "metrics.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def case_overrides(paths, case, **over) -> dict:
    """A case's YAML keys over ``tiny_latr_yaml``'s, with the phoneme
    cases' annotation file written beside the fixture."""
    kw = {**CASES[case], "NUM_EPOCHS": 2, **over}
    if case.startswith("phoneme"):
        kw["annotation_paths"] = [write_annotations(paths["root"])]
    return kw


def configs(paths, save, case, **over):
    """The JAX config of a case and the port's (its own save and vocabulary
    paths)."""
    kw = case_overrides(paths, case, **over)
    os.makedirs(save, exist_ok=True)
    vocab_key = "vocab_path" if case.startswith("phoneme") else "vocab_save_path"
    j_config = get_config(tiny_latr_yaml(paths, os.path.join(save, "jax"), **kw,
                                         **{vocab_key: os.path.join(save, "jax_vocab.json")}))
    t_cfg = t_config.Config({**j_config, "SAVE_PATH": os.path.join(save, "port"),
                             vocab_key: os.path.join(save, "port_vocab.json")})
    return j_config, t_cfg


def pair(paths, save, case, **over):
    """Both executors in train mode, the port's from the JAX one's initial
    parameters."""
    j_config, t_cfg = configs(paths, save, case, **over)
    j_ex = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="train")
    t_ex = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "train", device="cpu")
    t_ex.load_params(bridge.flax_to_state_dict(jax.tree.map(np.asarray, j_ex.state.params),
                                               t_ex.model))
    return j_config, t_cfg, j_ex, t_ex


def train_pair(case, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"fixture_{case}")
    paths = make_latr_fixture(root)
    j_config, t_cfg, j_ex, t_ex = pair(paths, str(root / "ck"), case)
    j_ex.run()
    t_ex.run()
    return case, j_config, t_cfg, t_ex


def check_two_epochs(trained):
    case, j_config, t_cfg, t_ex = trained
    want, got = metrics(j_config.SAVE_PATH), metrics(t_cfg.SAVE_PATH)
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [1, 2]
    for w, g in zip(want, got):
        assert set(g) == set(w)
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=LOSS_TOL, atol=LOSS_TOL)
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        assert g["step"] == w["step"]
        for key in ("F1", "Accuracy", "CIDEr", "ROUGE", "BLEU"):
            assert g[key] == w[key], key
    model = t_ex.model
    if case != "prestu":  # the encoder-only backbone, the answer vocabulary's ids
        assert not hasattr(model.t5, "decoder")
        tok = t_ex.decode_tokenizer
        assert model.decode_token_ids == (tok.bos_id, tok.eos_id, tok.pad_id)
        assert t_ex._loss_pad_id() == tok.pad_id
    # the ViT holds optimizer state only where the model trains it
    vit_state = any(n.startswith("vit.") for n in t_ex.state.opt_state["mu"])
    assert vit_state == (case == "prestu")
    if case.startswith("phoneme"):
        labels = t_ex.train_data.arrays["label_ids"]
        assert labels.ndim == 3 and labels.shape[2] == 3
        assert model.decode_components == 3


def check_predict(trained):
    case, j_config, t_cfg, _ = trained
    want = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="predict", predicttype="best").run()
    got = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "predict", predicttype="best",
                                          device="cpu").run()
    assert got == want and len(got) == 6 and set(got[0]) == {"gens", "gts"}
    with open(os.path.join(j_config.SAVE_PATH, "results.json"), encoding="utf-8") as a, \
            open(os.path.join(t_cfg.SAVE_PATH, "results.json"), encoding="utf-8") as b:
        assert json.load(b) == json.load(a)
    if case.startswith("phoneme"):  # recomposed Vietnamese, never special or tone tokens
        assert not any(re.search(r"<[^\W\d_]{2,}>", g["gens"][0]) for g in got)


def check_eval(trained):
    _, j_config, t_cfg, _ = trained
    want = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="eval", evaltype="last").run()
    got = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "eval", evaltype="last", device="cpu").run()
    assert set(got) == {"F1", "Accuracy", "CIDEr", "ROUGE", "BLEU"}
    assert {k: np.asarray(v).tolist() for k, v in got.items()} == \
        {k: np.asarray(v).tolist() for k, v in want.items()}


def check_cli(case, tmp_path):
    """1 epoch through ``python -m phoneme_vqa_torch.run``, then eval and
    predict from the checkpoints, on the CPU."""
    paths = make_latr_fixture(tmp_path)
    kw = case_overrides(paths, case, NUM_EPOCHS=1)
    kw["vocab_path" if case.startswith("phoneme") else "vocab_save_path"] = \
        str(tmp_path / "vocab.json")
    yaml_path = tiny_latr_yaml(paths, str(tmp_path / "ck"), **kw)
    t_run.main(["--config-file", yaml_path, "--mode", "train", "--device", "cpu"])
    scores = t_run.main(["--config-file", yaml_path, "--mode", "eval", "--device", "cpu"])
    assert set(scores) == {"F1", "Accuracy", "CIDEr", "ROUGE", "BLEU"}
    results = t_run.main(["--config-file", yaml_path, "--mode", "predict", "--device", "cpu",
                          "--predicttype", "last"])
    assert len(results) == 6 and os.path.isfile(str(tmp_path / "ck" / "results.json"))
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA card"):
            t_run.main(["--config-file", yaml_path, "--mode", "eval"])


def engine(ex, config, answer_tokenizer):
    return ServingEngine(
        ex.model, ex.tokenizer, t_adapters.textlayout_ocr_adapt(config.ocr_path),
        config.base_img_path, batch_size=4, max_answer_length=config.max_eval_length,
        max_ocr_element=config.max_ocr_element, max_ocr_length=config.max_ocr_length,
        max_q_length=config.max_q_length, answer_tokenizer=answer_tokenizer,
    )


def check_serving(trained):
    """The serving engine answers the validation requests as ``infer`` does,
    decoding with the executor's answer tokenizer where it has one."""
    _, _, t_cfg, t_ex = trained
    got = engine(t_ex, t_cfg, getattr(t_ex, "decode_tokenizer", None)).answer(
        serving_requests(t_cfg))
    want = t_ex.infer(t_ex.val_data, 4, t_cfg.max_eval_length)
    assert got == want and len(got) == 6


def serving_requests(config):
    return [(r["image_id"], r["question"]) for r in t_synthetic.read_qa_csv(config.qa_val_path)]


# -- CustomizedLaTr -----------------------------------------------------------------


@pytest.fixture(scope="module", params=("customized_latr",))
def trained(request, tmp_path_factory):
    return train_pair(request.param, tmp_path_factory)


def test_two_epochs_match_the_jax_executor(trained):
    check_two_epochs(trained)


def test_predict_results_json_matches_the_jax_executor(trained):
    check_predict(trained)


def test_eval_mode_matches_the_jax_executor(trained):
    check_eval(trained)


def _adam_moments(opt_state):
    """optax's adam state (mu, nu) inside the JAX executor's chain."""
    found = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda x: isinstance(
        x, optax.ScaleByAdamState)) if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def test_freeze_epoch_scales_the_encoder_gradients_like_optax(tmp_path):
    """CustomizedLaTr, ``NUM_FREEZE_EPOCH: 1``, one epoch (one step): the
    ``t5`` subtree's masters stay bit-equal to the start with zero adam
    moments while the step counts; the frozen ViT holds no state and does
    not move; the rest moves as optax moves it (a first adam step moves a
    parameter by ~lr sign(g): entries whose |g| sits near the frameworks'
    rounding part by up to 2 lr, as in tests/test_torch_sal_executor.py)."""
    paths = make_latr_fixture(tmp_path)
    _, _, j_ex, t_ex = pair(paths, str(tmp_path), "customized_latr", NUM_EPOCHS=1,
                            NUM_FREEZE_EPOCH=1, SAVE=False)
    start = {n: p.detach().clone() for n, p in t_ex.state.params.items()}
    j_ex._train_epoch(1)
    t_ex._train_epoch(1)
    assert t_ex._encoder_grad_scale == 1.0  # only inside the frozen epoch
    lr = float(t_ex._lr_schedule(0))
    model = t_ex.model
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, j_ex.state.params), model)
    adam = _adam_moments(j_ex.state.opt_state)
    # optax keeps no moments for the frozen ViT: zeros stand in for the bridge
    no_vit = jax.tree.map(np.zeros_like, j_ex.state.params["vit"])
    mu, nu = (bridge.flax_to_state_dict(jax.tree.map(np.asarray, dict(m, vit=no_vit)), model)
              for m in (adam.mu, adam.nu))
    assert int(adam.count) == t_ex.state.opt_state["count"] == 1
    n_frozen = n_far = n_all = 0
    for name, p in t_ex.state.params.items():
        if name.startswith("vit."):
            assert name not in t_ex.state.opt_state["mu"], name
            torch.testing.assert_close(p, start[name], atol=0, rtol=0)
            continue
        got_mu, got_nu = t_ex.state.opt_state["mu"][name], t_ex.state.opt_state["nu"][name]
        if name.startswith("t5."):
            n_frozen += 1
            torch.testing.assert_close(p, start[name], atol=0, rtol=0)
            np.testing.assert_array_equal(want[name].numpy(), start[name].numpy())
            assert not got_mu.any() and not got_nu.any() and not mu[name].any(), name
            continue
        for got_m, want_m in ((got_mu.numpy(), mu[name].numpy()),
                              (np.sqrt(got_nu.numpy()), np.sqrt(nu[name].numpy()))):
            gap, top = np.abs(got_m - want_m), float(np.abs(want_m).max())
            assert gap.max() <= 0.05 * top + 1e-9, name
            n_far += int((gap > 1e-3 * top + 1e-9).sum())
        n_all += p.numel()
        assert float((p.detach() - want[name]).abs().max()) <= 2 * lr * 1.001, name
    assert n_far < 1e-3 * n_all, (n_far, n_all)
    assert n_frozen > 10


def check_beam(j_config, t_cfg, j_ex, t_ex, monkeypatch, max_length):
    """After one epoch of both executors with ``isgreedy: false, num_beam:
    3``: the epoch's metrics (its eval decodes by beam search), eval mode,
    ``results.json`` and ``infer`` equal the JAX executor's, and the port's
    ``infer`` goes through the beam search."""
    want, got = metrics(j_config.SAVE_PATH), metrics(t_cfg.SAVE_PATH)
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got[0]["train_loss"], want[0]["train_loss"], rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    for key in ("F1", "Accuracy", "CIDEr", "ROUGE", "BLEU"):
        assert got[0][key] == want[0][key], key
    check_eval((None, j_config, t_cfg, t_ex))
    j_results = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="predict",
                                                 predicttype="best").run()
    t_results = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "predict", predicttype="best",
                                                device="cpu").run()
    assert t_results == j_results and set(t_results[0]) == {"gens", "gts"}
    with open(os.path.join(t_cfg.SAVE_PATH, "results.json"), encoding="utf-8") as f:
        assert json.load(f) == j_results
    from phoneme_vqa_torch.models import generate as t_generate

    calls = []
    for name in ("beam_decode", "multi_head_beam_decode"):
        fn = getattr(t_generate, name)
        monkeypatch.setattr(t_generate, name,
                            lambda *a, fn=fn, **k: calls.append(1) or fn(*a, **k))
    assert t_ex.infer(t_ex.val_data, 4, max_length) == j_ex.infer(j_ex.val_data, 4, max_length)
    assert len(calls) == 2  # 6 rows in batches of 4


def check_pool(t_ex):
    """``EVAL_CONTINUOUS``: the pool decode (2 slots, pools of 5 rows)
    answers as the batch decode does, scores included."""
    config = t_ex.config
    want, want_s = t_ex.infer(t_ex.val_data, 4, config.max_eval_length, return_scores=True)
    config.update(EVAL_CONTINUOUS=True, EVAL_SLOTS=2, EVAL_POOL_ROWS=5)
    try:
        assert t_ex._use_pool_decode()
        got, got_s = t_ex.infer(t_ex.val_data, 4, config.max_eval_length, return_scores=True)
    finally:
        for key in ("EVAL_CONTINUOUS", "EVAL_SLOTS", "EVAL_POOL_ROWS"):
            config.pop(key)
    assert got == want
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", LATR_CASES)
def test_beam_decode_matches_jax(tmp_path, monkeypatch, case):
    paths = make_latr_fixture(tmp_path)
    j_config, t_cfg, j_ex, t_ex = pair(paths, str(tmp_path / "ck"), case, NUM_EPOCHS=1,
                                       isgreedy=False, num_beam=3)
    j_ex.run()
    t_ex.run()
    check_beam(j_config, t_cfg, j_ex, t_ex, monkeypatch, j_config.max_eval_length)


@pytest.mark.parametrize("case", ("customized_latr",))
def test_cli_trains_evaluates_and_predicts_on_the_cpu(case, tmp_path):
    check_cli(case, tmp_path)
