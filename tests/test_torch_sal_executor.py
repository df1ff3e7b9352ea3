"""The port's SaL-family executors against the JAX package's, on the CPU in
f32 at tiny widths (``tiny_sal_yaml``): SaLExecutor, CustomizedSaLExecutor
(char and BPE answer tokenizers) and PhonemeSaLExecutor, each trained two
epochs from the JAX executor's initial parameters, give the same per-epoch
losses, metric dicts and ``results.json``; ``NUM_FREEZE_EPOCH``'s masters
and adam moments follow optax's; ``SAL_FUSED`` is a knob, not an error; beam
decode (CustomizedSaL, char) and the pool decode (every case) answer as
the JAX executor and the batch decode do; the CLI; the serving engine's
answers equal ``infer``'s; and a PhonemeSaL memorisation gate on
diacritic-correct answers.
"""

import json
import os

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
from phoneme_vqa_torch.ops import attention as t_attn
from phoneme_vqa_torch.phonology import preprocess_sentence
from phoneme_vqa_torch.serving import SaLInputs, ServingEngine
from phoneme_vqa_torch.tokenizers import PhonemeTokenizer
from phoneme_vqa_torch.utils.registry import EXECUTORS as T_EXECUTORS
from phoneme_vqa_tpu import registry_setup  # noqa: F401
from phoneme_vqa_tpu.config import get_config
from phoneme_vqa_tpu.utils.registry import EXECUTORS

from .fixtures import make_sal_fixture, tiny_sal_yaml
from .test_torch_latr_family_executor import check_beam, check_pool

LOSS_TOL = 1e-5
CUSTOM = dict(n_head=4, num_decoder_layers=2, MODEL_MOD_CONFIG_CLASS="CustomizedSaL_config",
              LR=3e-3, warmup_step=2)
CASES = {
    "sal": dict(),
    "char": dict(CUSTOM, EXECUTOR="CustomizedSaL_Executor", MODEL_CLASS="CustomizedSaL",
                 DecodeTokenizer="CharTokenizer"),
    "bpe": dict(CUSTOM, EXECUTOR="CustomizedSaL_Executor", MODEL_CLASS="CustomizedSaL",
                DecodeTokenizer="BPE_Tokenizer", bpe_step=4, max_vocab_size=300),
    "phoneme": dict(CUSTOM, EXECUTOR="PhonemeSaL_Executor", MODEL_CLASS="PhonemeSaL",
                    max_a_length=24, max_eval_length=24, max_predict_length=24),
}


def _metrics(path):
    with open(os.path.join(path, "metrics.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def _config(paths, save, case, **over):
    """The JAX config of a case and the port's (its own save and BPE paths)."""
    kw = {**CASES[case], "NUM_EPOCHS": 2, **over}
    if case == "bpe":
        kw["vocab_save_path"] = os.path.join(save, "jax_bpe.json")
    j_config = get_config(tiny_sal_yaml(paths, os.path.join(save, "jax"), **kw))
    t_cfg = t_config.Config({**j_config, "SAVE_PATH": os.path.join(save, "port")})
    if case == "bpe":
        t_cfg["vocab_save_path"] = os.path.join(save, "port_bpe.json")
    return j_config, t_cfg


def _pair(paths, save, case, **over):
    """Both executors in train mode, the port's from the JAX one's initial
    parameters."""
    j_config, t_cfg = _config(paths, save, case, **over)
    j_ex = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="train")
    t_ex = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "train", device="cpu")
    t_ex.load_params(bridge.flax_to_state_dict(jax.tree.map(np.asarray, j_ex.state.params),
                                               t_ex.model))
    return j_config, t_cfg, j_ex, t_ex


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return make_sal_fixture(tmp_path_factory.mktemp("sal_fixture"))


@pytest.fixture(scope="module", params=list(CASES))
def trained(request, paths, tmp_path_factory):
    save = str(tmp_path_factory.mktemp(f"ck_{request.param}"))
    j_config, t_cfg, j_ex, t_ex = _pair(paths, save, request.param)
    j_ex.run()
    t_ex.run()
    return request.param, j_config, t_cfg, t_ex


def test_two_epochs_match_the_jax_executor(trained):
    case, j_config, t_cfg, t_ex = trained
    want, got = _metrics(j_config.SAVE_PATH), _metrics(t_cfg.SAVE_PATH)
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [1, 2]
    for w, g in zip(want, got):
        assert set(g) == set(w)
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=LOSS_TOL, atol=LOSS_TOL)
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        assert g["step"] == w["step"]
        for key in ("F1", "Accuracy", "CIDEr", "ROUGE", "BLEU"):
            assert g[key] == w[key], key
    if case != "sal":  # the encoder-only backbone, the answer vocabulary's ids
        assert not hasattr(t_ex.model.t5, "decoder")
        tok = t_ex.decode_tokenizer
        assert t_ex.model.decode_token_ids == (tok.bos_id, tok.eos_id, tok.pad_id)
        assert t_ex._loss_pad_id() == tok.pad_id


def test_predict_results_json_matches_the_jax_executor(trained):
    case, j_config, t_cfg, _ = trained
    want = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="predict", predicttype="best").run()
    got = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "predict", predicttype="best",
                                          device="cpu").run()
    assert got == want and len(got) == 6 and set(got[0]) == {"gens", "gts"}
    with open(os.path.join(j_config.SAVE_PATH, "results.json"), encoding="utf-8") as a, \
            open(os.path.join(t_cfg.SAVE_PATH, "results.json"), encoding="utf-8") as b:
        assert json.load(b) == json.load(a)
    if case == "phoneme":  # recomposed Vietnamese, never phoneme or tone tokens
        assert not any("<" in g["gens"][0] for g in got)


def test_eval_mode_matches_the_jax_executor(trained):
    case, j_config, t_cfg, _ = trained
    if case not in ("phoneme", "bpe"):
        return  # the other families' eval is their predict path's metric dict
    want = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="eval", evaltype="last").run()
    got = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "eval", evaltype="last", device="cpu").run()
    assert {k: np.asarray(v).tolist() for k, v in got.items()} == \
        {k: np.asarray(v).tolist() for k, v in want.items()}


def _adam_moments(opt_state):
    """optax's adam state (mu, nu) inside the JAX executor's chain."""
    found = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda x: isinstance(
        x, optax.ScaleByAdamState)) if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def test_freeze_epoch_scales_the_encoder_gradients_like_optax(paths, tmp_path):
    """NUM_FREEZE_EPOCH: 1, one epoch (one step): the ``t5`` subtree's
    gradients are multiplied by 0, so its masters stay bit-equal to the
    start and its adam moments are zero, while the step is counted; the
    rest moves as optax moves it (entries bound as in
    tests/test_torch_train_latr.py: a first adam step moves a parameter by
    ~lr sign(g), so entries with |g| near the frameworks' rounding part by
    up to 2 lr)."""
    j_config, t_cfg, j_ex, t_ex = _pair(paths, str(tmp_path), "phoneme", NUM_EPOCHS=1,
                                        NUM_FREEZE_EPOCH=1, SAVE=False)
    start = {n: p.detach().clone() for n, p in t_ex.state.params.items()}
    j_ex._train_epoch(1)
    t_ex._train_epoch(1)
    assert t_ex._encoder_grad_scale == 1.0  # only inside the frozen epoch
    lr = float(t_ex._lr_schedule(0))
    model = t_ex.model
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, j_ex.state.params), model)
    adam = _adam_moments(j_ex.state.opt_state)
    mu = bridge.flax_to_state_dict(jax.tree.map(np.asarray, adam.mu), model)
    nu = bridge.flax_to_state_dict(jax.tree.map(np.asarray, adam.nu), model)
    assert int(adam.count) == t_ex.state.opt_state["count"] == 1
    n_frozen = n_far = n_far_params = n_all = 0
    for name, p in t_ex.state.params.items():
        got_mu, got_nu = t_ex.state.opt_state["mu"][name], t_ex.state.opt_state["nu"][name]
        if name.startswith("t5."):
            n_frozen += 1
            torch.testing.assert_close(p, start[name], atol=0, rtol=0)
            np.testing.assert_array_equal(want[name].numpy(), start[name].numpy())
            assert not got_mu.any() and not got_nu.any() and not mu[name].any(), name
            continue
        # mu = 0.1 g and sqrt(nu) = 0.14 |g| after one step. The two
        # frameworks' f32 gradients agree to ~1e-4 of a tensor's largest
        # entry, except at a few entries: sums of cancelling terms (the
        # 2D-bias tables, an embedding row) and ReLU units whose input sits
        # at the kink, where one contribution flips. So: every entry within
        # 5 % of the tensor's largest, fewer than 0.1 % beyond 1e-3 of it
        # (a floor for gradients that are zero but for rounding: a key bias)
        for got_m, want_m in ((got_mu.numpy(), mu[name].numpy()),
                              (np.sqrt(got_nu.numpy()), np.sqrt(nu[name].numpy()))):
            gap, top = np.abs(got_m - want_m), float(np.abs(want_m).max())
            assert gap.max() <= 0.05 * top + 1e-9, name
            n_far += int((gap > 1e-3 * top + 1e-9).sum())
        n_all += p.numel()
        diff = (p.detach() - want[name]).abs().numpy()
        assert diff.max() <= 2 * lr * 1.001, name
        big = mu[name].abs().numpy() >= 1e-3 * (1 - 0.9)  # |g| >= 1e-3
        n_far_params += int((diff[big] > 1e-2 * lr).sum())
    assert n_far < 1e-3 * n_all and n_far_params < 1e-3 * n_all, (n_far, n_far_params, n_all)
    assert n_frozen > 10


def test_sal_fused_is_a_knob_not_an_error(paths, tmp_path):
    saved = t_attn.sal_fused_enabled()
    try:
        for value in (False, True):
            _, t_cfg = _config(paths, str(tmp_path), "phoneme", SAL_FUSED=value)
            T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "train", device="cpu")
            assert t_attn.sal_fused_enabled() is value
    finally:
        t_attn.enable_sal_fused(saved)


def test_beam_decode_matches_jax(paths, tmp_path, monkeypatch):
    """CustomizedSaL (char) with ``isgreedy: false, num_beam: 3`` trains,
    evaluates and predicts as the JAX executor does."""
    j_config, t_cfg, j_ex, t_ex = _pair(paths, str(tmp_path), "char", NUM_EPOCHS=1,
                                        isgreedy=False, num_beam=3)
    j_ex.run()
    t_ex.run()
    check_beam(j_config, t_cfg, j_ex, t_ex, monkeypatch, j_config.max_eval_length)


def test_pool_decode_gives_the_batch_answers(trained):
    check_pool(trained[3])


def test_cli_trains_evaluates_and_predicts_phoneme_sal_on_the_cpu(paths, tmp_path):
    yaml_path = tiny_sal_yaml(paths, str(tmp_path / "ck"), **dict(CASES["phoneme"], NUM_EPOCHS=1))
    t_run.main(["--config-file", yaml_path, "--mode", "train", "--device", "cpu"])
    scores = t_run.main(["--config-file", yaml_path, "--mode", "eval", "--device", "cpu"])
    assert set(scores) == {"F1", "Accuracy", "CIDEr", "ROUGE", "BLEU"}
    results = t_run.main(["--config-file", yaml_path, "--mode", "predict", "--device", "cpu",
                          "--predicttype", "last"])
    assert len(results) == 6 and os.path.isfile(str(tmp_path / "ck" / "results.json"))
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA card"):
            t_run.main(["--config-file", yaml_path, "--mode", "eval"])


def _engine(ex, config):
    obj_store = t_adapters.textlayout_obj_adapt(config.base_obj_feature_path, 1, 1)
    return ServingEngine(
        ex.model, ex.tokenizer,
        t_adapters.textlayout_ocr_adapt(config.base_ocr_feature_path, 1, 1), None,
        batch_size=4, max_answer_length=config.max_eval_length,
        max_ocr_element=config.max_ocr_element, max_ocr_length=config.max_ocr_length,
        max_q_length=config.max_q_length,
        sal=SaLInputs(obj_store, config.base_ocr_feature_path, config.base_obj_feature_path,
                      ocr_hidden=config.ocr_hidden, obj_hidden=config.obj_hidden,
                      max_obj_element=config.max_obj_element,
                      max_obj_length=config.max_obj_length),
        answer_tokenizer=ex.decode_tokenizer,
    )


@pytest.fixture
def one_thread():
    """Tiny matrices gain nothing from threads, and the suite's parallel
    workers oversubscribe the cores: one intra-op thread for the gate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_phoneme_memorization_gate_and_serving(tmp_path, one_thread):
    """PhonemeSaL learns the fixture's answers: every decoded validation
    answer equals the phoneme tokenizer's round trip of its ground truth,
    diacritics included (digits come back spaced: "0 1 2 ..."); and the
    serving engine, given the answer tokenizer, answers what ``infer``
    does."""
    paths = make_sal_fixture(str(tmp_path), n_rows=96)
    config = t_config.Config(dict(get_config(tiny_sal_yaml(
        paths, str(tmp_path / "ck"), **dict(CASES["phoneme"], SAVE=False, TRAIN_BATCH_SIZE=8,
                                            warmup_step=10, LR=3e-3)))))
    ex = T_EXECUTORS.get(config.EXECUTOR)(config, "train", device="cpu")
    losses = [ex._train_epoch(epoch) for epoch in range(1, 21)]
    gens = ex.infer(ex.val_data, 8, config.max_eval_length)
    tok = PhonemeTokenizer()
    want = [tok.decode(tok.encode(preprocess_sentence(a), 40)) for a in ex.val_answer]
    assert "nguyễn huệ" in want[3] and want[5] == "0 1 2 3 4 5 6 7 8 9"
    assert losses[-1] < losses[0] * 0.5, losses
    assert gens == want, list(zip(gens, want))

    rows = t_synthetic.read_qa_csv(config.qa_val_path)
    answers = _engine(ex, config).answer([(r["image_id"], r["question"]) for r in rows])
    assert answers == gens
