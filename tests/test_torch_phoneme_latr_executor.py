"""The port's PhonemeLaTr executor against the JAX package's, on the CPU in
f32 at tiny widths (``tiny_latr_yaml``: d_model 32, not divisible by 3):
two epochs from the JAX executor's initial parameters give the same
per-epoch losses, metric dicts, eval-mode scores and ``results.json``; the
pool decode over triples answers as the batch decode does; the CLI trains,
evaluates and predicts on the CPU; a memorisation gate on
diacritic-correct answers, whose serving-engine answers equal ``infer``'s.
Helpers in ``tests/test_torch_latr_family_executor.py``.
"""

import pytest
import torch

from phoneme_vqa_torch import config as t_config
from phoneme_vqa_torch.utils.registry import EXECUTORS as T_EXECUTORS
from phoneme_vqa_tpu.config import get_config

from .fixtures import make_latr_fixture, tiny_latr_yaml
from .test_torch_latr_family_executor import (
    case_overrides,
    check_cli,
    check_eval,
    check_pool,
    check_predict,
    check_two_epochs,
    serve_all,
    serving_requests,
    train_pair,
)


@pytest.fixture(scope="module", params=("phoneme_latr",))
def trained(request, tmp_path_factory):
    return train_pair(request.param, tmp_path_factory)


def test_two_epochs_match_the_jax_executor(trained):
    check_two_epochs(trained)


def test_predict_results_json_matches_the_jax_executor(trained):
    check_predict(trained)


def test_eval_mode_matches_the_jax_executor(trained):
    check_eval(trained)


def test_pool_decode_gives_the_batch_answers(trained):
    check_pool(trained[3])


@pytest.mark.parametrize("case", ("phoneme_latr",))
def test_cli_trains_evaluates_and_predicts_on_the_cpu(case, tmp_path):
    check_cli(case, tmp_path)


@pytest.fixture
def one_thread():
    """Tiny matrices gain nothing from threads, and the suite's parallel
    workers oversubscribe the cores: one intra-op thread for the gate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_phoneme_latr_memorization_gate_and_serving(tmp_path, one_thread):
    """PhonemeLaTr learns the fixture's answers: every decoded validation
    answer equals the structured tokenizer's round trip of its ground truth
    (lowercased, diacritics included); and the serving engine, given the
    structured tokenizer, answers what ``infer`` does."""
    from phoneme_vqa_torch.tokenizers import StructuredPhonemeTokenizer

    paths = make_latr_fixture(str(tmp_path), n_rows=96)
    kw = case_overrides(paths, "phoneme_latr", SAVE=False, TRAIN_BATCH_SIZE=8,
                        warmup_step=10, LR=3e-3, vocab_path=str(tmp_path / "vocab.json"))
    config = t_config.Config(dict(get_config(tiny_latr_yaml(paths, str(tmp_path / "ck"), **kw))))
    ex = T_EXECUTORS.get(config.EXECUTOR)(config, "train", device="cpu")
    losses = [ex._train_epoch(epoch) for epoch in range(1, 21)]
    gens = ex.infer(ex.val_data, 8, config.max_eval_length)
    tok = StructuredPhonemeTokenizer(vocab_path=str(tmp_path / "vocab.json"))
    want = [tok.decode(tok.encode(a, 40)) for a in ex.val_answer]
    assert "quán phở hà nội" in want and "số 5 nguyễn huệ" in want
    assert losses[-1] < losses[0] * 0.5, losses
    assert gens == want, list(zip(gens, want))

    answers = serve_all(ex, config, serving_requests(config))
    assert answers == gens
