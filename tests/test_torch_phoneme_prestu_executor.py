"""The port's PhonemePreSTU executor (structured triple answers) against the JAX package's, on
the CPU in f32 at tiny widths (``tiny_latr_yaml``): trained two epochs from
the JAX executor's initial parameters, it gives the same per-epoch losses,
metric dicts, eval-mode scores and ``results.json``; the CLI trains,
evaluates and predicts on the CPU; the serving engine, given the
executor's answer tokenizer, answers what ``infer`` does. Helpers in
``tests/test_torch_latr_family_executor.py``.
"""

import pytest

from .test_torch_latr_family_executor import (
    check_cli,
    check_eval,
    check_predict,
    check_serving,
    check_two_epochs,
    train_pair,
)


@pytest.fixture(scope="module", params=("phoneme_prestu",))
def trained(request, tmp_path_factory):
    return train_pair(request.param, tmp_path_factory)


def test_two_epochs_match_the_jax_executor(trained):
    check_two_epochs(trained)


def test_predict_results_json_matches_the_jax_executor(trained):
    check_predict(trained)


def test_eval_mode_matches_the_jax_executor(trained):
    check_eval(trained)


@pytest.mark.parametrize("case", ("phoneme_prestu",))
def test_cli_trains_evaluates_and_predicts_on_the_cpu(case, tmp_path):
    check_cli(case, tmp_path)


def test_serving_engine_answers_equal_infer(trained):
    check_serving(trained)
