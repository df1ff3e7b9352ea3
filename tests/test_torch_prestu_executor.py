"""The port's PreSTU executor against the JAX package's, on the CPU in f32
at tiny widths (``tiny_latr_yaml``): trained two epochs from the JAX
executor's initial parameters, it gives the same per-epoch losses, metric
dicts, eval-mode scores and ``results.json`` (helpers in
``tests/test_torch_latr_family_executor.py``); the CLI; the PreSTU
featurization element-equal to the JAX dataset's; PreSTU's ViT trains
(every parameter a gradient, optimizer state, a move); the serving engine's
answers equal ``infer``'s. CustomizedPreSTU and PhonemePreSTU have files of
their own.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from phoneme_vqa_torch.data import adapters as t_adapters
from phoneme_vqa_torch.data import synthetic as t_synthetic
from phoneme_vqa_torch.data.prestu import PreSTUDataset as TPreSTUDataset
from phoneme_vqa_torch.data.prestu import fuse_question_ocr as t_fuse
from phoneme_vqa_torch.tokenizers.backbone import FallbackSubwordTokenizer as TTok
from phoneme_vqa_torch.utils.registry import EXECUTORS as T_EXECUTORS
from phoneme_vqa_tpu.data.adapters import textlayout_ocr_adapt as j_ocr_adapt
from phoneme_vqa_tpu.data.prestu import PreSTUDataset as JPreSTUDataset
from phoneme_vqa_tpu.data.prestu import fuse_question_ocr as j_fuse
from phoneme_vqa_tpu.tokenizers.backbone import FallbackSubwordTokenizer as JTok

from .fixtures import OCR_WORDS, QUESTIONS, make_latr_fixture
from .test_torch_latr_family_executor import (
    check_cli,
    check_eval,
    check_predict,
    check_two_epochs,
    check_serving,
    configs,
    train_pair,
)

PRESTU_CASES = ("prestu",)


@pytest.fixture(scope="module", params=PRESTU_CASES)
def trained(request, tmp_path_factory):
    return train_pair(request.param, tmp_path_factory)


def test_two_epochs_match_the_jax_executor(trained):
    check_two_epochs(trained)


def test_predict_results_json_matches_the_jax_executor(trained):
    check_predict(trained)


def test_eval_mode_matches_the_jax_executor(trained):
    check_eval(trained)


@pytest.mark.parametrize("case", PRESTU_CASES)
def test_cli_trains_evaluates_and_predicts_on_the_cpu(case, tmp_path):
    check_cli(case, tmp_path)


class _Unsplittable(str):
    """An OCR word the tokenizer cannot take."""

    def split(self, *a, **kw):
        raise ValueError("unsplittable")


@pytest.mark.parametrize("max_q,max_ocr", [(8, 12), (4, 3), (30, 100)])
def test_fuse_question_ocr_equals_jax(max_q, max_ocr):
    t_tok, j_tok = TTok(512), JTok(512)
    cases = [(q, words) for q in QUESTIONS for words in OCR_WORDS + [[]]]
    cases.append((QUESTIONS[0], ["quán", _Unsplittable("phở")]))
    for question, words in cases:
        got = t_fuse(t_tok, question, words, max_q, max_ocr)
        want = j_fuse(j_tok, question, words, max_q, max_ocr)
        assert got == want, (question, words)
        ids, mask = got
        assert len(ids) == len(mask) == max_q + max_ocr
        assert ids[0] == t_tok.pad_token_id and mask[0] == 1
    # an OCR list that fails to tokenize contributes no tokens
    ids, mask = t_fuse(t_tok, QUESTIONS[0], ["quán", _Unsplittable("phở")], 8, 12)
    assert ids[: sum(mask)].count(t_tok.eos_token_id) == 2
    assert ids == t_fuse(t_tok, QUESTIONS[0], [], 8, 12)[0]


@pytest.fixture(scope="module")
def fixture_paths(tmp_path_factory):
    return make_latr_fixture(tmp_path_factory.mktemp("prestu_data"))


@pytest.mark.parametrize("max_ocr_element,max_ocr_length", [(8, 12), (2, 3)])
def test_prestu_dataset_element_equal(fixture_paths, max_ocr_element, max_ocr_length):
    kw = dict(max_ocr_element=max_ocr_element, max_ocr_length=max_ocr_length,
              max_input_length=8, max_output_length=10)
    qa = pd.read_csv(fixture_paths["train"])[["image_id", "question", "answer", "filename"]]
    want = JPreSTUDataset(qa, j_ocr_adapt(fixture_paths["ocr"]), JTok(512),
                          fixture_paths["img"], **kw).dataset
    rows = t_synthetic.read_qa_csv(fixture_paths["train"])
    got = TPreSTUDataset(rows, t_adapters.textlayout_ocr_adapt(fixture_paths["ocr"]), TTok(512),
                         fixture_paths["img"], **kw).dataset
    assert len(got) == len(want) == 12
    assert sorted(got.arrays) == sorted(want.arrays)
    for name, array in want.arrays.items():
        assert got.arrays[name].dtype == array.dtype, name
        np.testing.assert_array_equal(got.arrays[name], array, err_msg=name)
    assert got.arrays["input_ids"].shape == (12, 8 + max_ocr_length)
    idx = np.arange(len(want))[::-1]
    np.testing.assert_array_equal(got.gather(idx)["pixel_values"],
                                  want.gather(idx)["pixel_values"])


def test_prestu_trains_its_vit(fixture_paths, tmp_path):
    """One PreSTU step: every ViT parameter holds optimizer state, gets a
    finite, nonzero gradient and moves."""
    _, t_cfg = configs(fixture_paths, str(tmp_path), "prestu", SAVE=False)
    ex = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "train", device="cpu")
    vit = [n for n, _ in ex.model.named_parameters() if n.startswith("vit.")]
    assert len(vit) > 10 and all(n in ex.state.opt_state["mu"] for n in vit)
    start = {n: ex.state.params[n].clone() for n in vit}
    loss = ex.forward_loss(ex._to_device(ex.train_data.gather(np.arange(8))))
    loss.backward()
    for n, p in ex.model.named_parameters():
        if n in start:
            assert p.grad is not None and torch.isfinite(p.grad).all(), n
            assert p.grad.abs().max() > 0, n
    ex.apply_gradients()
    for n in vit:
        assert not torch.equal(ex.state.params[n], start[n]), n


def test_serving_engine_answers_equal_infer(trained):
    """The engine featurizes PreSTU requests (question and OCR fused)."""
    check_serving(trained)
