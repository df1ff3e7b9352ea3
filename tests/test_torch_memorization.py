"""The port's memorisation gate: the counterpart of
``tests/test_memorization.py``'s LaTr gate, on the CPU at tiny widths."""

import pytest
import torch

from phoneme_vqa_torch import config as t_config
from phoneme_vqa_torch.train.latr_executor import LaTrExecutor
from phoneme_vqa_tpu.config import get_config

from .fixtures import make_latr_fixture, tiny_latr_yaml


@pytest.fixture
def one_thread():
    """Tiny matrices gain nothing from threads, and the suite's parallel
    workers oversubscribe the cores: one intra-op thread for the gate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_memorization_gate(tmp_path, one_thread):
    """The counterpart of tests/test_memorization.py's LaTr gate, at a size
    that runs in seconds: the loss falls and every validation answer is
    learned. The port's seeded init is not flax's: it gets 20 epochs where
    the JAX gate takes 12 (at 12 it has 5 of the 6 answers, at 16-24 all)."""
    paths = make_latr_fixture(str(tmp_path), n_rows=96)
    j_config = get_config(tiny_latr_yaml(paths, str(tmp_path / "ck"), NUM_EPOCHS=1, SAVE=False,
                                         LR=3e-3, TRAIN_BATCH_SIZE=8, max_eval_length=12))
    ex = LaTrExecutor(t_config.Config(dict(j_config)), "train", device="cpu")
    losses = [ex._train_epoch(epoch) for epoch in range(1, 21)]
    gens = ex.infer(ex.val_data, 8, 12)
    acc = sum(g == a for g, a in zip(gens, ex.val_answer)) / len(gens)
    assert losses[-1] < losses[0] * 0.7, losses
    assert acc == 1.0, list(zip(gens, ex.val_answer))
