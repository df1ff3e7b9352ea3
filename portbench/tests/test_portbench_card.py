"""On the card (``gpu`` marker; skipped without one): each cell's control,
at the cell's own size, fails the cell's limits while the program passes
them. Run on a machine with a card:

    python -m pytest portbench/tests/test_portbench_card.py -m gpu
"""

import argparse
import time

import pytest

CELLS = ["latr-base.serve-flood", "phonemesal-base.train", "latr-base.train"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(card, cell):
    from portbench import bench, control, manifest

    args = argparse.Namespace(workload=cell, seed=2**31 + 11, seconds=4.0, trace=0)
    result, lines = bench.run_cell(args, card, time.time(), extra=control.controls)
    assert result["correct"], lines
    limits = manifest.workload(cell)["limits"]
    ctl = result["extra"]["control"]
    assert any(ctl[k] > limit for k, limit in limits.items()), (ctl, limits)
