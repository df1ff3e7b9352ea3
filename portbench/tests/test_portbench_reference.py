"""Whole runs of each cell on the CPU at a tiny width, in float32: the
program's outputs agree with the plain reference, and a run whose timed
path is broken underneath reads not correct."""

import json

import pytest

from .conftest import run_tiny

# float32 on both sides: the port and the reference agree to round-off
TIGHT = {"served_gap": 1e-4, "loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-3,
         "frozen_moved": 0.0}


def _tighten(root, cell):
    path = root / "portbench" / "workloads" / f"{cell}.json"
    w = json.loads(path.read_text())
    w["limits"] = {k: TIGHT[k] for k in w["limits"]}
    path.write_text(json.dumps(w))


@pytest.mark.parametrize("cell,trace", [("latr-base.serve-flood", 0), ("latr-base.serve-flood", 1),
                                        ("latr-base.train", 0), ("phonemesal-base.train", 0)])
def test_the_port_agrees_with_the_reference(tiny_bench, cell, trace):
    _tighten(tiny_bench, cell)
    result, lines = run_tiny(cell, trace=trace)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


def _alter_a_token(driver):
    ex = driver.engine.executor
    decode = ex._decode_rows

    def altered(rows):
        rows = [list(r) for r in rows]
        for r in rows:
            r[3] = (r[3] + 1) % 7 + 3
        return decode(rows)

    ex._decode_rows = altered


def _state_unchanged(driver):
    ex = driver.ex

    def no_update(grads=None):
        ex._collect_grads()
        ex.state.step += 1

    ex.apply_gradients = no_update


def _half_batch(driver):
    ex = driver.ex
    step = ex.train_step
    ex.train_step = lambda batch: step({k: v[: len(v) // 2] for k, v in batch.items()})


@pytest.mark.parametrize("cell,fault", [
    ("latr-base.serve-flood", _alter_a_token),
    ("latr-base.train", _state_unchanged),
    ("latr-base.train", _half_batch),
    ("phonemesal-base.train", _state_unchanged),
    ("phonemesal-base.train", _half_batch),
])
def test_a_broken_timed_path_is_not_correct(tiny_bench, cell, fault):
    _tighten(tiny_bench, cell)
    result, lines = run_tiny(cell, faults=fault)
    assert not result["correct"], lines


@pytest.mark.parametrize("cell", ["latr-base.serve-flood", "latr-base.train",
                                  "phonemesal-base.train"])
def test_the_control_reads_at_least_the_program(tiny_bench, cell):
    """The float8 control (``control.py``) at a size a test run holds: it
    reads no number below the program's, and a train cell's reads some
    number above it (at this width in float32 a served token is far from
    any near-tie, so float8 may pick the same ones)."""
    from portbench import control

    result, _ = run_tiny(cell, extra=control.controls)
    ctl = result["extra"]["control"]
    values = {k: v["value"] for k, v in result["checks"].items() if k != "frozen_moved"}
    assert all(ctl[k] >= v for k, v in values.items()), (ctl, values)
    if "train" in cell:
        assert any(ctl[k] > 3 * v for k, v in values.items()), (ctl, values)
        assert result["extra"]["half_batch"]["loss_gap"] > values["loss_gap"]
