"""The port across processes, end to end on the CPU over gloo (the rest
of the mesh tests: ``tests/test_torch_parallel.py``):

* ``torchrun --nproc-per-node 4 -m phoneme_vqa_torch.run`` with MESH
  {data: 2, model: 2} trains, evaluates and predicts as one process does
  (``results.json`` equal, the epochs' losses within rtol 1e-5);
* one process's checkpoint resumed on DP 2 x TP 2 with ZeRO-1 and written
  back bit for bit, then restored in one process;
* EMA_DECAY, REMAT, OPT_MU_DTYPE and SAVE_EVERY_STEPS on DP 2 x TP 2 as one
  process's;
* ``dryrun_multichip(4)``.
"""

import os

import numpy as np
import torch

from phoneme_vqa_torch import config as t_config
from phoneme_vqa_torch import train  # noqa: F401  (registers the executors)
from phoneme_vqa_torch.dryrun import dryrun_multichip, run_mesh
from phoneme_vqa_torch.utils.registry import EXECUTORS as T_EXECUTORS
from phoneme_vqa_tpu.config import get_config

import pytest

from .fixtures import make_latr_fixture, tiny_latr_yaml
from .test_torch_parallel import LOSS_RTOL, assert_masters


@pytest.fixture(scope="module")
def latr_paths(tmp_path_factory):
    return make_latr_fixture(tmp_path_factory.mktemp("par_cli_latr"))


def test_fine_tuning_knobs_compose_with_the_mesh(latr_paths, tmp_path):
    """EMA_DECAY, REMAT, OPT_MU_DTYPE and SAVE_EVERY_STEPS at DP 2 x TP 2: the
    epoch, the masters, the average and the bf16 first moment as one
    process's (each knob against JAX: tests/test_torch_train_knobs.py)."""
    knobs = dict(EMA_DECAY=0.9, REMAT=True, OPT_MU_DTYPE="bfloat16", SAVE_EVERY_STEPS=1)
    cfg = t_config.Config(get_config(tiny_latr_yaml(latr_paths, str(tmp_path / "one"),
                                                    **knobs)))
    one = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")
    record = run_mesh({**cfg, "SAVE_PATH": str(tmp_path / "mesh"),
                       "MESH": {"data": 2, "model": 2}}, 4, device="cpu", epochs=1, steps=0,
                      beams=0)
    np.testing.assert_allclose(record["losses"][0], one._train_epoch(1), rtol=LOSS_RTOL)
    saved = torch.load(record["checkpoint"], weights_only=True)
    assert_masters(saved["params"], {n: t.detach() for n, t in one.state.params.items()})
    assert_masters(saved["ema_params"], one.state.ema_params)
    assert {m.dtype for m in saved["opt_state"]["mu"].values()} == {torch.bfloat16}
    assert saved["step"] == one.state.step == 1


def test_checkpoint_moves_one_process_to_mesh_and_back(latr_paths, tmp_path):
    """One process's checkpoint, resumed on DP 2 x TP 2 with ZeRO-1 and
    written back, is the same file's tensors bit for bit; restored in one
    process, it resumes full state."""
    cfg = t_config.Config(get_config(tiny_latr_yaml(latr_paths, str(tmp_path / "ck"),
                                                    NUM_EPOCHS=1)))
    one = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")
    one._train_epoch(1)
    one.state.epoch = 1
    one._save_checkpoint("last")
    path = os.path.join(cfg.SAVE_PATH, "last_ckp")
    before = torch.load(path, weights_only=True)
    record = run_mesh({**cfg, "MESH": {"data": 2, "model": 2, "zero1": True}}, 4, device="cpu",
                      steps=0, beams=0)
    after = torch.load(path, weights_only=True)
    assert record["restored_bit_for_bit"] and record["restored_opt_bit_for_bit"]
    for key in ("params",):
        for name, value in before[key].items():
            assert torch.equal(after[key][name], value), name
    for part in ("mu", "nu"):
        for name, value in before["opt_state"][part].items():
            assert torch.equal(after["opt_state"][part][name], value), (part, name)
    assert after["step"] == before["step"] and after["epoch"] == before["epoch"]
    again = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")
    assert again.state.step == before["step"]
    for name, value in before["params"].items():
        assert torch.equal(again.state.params[name], value), name


def test_torchrun_mesh_trains_evaluates_and_predicts_as_one_process(tmp_path):
    """``torchrun --nproc-per-node 4 -m phoneme_vqa_torch.run`` over gloo
    with MESH {data: 2, model: 2}: train (2 epochs), eval and predict; the
    results.json and the per-epoch metrics equal one process's."""
    import json
    import subprocess
    import sys

    from phoneme_vqa_torch.data import synthetic
    from phoneme_vqa_torch.dryrun import tiny_latr_config

    paths = synthetic.make_latr_fixture(tmp_path / "fx")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), OMP_NUM_THREADS="1")
    out = {}
    for name, mesh in (("one", None), ("mesh", {"data": 2, "model": 2})):
        cfg = tiny_latr_config(paths, str(tmp_path / name), NUM_EPOCHS=2,
                               **({"MESH": mesh} if mesh else {}))
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(cfg))
        launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc-per-node", "4"] if mesh else [sys.executable])
        for mode in ("train", "eval", "predict"):
            done = subprocess.run(launch + ["-m", "phoneme_vqa_torch.run", "--config-file",
                                            str(path), "--mode", mode, "--device", "cpu"],
                                  env=env, capture_output=True, text=True, timeout=300)
            assert done.returncode == 0, done.stderr[-3000:]
        with open(tmp_path / name / "results.json", encoding="utf-8") as f:
            results = json.load(f)
        with open(tmp_path / name / "metrics.jsonl", encoding="utf-8") as f:
            metrics = [json.loads(line) for line in f]
        out[name] = results, metrics
    assert out["mesh"][0] == out["one"][0]
    assert len(out["mesh"][1]) == len(out["one"][1]) == 2
    for got, want in zip(out["mesh"][1], out["one"][1]):
        np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=LOSS_RTOL)
        assert got["Accuracy"] == want["Accuracy"]


def test_dryrun_multichip_four_processes(tmp_path):
    record = dryrun_multichip(4, device="cpu", root=str(tmp_path))
    assert len(record["ranks"]) == 4
    assert {r["mesh"].split(" over")[0] for r in record["ranks"]} == {"data 2 x model 2"}
