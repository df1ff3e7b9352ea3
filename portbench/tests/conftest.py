"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark's
data files with the configurations cut to a tiny width, so that whole runs
of a cell go through on the CPU."""

import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PORTBENCH)

TINY = dict(t5_vocab_size=512, d_model=64, d_kv=16, num_heads=4, d_ff=128,
            num_encoder_layers=2, num_t5_decoder_layers=2, vit_image_size=32,
            vit_patch_size=16, vit_hidden_size=64, vit_num_layers=2, vit_num_heads=4,
            vit_mlp_dim=128, DTYPE="float32")
# the port's custom decoder keeps its FFN at 2048 whatever the width
TINY_SAL = dict(TINY, ocr_hidden=32, obj_hidden=48, num_decoder_layers=2, n_head=4)
TINY_MIX = dict(images=16, rows=64, requests=400, warmup_requests=8, clients=8, val_rows=8)


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """The benchmark's files copied under ``tmp_path`` at tiny sizes, with
    ``portbench.manifest`` reading them; returns the copy's root."""
    import torch
    from portbench import manifest

    torch.set_num_threads(2)
    root = tmp_path / "bench"
    shutil.copytree(PORTBENCH, root / "portbench",
                    ignore=shutil.ignore_patterns(".pycache", "__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for name, over in (("latr-base", TINY), ("phonemesal-base", TINY_SAL)):
        path = root / "portbench" / "configs" / f"{name}.json"
        cf = json.loads(path.read_text())
        cf["config"].update(over)
        path.write_text(json.dumps(cf))
    for path in (root / "portbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update({k: v for k, v in TINY_MIX.items() if k in mix or k == "images"})
        path.write_text(json.dumps(mix))
    monkeypatch.setattr(manifest, "HERE", str(root / "portbench"))
    monkeypatch.setattr(manifest, "ROOT", str(root))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return root


def run_tiny(cell, seed=2**31 + 7, seconds=2.0, trace=0, faults=None, extra=None):
    """One run of ``cell`` on the CPU; (result, check lines)."""
    import argparse
    import time

    import torch
    from portbench import bench

    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
    return bench.run_cell(args, torch.device("cpu"), time.time(), faults=faults, extra=extra)
