"""Convert a reference checkpoint (a ``torch.save`` .pth of the original
torch repository) into the port's checkpoint, so a trained reference model
evaluates, predicts and serves here (counterpart of
``scripts/import_reference_ckpt.py``):

    python -m phoneme_vqa_torch.import_reference_ckpt --config-file F \\
        --ckpt best_ckp.pth [--name best] [--allow-partial] [--unsafe-load] \\
        [--device cuda|cpu]

The converted ``{SAVE_PATH}/{name}_ckp`` holds the parameters (f32
masters) with the .pth's step, epoch and best_score, and no optimizer state
(torch Adam moments are not this optimizer's): ``--mode eval``, ``--mode
predict`` and ``serve`` load it as they load any checkpoint, and ``--mode
train`` resumes its parameters with a fresh optimizer. A tensor that does
not map stops the conversion unless ``--allow-partial``. The .pth is read
with ``weights_only=True``; ``--unsafe-load`` permits full unpickling,
which runs code from the file.

The customized families must point ``vocab_save_path`` at the reference's
trained ``bpevocab.json`` so the decoder's head sizes match.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import train  # noqa: F401  (registers the executors)
from .config import get_config
from .models.hf_import import ImportReport, import_reference_state_dict
from .utils.logger import get_logger
from .utils.registry import EXECUTORS

log = get_logger(__name__)


def load_reference_ckpt(path: str, unsafe: bool = False) -> dict:
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        if not unsafe:
            raise SystemExit(
                f"Safe load (weights_only=True) failed for {path}: {e}\n"
                "If you trust this checkpoint, re-run with --unsafe-load to fall back to full "
                "unpickling (executes code from the file).")
        log.warning(f"weights_only=True load failed ({e}); falling back to UNSAFE "
                    f"torch.load(weights_only=False) on {path} per --unsafe-load")
        return torch.load(path, map_location="cpu", weights_only=False)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m phoneme_vqa_torch.import_reference_ckpt")
    p.add_argument("--config-file", required=True)
    p.add_argument("--ckpt", required=True, help="reference .pth checkpoint")
    p.add_argument("--name", default="best", choices=["best", "last"])
    p.add_argument("--allow-partial", action="store_true",
                   help="write even if some tensors failed to map")
    p.add_argument("--unsafe-load", action="store_true",
                   help="permit torch.load(weights_only=False), which can execute code "
                        "embedded in the .pth")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None) -> ImportReport:
    args = parse_args(argv)
    config = get_config(args.config_file)
    ex = EXECUTORS.get(config.EXECUTOR)(config, mode="serve", device=args.device)
    ckpt = load_reference_ckpt(args.ckpt, unsafe=args.unsafe_load)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() if hasattr(v, "numpy")
          else np.asarray(v) for k, v in sd.items()}
    report = ImportReport()
    # keys the checkpoint does not fill keep the seeded init
    params = import_reference_state_dict(ex._ensure_params(), sd, report=report)
    report.unfilled += sorted(n for n, t in params.items() if t is ex.state.params[n])
    report.log_summary("reference checkpoint")
    if report.failed and not args.allow_partial:
        report.raise_if_failed("reference checkpoint")
    ex.ckpt.save(args.name, {
        "params": {n: t.detach().float().cpu() for n, t in params.items()},
        "step": int(ckpt.get("step", 0)),
        "epoch": int(ckpt.get("epoch", 0)),
        "best_score": float(ckpt.get("best_score", 0.0)),
    })
    log.info(f"Converted {args.ckpt} -> {ex.ckpt._path(args.name)} "
             f"({len(report.mapped)} tensors mapped)")
    return report


if __name__ == "__main__":
    main()
