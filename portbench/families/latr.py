"""LaTr under the stock T5 decoder (``LaTr_Executor``)."""

from __future__ import annotations

from portbench import flops
from portbench.reference import latr as reference
from portbench.reference import text

FIXTURE = "latr"  # the fixture's on-disk layout: portbench/layouts/latr.py


def port_config(c: dict, paths: dict, save_path: str, seed: int) -> dict:
    """The port's configuration: the file's keys, the fixture's paths."""
    return {**c["config"], "ocr_path": paths["ocr"], "base_img_path": paths["img"],
            "qa_train_path": paths.get("train", ""), "qa_val_path": paths.get("val", ""),
            "qa_predict_path": paths.get("val", ""), "SAVE_PATH": save_path,
            "SEED": seed % 2**31}


def reference_inputs(fixture, rows, c: dict) -> dict:
    tok = text.SubwordTokenizer(c["t5_vocab_size"])
    return text.latr_inputs(tok, rows, text.load_records(fixture.paths["ocr"]),
                            fixture.paths["img"], c)


def decode_start(c: dict) -> int:
    return 0  # T5's decoder start: pad


def train_step_flops(c: dict) -> float:
    return flops.latr_train_step_flops(c, c["TRAIN_BATCH_SIZE"])


def train_calls(c: dict):
    return flops.latr_train_calls(c, c["TRAIN_BATCH_SIZE"])


def served_row_flops(c: dict, steps: int) -> float:
    return flops.latr_served_row_flops(c, steps)


def serve_calls(c: dict, rows: int):
    return flops.latr_serve_calls(c, rows)


def eos_id(c: dict) -> int:
    return text.EOS


def lr_schedule(c: dict, n_rows: int):
    """The LaTr family's: the LR decayed 0.95 an epoch."""
    per_epoch = max(1, n_rows // int(c["TRAIN_BATCH_SIZE"]))
    return lambda step: c["LR"] * 0.95 ** (step // per_epoch)
