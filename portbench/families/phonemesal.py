"""PhonemeSaL: the SaL encoder under a custom decoder over the flat
phoneme vocabulary (``PhonemeSaL_Executor``)."""

from __future__ import annotations

from portbench import flops
from portbench.reference import phonemesal as reference
from portbench.reference import text
from portbench.reference.phoneme_tokenizer import PhonemeTokenizer
from portbench.reference.phonology.compose import preprocess_sentence

FIXTURE = "sal"  # the fixture's on-disk layout: portbench/layouts/sal.py


def port_config(c: dict, paths: dict, save_path: str, seed: int) -> dict:
    return {**c["config"], "base_ocr_feature_path": paths["ocr_features"],
            "base_obj_feature_path": paths["obj_features"],
            "qa_train_path": paths.get("train", ""), "qa_val_path": paths.get("val", ""),
            "qa_predict_path": paths.get("val", ""), "SAVE_PATH": save_path,
            "SEED": seed % 2**31}


def reference_inputs(fixture, rows, c: dict) -> dict:
    tok = text.SubwordTokenizer(c["t5_vocab_size"])
    answers = PhonemeTokenizer()
    return text.sal_inputs(tok, rows, text.load_records(fixture.paths["ocr_features"]),
                           text.load_records(fixture.paths["obj_features"]), c,
                           lambda a, n: answers.encode(preprocess_sentence(a), n))


def decode_start(c: dict) -> int:
    return PhonemeTokenizer().bos_id


def train_step_flops(c: dict) -> float:
    return flops.phonemesal_train_step_flops(c, c["TRAIN_BATCH_SIZE"])


def train_calls(c: dict):
    return flops.phonemesal_train_calls(c, c["TRAIN_BATCH_SIZE"])


def served_row_flops(c: dict, steps: int) -> float:
    return flops.phonemesal_served_row_flops(c, steps)


def serve_calls(c: dict, rows: int):
    return flops.phonemesal_serve_calls(c, rows)


def eos_id(c: dict) -> int:
    return PhonemeTokenizer().eos_id


def lr_schedule(c: dict, n_rows: int):
    """The customized decoders': a linear warmup from LR / 3 to LR over
    ``warmup_step`` steps."""
    warm = max(1, int(c["warmup_step"]))
    return lambda step: c["LR"] * (1 / 3 + (2 / 3) * min(step / warm, 1.0))
