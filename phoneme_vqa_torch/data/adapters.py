"""OCR feature adapter without pandas.

A directory of per-image pickled ``.npy`` dicts holding ``texts`` + ``boxes``
becomes an OCR store ``{image_id: (texts, bboxes)}`` keyed by
``float(filename_stem)``. Boxes are scaled by (w_scale, h_scale) with width
and height 1, as boxes arrive normalized to [0, 1] (counterpart of
``phoneme_vqa_tpu/data/adapters.py: textlayout_ocr_adapt``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

OcrStore = Dict[float, Tuple[List[str], List[List[float]]]]


def _load_npy_dict(path: str) -> dict:
    return np.load(path, allow_pickle=True).tolist()


def _scale_boxes(boxes, width: float, height: float, w_scale: float, h_scale: float):
    out = []
    for x0, y0, x1, y1 in np.asarray(boxes, dtype=np.float64).reshape(-1, 4):
        out.append(
            [
                float(x0 / width * w_scale),
                float(y0 / height * h_scale),
                float(x1 / width * w_scale),
                float(y1 / height * h_scale),
            ]
        )
    return out


def textlayout_ocr_adapt(ocr_root: str, h_scale: float = 1000, w_scale: float = 1000) -> OcrStore:
    store: OcrStore = {}
    for fname in os.listdir(ocr_root):
        record = _load_npy_dict(os.path.join(ocr_root, fname))
        store[float(fname[:-4])] = (
            list(record["texts"]),
            _scale_boxes(record["boxes"], 1.0, 1.0, w_scale, h_scale),
        )
    return store
