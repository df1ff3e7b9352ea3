"""OCR and object-region feature adapters without pandas (counterparts of
``phoneme_vqa_tpu/data/adapters.py``).

A directory of per-image pickled ``.npy`` dicts becomes a store keyed by
``float(filename_stem)``:

* OCR files hold ``texts`` + ``boxes``; the OCR store is
  ``{image_id: (texts, bboxes)}``, boxes scaled by (w_scale, h_scale) with
  width and height 1, as boxes arrive normalized to [0, 1];
* object files hold ``object_list`` + ``region_boxes`` + the image's own
  ``height``/``width``; the object store is ``{image_id: (labels, boxes)}``,
  boxes divided by that width/height and scaled by (w_scale, h_scale).

With ``cache_dir`` (``FEATURE_CACHE``) an adapted store is kept on disk
per (directory fingerprint, adapter, scales) and read back on the next
run (``feature_cache.cached_adapt``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from .feature_cache import cached_adapt

OcrStore = Dict[float, Tuple[List[str], List[List[float]]]]
ObjStore = OcrStore  # {image_id: (labels, boxes)}


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


def textlayout_ocr_adapt(ocr_root: str, h_scale: float = 1000, w_scale: float = 1000,
                         cache_dir=None) -> OcrStore:
    return cached_adapt(ocr_root, cache_dir, f"ocr|{h_scale}|{w_scale}",
                        lambda: _adapt_ocr(ocr_root, h_scale, w_scale))


def textlayout_obj_adapt(obj_root: str, h_scale: float = 1000, w_scale: float = 1000,
                         cache_dir=None) -> ObjStore:
    return cached_adapt(obj_root, cache_dir, f"obj|{h_scale}|{w_scale}",
                        lambda: _adapt_obj(obj_root, h_scale, w_scale))


def _adapt_ocr(ocr_root: str, h_scale: float, w_scale: float) -> OcrStore:
    store: OcrStore = {}
    for fname in os.listdir(ocr_root):
        record = _load_npy_dict(os.path.join(ocr_root, fname))
        store[float(fname[:-4])] = (
            list(record["texts"]),
            _scale_boxes(record["boxes"], 1.0, 1.0, w_scale, h_scale),
        )
    return store


def _adapt_obj(obj_root: str, h_scale: float, w_scale: float) -> ObjStore:
    store: ObjStore = {}
    for fname in os.listdir(obj_root):
        record = _load_npy_dict(os.path.join(obj_root, fname))
        store[float(fname[:-4])] = (
            list(record["object_list"]),
            _scale_boxes(record["region_boxes"], float(record["width"]),
                         float(record["height"]), w_scale, h_scale),
        )
    return store
