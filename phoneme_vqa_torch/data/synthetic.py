"""Synthetic fixtures: tiny QA CSVs + OCR/image (LaTr) and OCR/object
feature (SaL) ``.npy`` trees in the on-disk formats the data layer reads.
Without pandas, they write the same files as
``phoneme_vqa_tpu/data/synthetic.py: make_latr_fixture`` and
``make_sal_fixture`` at their defaults."""

from __future__ import annotations

import csv
import os

import numpy as np

QUESTIONS = [
    "cái gì màu đỏ",
    "quán tên gì",
    "mấy giờ mở cửa",
    "địa chỉ ở đâu",
    "giá bao nhiêu",
    "số điện thoại là gì",
]
ANSWERS = [
    "biển hiệu",
    "quán phở hà nội",
    "7 giờ sáng",
    "số 5 nguyễn huệ",
    "30 nghìn đồng",
    "0123456789",
]
OCR_WORDS = [
    ["quán", "phở", "hà", "nội"],
    ["mở", "cửa", "7", "giờ"],
    ["số", "5", "nguyễn", "huệ"],
]
QA_FIELDS = ("image_id", "question", "answer", "filename")


def _write_qa_csvs(root: str, n_images: int, n_rows: int) -> dict:
    rows = [
        {
            "image_id": float(r % n_images),
            "question": QUESTIONS[r % len(QUESTIONS)],
            "answer": ANSWERS[r % len(ANSWERS)],
            "filename": f"{r % n_images}.jpg",
        }
        for r in range(n_rows)
    ]
    paths = {}
    for split, sl in (("train", slice(0, n_rows)), ("val", slice(0, 6)),
                      ("predict", slice(0, 6))):
        p = os.path.join(root, f"qa_{split}.csv")
        with open(p, "w", newline="", encoding="utf-8") as f:
            writer = csv.DictWriter(f, fieldnames=QA_FIELDS, lineterminator="\n")
            writer.writeheader()
            writer.writerows(rows[sl])
        paths[split] = p
    return paths


def make_latr_fixture(root, n_images: int = 3, n_rows: int = 12, image_hw: int = 32):
    """Creates ocr/ img/ dirs + train/val/predict CSVs. Returns dict of paths."""
    root = str(root)
    ocr_dir = os.path.join(root, "ocr")
    img_dir = os.path.join(root, "img")
    os.makedirs(ocr_dir, exist_ok=True)
    os.makedirs(img_dir, exist_ok=True)

    rng = np.random.RandomState(7)
    for i in range(n_images):
        words = OCR_WORDS[i % len(OCR_WORDS)]
        boxes = rng.uniform(0.05, 0.9, size=(len(words), 4))
        boxes[:, 2:] = np.clip(boxes[:, :2] + 0.05, 0, 0.999)  # x1>x0, y1>y0
        np.save(
            os.path.join(ocr_dir, f"{i}.npy"),
            {"texts": words, "boxes": boxes},
            allow_pickle=True,
        )
        img = rng.randn(1, 3, image_hw, image_hw).astype(np.float32)
        np.save(os.path.join(img_dir, f"{float(i)}.npy"), {"image": img},
                allow_pickle=True)

    paths = _write_qa_csvs(root, n_images, n_rows)
    paths["ocr"] = ocr_dir
    paths["img"] = img_dir
    paths["root"] = root
    return paths


def make_sal_fixture(root, n_images: int = 3, n_rows: int = 12, n_ocr_words=None,
                     region_hidden: int = 64):
    """OCR feature dir (texts/boxes/det+rec features, 256 + 256) + object
    feature dir (object_list/region_boxes/height/width/region_features) +
    CSVs. ``n_ocr_words`` (default: the 4 words of ``OCR_WORDS``) cycles
    through the OCR vocabulary; ``region_hidden`` is the region-feature
    width."""
    root = str(root)
    ocr_dir = os.path.join(root, "ocr_features")
    obj_dir = os.path.join(root, "obj_features")
    os.makedirs(ocr_dir, exist_ok=True)
    os.makedirs(obj_dir, exist_ok=True)

    rng = np.random.RandomState(11)
    for i in range(n_images):
        words = OCR_WORDS[i % len(OCR_WORDS)]
        if n_ocr_words is not None:
            words = [OCR_WORDS[(i + w // 4) % len(OCR_WORDS)][w % 4] for w in range(n_ocr_words)]
        boxes = rng.uniform(0.05, 0.85, size=(len(words), 4))
        boxes[:, 2:] = np.clip(boxes[:, :2] + 0.1, 0, 0.999)
        np.save(
            os.path.join(ocr_dir, f"{i}.npy"),
            {
                "texts": words,
                "boxes": boxes,
                "det_features": rng.randn(len(words), 256).astype(np.float32),
                "rec_features": rng.randn(len(words), 256).astype(np.float32),
            },
            allow_pickle=True,
        )
        objs = ["người", "xe", "bảng"][: 2 + i % 2]
        np.save(
            os.path.join(obj_dir, f"{i}.npy"),
            {
                "object_list": objs,
                "region_boxes": rng.uniform(10, 200, size=(len(objs), 4)),
                "height": 224,
                "width": 224,
                "region_features": rng.randn(len(objs), region_hidden).astype(np.float32),
            },
            allow_pickle=True,
        )
    paths = {"ocr_features": ocr_dir, "obj_features": obj_dir, "root": root}
    paths.update(_write_qa_csvs(root, n_images, n_rows))
    return paths


def read_qa_csv(path: str):
    """QA rows of a CSV as dicts, ``image_id`` as float."""
    with open(path, newline="", encoding="utf-8") as f:
        return [
            {
                "image_id": float(r["image_id"]),
                "question": r["question"],
                "answer": r["answer"],
                "filename": r["filename"],
            }
            for r in csv.DictReader(f)
        ]
