"""The reference's own featurization: the fixture's files read again and
turned into the model inputs, independently of the program.

Frozen copies of the plain rules the port follows (``phoneme_vqa_torch/
tokenizers/backbone.py: FallbackSubwordTokenizer``, ``data/adapters.py``,
``data/latr.py``, ``data/sal.py``): the vit5 sentencepiece files are not in
the repository, so both sides tokenize with the offline subword tokenizer,
whose ids are a hash of each piece.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List

import numpy as np

PAD, EOS = 0, 1
_SPECIALS = {"<pad>": 0, "</s>": 1, "<unk>": 2}
_N_SPECIALS = 3


class SubwordTokenizer:
    """Words split into chunks of at most 4 characters, the first marked
    with "▁"; each chunk's id is a hash of its text (T5 id conventions:
    pad 0, eos 1, unk 2)."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def piece_id(self, piece: str) -> int:
        digest = hashlib.md5(piece.encode("utf-8")).digest()
        return _N_SPECIALS + int.from_bytes(digest[:8], "big") % (self.vocab_size - _N_SPECIALS)

    def word_ids(self, word: str) -> List[int]:
        if word in _SPECIALS:
            return [_SPECIALS[word]]
        chunks = [word[i:i + 4] for i in range(0, len(word), 4)] or [word]
        return [self.piece_id(p) for p in ["▁" + chunks[0]] + chunks[1:]]

    def text_ids(self, text: str) -> List[int]:
        return [i for w in text.split() for i in self.word_ids(w)]

    def prefixed(self, text: str, length: int):
        """``"<pad> " + text`` + eos, cut and padded to ``length``: (ids, mask)."""
        ids = (self.text_ids("<pad> " + text.strip()) + [EOS])[:length]
        return ids + [PAD] * (length - len(ids)), [1] * len(ids) + [0] * (length - len(ids))


def load_records(root: str) -> Dict[float, dict]:
    """``{image_id: record}`` of a directory of pickled ``.npy`` dicts."""
    return {float(f[:-4]): np.load(os.path.join(root, f), allow_pickle=True).tolist()
            for f in os.listdir(root)}


def latr_inputs(tok: SubwordTokenizer, rows, ocr: Dict[float, dict], images: str, c) -> dict:
    """LaTr's inputs for QA ``rows`` (dicts of image_id, question, answer):
    OCR boxes scaled by 1000 as 6-tuples per subword, EOS-closed and padded;
    the image's pixels; question and answer "<pad> "-prefixed."""
    n, lo = len(rows), c["max_ocr_length"]
    out = {k: np.zeros((n, c[m]), np.int64) for k, m in (
        ("input_ids", "max_q_length"), ("src_attention_mask", "max_q_length"),
        ("tokenized_ocr", "max_ocr_length"), ("ocr_attention_mask", "max_ocr_length"),
        ("label_ids", "max_a_length"), ("label_attention_mask", "max_a_length"))}
    out["coordinates"] = np.zeros((n, lo, 6), np.int64)
    pixels = []
    for i, row in enumerate(rows):
        rec = ocr[float(row["image_id"])]
        words = list(rec["texts"])[:c["max_ocr_element"]]
        boxes = [[float(v) * 1000 for v in b] for b in np.asarray(rec["boxes"], np.float64)]
        ids, sub = [], []
        for w, word in enumerate(words):
            wid = tok.text_ids(word)
            ids += wid
            sub += [w] * len(wid)
        keep = min(len(sub), lo - 1)
        out["tokenized_ocr"][i, :keep + 1] = ids[:keep] + [EOS]
        out["ocr_attention_mask"][i, :keep + 1] = 1
        for p in range(keep):
            x0, y0, x1, y1 = boxes[sub[p]]
            out["coordinates"][i, p] = np.asarray([x0, y0, x1, y1, x1 - x0, y1 - y0],
                                                  np.float64).astype(np.int32)
        out["coordinates"][i, keep] = 1000
        out["input_ids"][i], out["src_attention_mask"][i] = tok.prefixed(
            row["question"], c["max_q_length"])
        out["label_ids"][i], out["label_attention_mask"][i] = tok.prefixed(
            row["answer"], c["max_a_length"])
        rec = np.load(os.path.join(images, f"{float(row['image_id'])}.npy"),
                      allow_pickle=True).tolist()
        img = np.asarray(rec["image"], np.float32)
        pixels.append(img[0] if img.ndim == 4 else img)
    out["pixel_values"] = np.stack(pixels)
    return out


def _stream(tok, words, boxes, length, context_id=None):
    """A word-aligned stream: subword ids (+ the context token per word),
    each with its word's box, EOS-closed and padded; and each position's
    word (-1 for EOS and padding)."""
    ids, word_of = [], []
    for w, word in enumerate(words):
        wid = tok.text_ids(word) + ([] if context_id is None else [context_id])
        ids += wid
        word_of += [w] * len(wid)
    keep = min(len(word_of), length - 1)
    out_ids = ids[:keep] + [EOS] + [PAD] * (length - keep - 1)
    out_boxes = np.zeros((length, 4), np.float32)
    for p in range(keep):
        out_boxes[p] = boxes[word_of[p]]
    out_boxes[keep] = 0.9999
    mask = [1] * (keep + 1) + [0] * (length - keep - 1)
    return out_ids, out_boxes, mask, word_of[:keep]


def sal_inputs(tok: SubwordTokenizer, rows, ocr: Dict[float, dict], obj: Dict[float, dict],
               c, answer_ids) -> dict:
    """SaL's inputs for QA ``rows``: OCR words with a context token each,
    boxes in [0, 1] and det ⊕ rec features per subword; object labels with
    their region boxes (over the image's size) and region features;
    question "<pad> "-prefixed; ``answer_ids(answer, length)`` the labels."""
    n = len(rows)
    lo, lb, lq, la = (c[k] for k in ("max_ocr_length", "max_obj_length", "max_q_length",
                                     "max_a_length"))
    context_id = tok.text_ids(c["context_token"])[0]
    out = {
        "input_ids": np.zeros((n, lq), np.int64), "src_attention_mask": np.zeros((n, lq), np.int64),
        "tokenized_ocr": np.zeros((n, lo), np.int64), "ocr_attention_mask": np.zeros((n, lo), np.int64),
        "ocr_coordinates": np.zeros((n, lo, 4), np.float32),
        "ocr_features": np.zeros((n, lo, c["ocr_hidden"]), np.float32),
        "tokenized_obj": np.zeros((n, lb), np.int64), "obj_attention_mask": np.zeros((n, lb), np.int64),
        "obj_coordinates": np.zeros((n, lb, 4), np.float32),
        "obj_features": np.zeros((n, lb, c["obj_hidden"]), np.float32),
        "label_ids": np.zeros((n, la), np.int64), "label_attention_mask": np.zeros((n, la), np.int64),
    }
    for i, row in enumerate(rows):
        key = float(row["image_id"])
        rec, orec = ocr[key], obj[key]
        words = list(rec["texts"])[:c["max_ocr_element"]]
        boxes = np.asarray(rec["boxes"], np.float64).reshape(-1, 4)[:c["max_ocr_element"]]
        ids, bx, mask, word_of = _stream(tok, words, boxes, lo, context_id)
        out["tokenized_ocr"][i], out["ocr_coordinates"][i], out["ocr_attention_mask"][i] = ids, bx, mask
        feats = np.concatenate([np.asarray(rec["det_features"]), np.asarray(rec["rec_features"])], -1)
        for p, w in enumerate(word_of):
            out["ocr_features"][i, p] = feats[w]
        labels = list(orec["object_list"])[:c["max_obj_element"]]
        scale = np.asarray([orec["width"], orec["height"]] * 2, np.float64)
        oboxes = (np.asarray(orec["region_boxes"], np.float64).reshape(-1, 4) / scale)
        ids, bx, mask, word_of = _stream(tok, labels, oboxes[:c["max_obj_element"]], lb)
        out["tokenized_obj"][i], out["obj_coordinates"][i], out["obj_attention_mask"][i] = ids, bx, mask
        for p, w in enumerate(word_of):
            out["obj_features"][i, p] = np.asarray(orec["region_features"])[w]
        out["input_ids"][i], out["src_attention_mask"][i] = tok.prefixed(row["question"], lq)
        a = answer_ids(row["answer"], la)
        out["label_ids"][i] = a
        out["label_attention_mask"][i] = [int(t != c["answer_pad_id"]) for t in a]
    return out
