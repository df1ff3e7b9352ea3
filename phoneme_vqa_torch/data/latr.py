"""LaTr featurization: question + OCR layout + answer into packed arrays.

Counterpart of ``phoneme_vqa_tpu/data/latr.py`` without pandas: QA rows are
dicts with ``image_id``, ``question`` and ``answer``; the OCR store is
``{image_id: (texts, bboxes)}`` (``adapters.textlayout_ocr_adapt``). The
arrays are element-equal to the JAX package's.

* question/answer are encoded as ``"<pad> " + text`` padded to max length
  (the "<pad> " prefix doubles as the T5 decoder-start convention); an
  ``answer_encoder`` (the customized and phoneme executors') encodes the
  answers instead, as ids or as (T, 3) phoneme triples
* OCR words (capped at ``max_ocr_element``) are tokenized twice, jointly
  and per word, to align subwords to words; each subword inherits its
  word's box as a 6-tuple (x0, y0, x1, y1, w, h)
* the OCR stream is closed with an EOS token/box and padded with pad
  token/zero boxes to ``max_ocr_length``
* pixel values load lazily per batch from ``{base_img_path}/{id}.npy``
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .loader import ArrayDataset, make_image_loader

PAD_TOKEN_BOX = [0, 0, 0, 0, 0, 0]
EOS_TOKEN_BOX = [1000, 1000, 1000, 1000, 1000, 1000]


def encode_prefixed(tokenizer, text: str, max_length: int):
    """``"<pad> " + text`` -> (ids, mask) fixed length."""
    enc = tokenizer(
        "<pad> " + text.strip(),
        padding="max_length",
        max_length=max_length,
        truncation=True,
    )
    return enc["input_ids"], enc["attention_mask"]


def align_ocr_subwords(
    tokenizer, ocr_texts: List[str], bounding_box, max_ocr_element: int, max_ocr_length: int
):
    """Subword-aligned OCR ids + per-subword 6-tuple boxes + mask."""
    ocr_texts = list(ocr_texts)[:max_ocr_element]
    bounding_box = list(bounding_box)[:max_ocr_element]
    boxes6 = [
        [b[0], b[1], b[2], b[3], b[2] - b[0], b[3] - b[1]] for b in bounding_box
    ]

    if ocr_texts:
        joint_ids = tokenizer(
            ocr_texts, is_split_into_words=True, add_special_tokens=False
        )["input_ids"]
        per_word_ids = tokenizer(
            ocr_texts, is_split_into_words=False, add_special_tokens=False
        )["input_ids"]
    else:  # an image with no OCR words: only the EOS token/box remain
        joint_ids, per_word_ids = [], []

    word_of_subword: List[int] = []
    for w, ids in enumerate(per_word_ids):
        word_of_subword.extend([w] * len(ids))

    room = max_ocr_length - 1  # keep a slot for EOS
    sub_boxes = [boxes6[w] for w in word_of_subword[:room]]
    n = len(sub_boxes)
    pad_n = max_ocr_length - n - 1

    ids = list(joint_ids[:n]) + [tokenizer.eos_token_id] + [tokenizer.pad_token_id] * pad_n
    boxes = sub_boxes + [EOS_TOKEN_BOX] + [PAD_TOKEN_BOX] * pad_n
    mask = [1] * (n + 1) + [0] * pad_n
    return ids, boxes, mask


def label_array(rows, empty_shape) -> np.ndarray:
    """Encoded answers as one int32 array: (N, T) ids, or (N, T, 3) phoneme
    triples from the structured tokenizer's answer encoder."""
    return np.asarray(rows, np.int32) if rows else np.zeros(empty_shape, np.int32)


def join_ocr(qa_rows: Sequence[dict], ocr_store) -> List[dict]:
    """Inner join of QA rows with the OCR store on ``image_id``, in row order."""
    out = []
    for row in qa_rows:
        key = float(row["image_id"])
        if key in ocr_store:
            texts, bboxes = ocr_store[key]
            out.append(dict(row, image_id=key, texts=texts, bboxes=bboxes))
    return out


class LaTrDataset:
    """Builds the packed-array dataset for the LaTr family."""

    def __init__(
        self,
        qa_rows: Sequence[dict],
        ocr_store,
        tokenizer,
        base_img_path: str,
        max_ocr_element: int = 50,
        max_ocr_length: int = 100,
        max_input_length: int = 30,
        max_output_length: int = 20,
        answer_encoder=None,
    ):
        self.tokenizer = tokenizer
        rows = join_ocr(qa_rows, ocr_store)
        arrays = self._featurize(
            rows, tokenizer, max_ocr_element, max_ocr_length,
            max_input_length, max_output_length, answer_encoder,
        )
        image_ids = [r["image_id"] for r in rows]
        self.dataset = ArrayDataset(
            arrays,
            image_ids=image_ids,
            lazy_fields={"pixel_values": make_image_loader(base_img_path, image_ids)},
        )

    @staticmethod
    def _featurize(rows, tokenizer, max_ocr_element, max_ocr_length,
                   max_input_length, max_output_length, answer_encoder=None):
        n = len(rows)
        input_ids = np.zeros((n, max_input_length), np.int32)
        src_mask = np.zeros((n, max_input_length), np.int32)
        ocr_ids = np.zeros((n, max_ocr_length), np.int32)
        ocr_mask = np.zeros((n, max_ocr_length), np.int32)
        coords = np.zeros((n, max_ocr_length, 6), np.int32)
        label_rows, label_mask_rows = [], []

        for i, row in enumerate(rows):
            input_ids[i], src_mask[i] = encode_prefixed(
                tokenizer, str(row["question"]), max_input_length
            )
            o_ids, o_boxes, o_mask = align_ocr_subwords(
                tokenizer, row["texts"], row["bboxes"], max_ocr_element, max_ocr_length
            )
            ocr_ids[i], ocr_mask[i] = o_ids, o_mask
            coords[i] = np.asarray(o_boxes, np.float64).astype(np.int32)
            answer = str(row["answer"])
            a_ids, a_mask = (
                encode_prefixed(tokenizer, answer, max_output_length) if answer_encoder is None
                else answer_encoder(answer, max_output_length)
            )
            label_rows.append(a_ids)
            label_mask_rows.append(a_mask)

        return {
            "input_ids": input_ids,
            "src_attention_mask": src_mask,
            "tokenized_ocr": ocr_ids,
            "ocr_attention_mask": ocr_mask,
            "coordinates": coords,
            "label_ids": label_array(label_rows, (n, max_output_length)),
            "label_attention_mask": label_array(label_mask_rows, (n, max_output_length)),
        }

    def __len__(self) -> int:
        return len(self.dataset)
