"""PreSTU featurization: question and OCR fused into one token stream.

Counterpart of ``phoneme_vqa_tpu/data/prestu.py`` without pandas: QA rows
are dicts, the OCR store is ``{image_id: (texts, bboxes)}`` as for LaTr
(``data/latr.py: join_ocr``; the boxes are not used). The arrays are
element-equal to the JAX package's.

* ``input_ids = [pad] question [eos] ocr [eos] [pad]...`` padded to
  ``max_input_length + max_ocr_length`` with a joint attention mask
  (:func:`fuse_question_ocr`); an OCR list the tokenizer cannot take
  contributes no tokens;
* answers as LaTr's: ``"<pad> " + text``, or the ``answer_encoder``'s ids
  or (T, 3) phoneme triples;
* pixel values load lazily per batch from ``{base_img_path}/{id}.npy``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from . import feature_cache
from .latr import encode_prefixed, join_ocr, label_array
from .loader import ArrayDataset, make_image_loader


def fuse_question_ocr(tokenizer, question: str, ocr_texts, max_q: int, max_ocr: int):
    """(ids, mask) of ``[pad] question [eos] ocr [eos] [pad]...``, length
    ``max_q + max_ocr``: the question cut to ``max_q - 2`` tokens, the OCR
    to ``max_ocr - 1``."""
    q_ids = tokenizer(
        question.strip(), max_length=max_q - 2, truncation=True, add_special_tokens=False,
    )["input_ids"]
    try:
        ocr_ids = tokenizer(
            list(ocr_texts), is_split_into_words=True, add_special_tokens=False
        )["input_ids"]
    except Exception:  # the JAX package's rule: an OCR list that fails to tokenize is dropped
        ocr_ids = []
    ocr_ids = list(ocr_ids)[: max_ocr - 1]

    total = max_q + max_ocr
    valid = len(q_ids) + len(ocr_ids) + 3  # pad + eos + eos
    ids = (
        [tokenizer.pad_token_id]
        + list(q_ids)
        + [tokenizer.eos_token_id]
        + ocr_ids
        + [tokenizer.eos_token_id]
        + [tokenizer.pad_token_id] * (total - valid)
    )
    mask = [1] * valid + [0] * (total - valid)
    return ids, mask


class PreSTUDataset:
    """Builds the packed-array dataset for the PreSTU family."""

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
        cache_dir=None,
        cache_tag: str = "",
    ):
        rows = join_ocr(qa_rows, ocr_store)
        parts = {
            "cls": type(self).__name__,
            "rows": feature_cache.rows_fingerprint(rows),
            "tok": feature_cache.tokenizer_tag(tokenizer),
            "tag": cache_tag,
            "max_ocr_element": max_ocr_element,
            "max_ocr_length": max_ocr_length,
            "max_input_length": max_input_length,
            "max_output_length": max_output_length,
        }
        arrays, image_ids = feature_cache.get_or_build(cache_dir, parts, lambda: (
            self._featurize(rows, tokenizer, max_ocr_element, max_ocr_length,
                            max_input_length, max_output_length, answer_encoder),
            [r["image_id"] for r in rows]))
        self.dataset = ArrayDataset(
            arrays,
            image_ids=image_ids,
            lazy_fields={"pixel_values": make_image_loader(base_img_path, image_ids)},
        )

    @staticmethod
    def _featurize(rows, tokenizer, max_ocr_element, max_ocr_length, max_input_length,
                   max_output_length, answer_encoder=None):
        n = len(rows)
        total = max_input_length + max_ocr_length
        input_ids = np.zeros((n, total), np.int32)
        src_mask = np.zeros((n, total), np.int32)
        label_rows, label_mask_rows = [], []
        for i, row in enumerate(rows):
            input_ids[i], src_mask[i] = fuse_question_ocr(
                tokenizer, str(row["question"]), list(row["texts"])[:max_ocr_element],
                max_input_length, max_ocr_length,
            )
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
            "label_ids": label_array(label_rows, (n, max_output_length)),
            "label_attention_mask": label_array(label_mask_rows, (n, max_output_length)),
        }

    def __len__(self) -> int:
        return len(self.dataset)
