"""SaL featurization: question + OCR words (with context tokens and
features) + object labels (with region features) into packed arrays.

Counterpart of ``phoneme_vqa_tpu/data/sal.py`` without pandas: QA rows are dicts with ``image_id``, ``question`` and
``answer``; the OCR and object stores are ``{image_id: (texts, boxes)}``
(``adapters.textlayout_ocr_adapt`` / ``textlayout_obj_adapt``). The arrays
are element-equal to the JAX package's.

* QA rows are inner-joined against both stores, in row order
* OCR words get a ``<c>`` context token appended per word; subwords AND the
  context token inherit the word's 4-float box and its det ⊕ rec features
* object labels are tokenized per word (no context token); each subword
  gets the region's box and its region feature
* both streams are closed with EOS (box 0.9999^4) and padded (box zeros)
* question/answer: "<pad> "-prefixed, padded to max length; an
  ``answer_encoder(answer, max_length) -> (ids, mask)`` replaces the
  answer's encoding (the custom decoders' answer tokenizers)
* features load lazily per batch from ``{base_*_feature_path}/{image_id}.npy``,
  each stream's reads a ``loader.read`` span (``kind`` ``ocr`` or ``obj``,
  with the files and bytes; ``utils/profiling.py``)
* ``cache_dir`` (``FEATURE_CACHE``) keeps the packed arrays, the word
  alignments included, on disk (``feature_cache.get_or_build``)
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from ..utils import profiling
from . import feature_cache
from .latr import encode_prefixed
from .loader import ArrayDataset

PAD_BOX = [0.0, 0.0, 0.0, 0.0]
EOS_BOX = [0.9999, 0.9999, 0.9999, 0.9999]


def _word_aligned_stream(tokenizer, texts, boxes, max_length: int, context_token_id=None):
    """Returns (ids, boxes4, mask, word_ids) fixed to ``max_length``."""
    texts = list(texts)
    per_word = (
        tokenizer(texts, is_split_into_words=False, add_special_tokens=False)["input_ids"]
        if texts else []
    )
    flat_ids: List[int] = []
    word_ids: List[int] = []
    for w, ids in enumerate(per_word):
        ids = list(ids)
        if context_token_id is not None:
            ids = ids + [context_token_id]
        flat_ids.extend(ids)
        word_ids.extend([w] * len(ids))

    kept_words = word_ids[: max_length - 1]  # keep a slot for EOS
    n = len(kept_words)
    pad_n = max_length - n - 1
    ids = flat_ids[:n] + [tokenizer.eos_token_id] + [tokenizer.pad_token_id] * pad_n
    out_boxes = [list(boxes[w]) for w in kept_words] + [EOS_BOX] + [PAD_BOX] * pad_n
    mask = [1] * (n + 1) + [0] * pad_n
    return ids, out_boxes, mask, kept_words


def _feature_gather(features_per_word, word_ids, max_length: int, hidden: int) -> np.ndarray:
    """Feature row per stream position: the word's features for each of its
    subwords, zeros for EOS and padding."""
    out = np.zeros((max_length, hidden), np.float32)
    for pos, w in enumerate(word_ids):
        out[pos] = features_per_word[w]
    return out


def join_stores(qa_rows: Sequence[dict], ocr_store, obj_store) -> List[dict]:
    """Inner join of QA rows with both stores on ``image_id``, in row order."""
    out = []
    for row in qa_rows:
        key = float(row["image_id"])
        if key in ocr_store and key in obj_store:
            texts, bboxes = ocr_store[key]
            labels, obj_bboxes = obj_store[key]
            out.append(dict(row, image_id=key, texts=texts, bboxes=bboxes,
                            obj_labels=labels, obj_bboxes=obj_bboxes))
    return out


class SaLDataset:
    """Builds the packed-array dataset for the SaL family."""

    def __init__(
        self,
        qa_rows: Sequence[dict],
        ocr_store,
        obj_store,
        tokenizer,
        base_ocr_feature_path: str,
        base_obj_feature_path: str,
        ocr_hidden: int = 512,
        obj_hidden: int = 2048,
        max_ocr_element: int = 50,
        max_ocr_length: int = 150,
        max_obj_element: int = 25,
        max_obj_length: int = 50,
        max_input_length: int = 30,
        max_output_length: int = 128,
        context_token: str = "<c>",
        answer_encoder=None,
        cache_dir=None,
        cache_tag: str = "",
    ):
        self.base_ocr_feature_path = base_ocr_feature_path
        self.base_obj_feature_path = base_obj_feature_path
        self.ocr_hidden = ocr_hidden
        self.obj_hidden = obj_hidden
        self.max_ocr_length = max_ocr_length
        self.max_obj_length = max_obj_length
        self.context_token_id = tokenizer(context_token)["input_ids"][0]

        rows = join_stores(qa_rows, ocr_store, obj_store)
        parts = {
            "cls": type(self).__name__,
            "rows": feature_cache.rows_fingerprint(rows),
            "tok": feature_cache.tokenizer_tag(tokenizer),
            "tag": cache_tag,
            "context_token": context_token,
            "max_ocr_element": max_ocr_element,
            "max_ocr_length": max_ocr_length,
            "max_obj_element": max_obj_element,
            "max_obj_length": max_obj_length,
            "max_input_length": max_input_length,
            "max_output_length": max_output_length,
        }
        arrays, image_ids = feature_cache.get_or_build(cache_dir, parts, lambda: (
            self._featurize(rows, tokenizer, self.context_token_id, max_ocr_element,
                            max_ocr_length, max_obj_element, max_obj_length, max_input_length,
                            max_output_length, answer_encoder),
            [r["image_id"] for r in rows]))
        arrays = dict(arrays)
        # subword -> word alignment for the lazy feature gathers (-1 = no
        # word), fixed-shape arrays so they cache like the others
        self._ocr_word_ids = np.asarray(arrays.pop("_ocr_word_ids"))
        self._obj_word_ids = np.asarray(arrays.pop("_obj_word_ids"))
        self._image_ids = image_ids
        self.dataset = ArrayDataset(
            arrays,
            image_ids=self._image_ids,
            lazy_fields={
                "ocr_features": self._load_ocr_features,
                "obj_features": self._load_obj_features,
            },
        )

    @staticmethod
    def _featurize(rows, tokenizer, context_token_id, max_ocr_element, max_ocr_length,
                   max_obj_element, max_obj_length, max_input_length, max_output_length,
                   answer_encoder=None):
        n = len(rows)
        arr = lambda *shape: np.zeros(shape, np.int32)
        input_ids, src_mask = arr(n, max_input_length), arr(n, max_input_length)
        ocr_ids, ocr_mask = arr(n, max_ocr_length), arr(n, max_ocr_length)
        ocr_coords = np.zeros((n, max_ocr_length, 4), np.float32)
        obj_ids, obj_mask = arr(n, max_obj_length), arr(n, max_obj_length)
        obj_coords = np.zeros((n, max_obj_length, 4), np.float32)
        label_ids, label_mask = arr(n, max_output_length), arr(n, max_output_length)
        ocr_word_ids = np.full((n, max_ocr_length), -1, np.int32)
        obj_word_ids = np.full((n, max_obj_length), -1, np.int32)

        for i, row in enumerate(rows):
            o_ids, o_boxes, o_mask, o_words = _word_aligned_stream(
                tokenizer, list(row["texts"])[:max_ocr_element],
                list(row["bboxes"])[:max_ocr_element], max_ocr_length, context_token_id,
            )
            ocr_ids[i], ocr_mask[i] = o_ids, o_mask
            ocr_coords[i] = np.asarray(o_boxes, np.float32)
            ocr_word_ids[i, : len(o_words)] = o_words

            b_ids, b_boxes, b_mask, b_words = _word_aligned_stream(
                tokenizer, list(row["obj_labels"])[:max_obj_element],
                list(row["obj_bboxes"])[:max_obj_element], max_obj_length,
            )
            obj_ids[i], obj_mask[i] = b_ids, b_mask
            obj_coords[i] = np.asarray(b_boxes, np.float32)
            obj_word_ids[i, : len(b_words)] = b_words

            input_ids[i], src_mask[i] = encode_prefixed(
                tokenizer, str(row["question"]), max_input_length
            )
            answer = str(row["answer"])
            label_ids[i], label_mask[i] = (
                encode_prefixed(tokenizer, answer, max_output_length) if answer_encoder is None
                else answer_encoder(answer, max_output_length)
            )

        return {
            "input_ids": input_ids,
            "src_attention_mask": src_mask,
            "tokenized_ocr": ocr_ids,
            "ocr_attention_mask": ocr_mask,
            "ocr_coordinates": ocr_coords,
            "tokenized_obj": obj_ids,
            "obj_attention_mask": obj_mask,
            "obj_coordinates": obj_coords,
            "label_ids": label_ids,
            "label_attention_mask": label_mask,
            "_ocr_word_ids": ocr_word_ids,
            "_obj_word_ids": obj_word_ids,
        }

    def __len__(self) -> int:
        return len(self.dataset)

    # -- lazy per-batch feature loading ----------------------------------------

    def _npy_path(self, root: str, idx: int) -> str:
        image_id = self._image_ids[idx]
        for stem in (str(image_id), str(int(float(image_id)))):
            path = os.path.join(root, stem + ".npy")
            if os.path.isfile(path):
                return path
        raise FileNotFoundError(f"feature file for image {image_id} in {root}")

    def _load_features(self, indices, root, word_ids, length, hidden, per_word,
                       kind: str) -> np.ndarray:
        with profiling.span("loader.read", kind=kind) as sp:
            out = np.zeros((len(indices), length, hidden), np.float32)
            nbytes = 0
            for row, idx in enumerate(np.asarray(indices).tolist()):
                words = word_ids[idx]
                path = self._npy_path(root, idx)
                if sp:
                    nbytes += os.path.getsize(path)
                out[row] = _feature_gather(per_word(np.load(path, allow_pickle=True).tolist()),
                                           words[words >= 0], length, hidden)
            if sp:
                sp.set(files=len(out), bytes=nbytes)
            return out

    def _load_ocr_features(self, indices) -> np.ndarray:
        return self._load_features(
            indices, self.base_ocr_feature_path, self._ocr_word_ids, self.max_ocr_length,
            self.ocr_hidden,
            lambda rec: np.concatenate(
                [np.asarray(rec["det_features"]), np.asarray(rec["rec_features"])], axis=-1),
            "ocr",
        )

    def _load_obj_features(self, indices) -> np.ndarray:
        return self._load_features(
            indices, self.base_obj_feature_path, self._obj_word_ids, self.max_obj_length,
            self.obj_hidden, lambda rec: np.asarray(rec["region_features"]), "obj",
        )
