"""Synchronous serving engine over the greedy decode path.

Counterpart of the request path of ``phoneme_vqa_tpu/serving/engine.py``:
requests (image_id, question) are featurized against preloaded feature
stores (:func:`featurize_requests`), decoded in fixed-size batches with the
final batch padded (as ``BaseExecutor.infer`` pads it), and each row is cut
at EOS and detokenized (as ``BaseExecutor._decode_rows`` does): by the
backbone tokenizer, or by the answer tokenizer of a model with a custom or
phoneme decoder (``answer_tokenizer``, :func:`decode_answer_rows`; the
structured phoneme tokenizer decodes the (T, 3) rows of the triple
decoder). The generate function follows the model's ``decode_components``
(``models.generate.build_generate_fn``). It serves the LaTr family from an
OCR store and page images, the PreSTU family from the same (its question
and OCR fused into one stream), and the SaL family when it is given
:class:`SaLInputs` (an object store and the feature files) too, moving the
model's batch keys to the device. Threads, queues, deadlines, the watchdog,
adapters, buckets and the encoding cache are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..data.latr import LaTrDataset
from ..data.loader import batch_iterator
from ..data.sal import SaLDataset
from ..models import latr as latr_mod
from ..models.generate import build_generate_fn

Request = Tuple[float, str]  # (image_id, question)


@dataclasses.dataclass(frozen=True)
class SaLInputs:
    """What featurizing for the SaL family needs beside the OCR store (the
    SaL executor's config keys of the same names)."""

    obj_store: dict  # {image_id: (labels, boxes)}, ``textlayout_obj_adapt``
    base_ocr_feature_path: str
    base_obj_feature_path: str
    ocr_hidden: int = 512
    obj_hidden: int = 2048
    max_obj_element: int = 25
    max_obj_length: int = 50


def featurize_requests(tokenizer, ocr_store, base_img_path, reqs: Sequence[Request],
                       max_ocr_element: int = 50, max_ocr_length: int = 100,
                       max_q_length: int = 30, max_a_length: int = 20,
                       sal: Optional[SaLInputs] = None, dataset=LaTrDataset):
    """Requests -> the eval-path ArrayDataset (answers are empty: serving
    has none): SaL's when ``sal`` is given (``base_img_path`` is then
    unused), else ``dataset``'s (a LaTr-family model's ``DATASET``: LaTr's,
    or PreSTU's with the question and OCR fused). Rows whose image a store
    lacks are dropped."""
    rows = [
        {"image_id": float(image_id), "question": question, "answer": ""}
        for image_id, question in reqs
    ]
    if sal is not None:
        return SaLDataset(
            rows, ocr_store, sal.obj_store, tokenizer, sal.base_ocr_feature_path,
            sal.base_obj_feature_path, ocr_hidden=sal.ocr_hidden, obj_hidden=sal.obj_hidden,
            max_ocr_element=max_ocr_element, max_ocr_length=max_ocr_length,
            max_obj_element=sal.max_obj_element, max_obj_length=sal.max_obj_length,
            max_input_length=max_q_length, max_output_length=max_a_length,
        ).dataset
    return dataset(
        rows, ocr_store, tokenizer, base_img_path,
        max_ocr_element=max_ocr_element, max_ocr_length=max_ocr_length,
        max_input_length=max_q_length, max_output_length=max_a_length,
    ).dataset


def decode_rows(tokenizer, rows) -> List[str]:
    """Cut [start, ..., eos] to the tokens between, then detokenize."""
    eos = tokenizer.eos_token_id
    cut = []
    for row in rows:
        try:
            cut.append(row[1 : row.index(eos)])
        except ValueError:
            cut.append(row)
    return tokenizer.batch_decode(cut, skip_special_tokens=True)


def decode_answer_rows(answer_tokenizer, rows) -> List[str]:
    """Detokenize rows with an answer tokenizer, which cuts them itself (the
    char and byte tokenizers at EOS; the flat phoneme tokenizer drops its
    special ids and recomposes the syllables; the structured one reads (T, 3)
    triple rows up to the onset's EOS). The char and byte tokenizers return
    one-element lists."""
    decoded = answer_tokenizer.batch_decode(rows)
    return [d[0] if isinstance(d, list) else d for d in decoded]


class ServingEngine:
    """Answers batches of requests with a LaTr, PreSTU or SaL model on its
    device.

    ``answer(requests)`` featurizes, decodes in batches of ``batch_size``
    (the last one padded) and returns one answer string per request. A
    request whose image is missing from a store raises ``KeyError``.
    ``answer_tokenizer`` decodes the answers of a model whose decoder has
    its own vocabulary (the customized and phoneme models); ``tokenizer``
    (the backbone's) featurizes the requests."""

    def __init__(self, model, tokenizer, ocr_store, base_img_path: Optional[str],
                 batch_size: int = 32, max_answer_length: int = 20,
                 max_ocr_element: int = 50, max_ocr_length: int = 100,
                 max_q_length: int = 30, sal: Optional[SaLInputs] = None,
                 answer_tokenizer=None):
        self.model = model
        self.tokenizer = tokenizer
        self.answer_tokenizer = answer_tokenizer
        self.ocr_store = ocr_store
        self.base_img_path = base_img_path
        self.sal = sal
        self.batch_size = batch_size
        self.max_answer_length = max_answer_length
        self.featurize_args = dict(
            max_ocr_element=max_ocr_element, max_ocr_length=max_ocr_length,
            max_q_length=max_q_length, sal=sal,
        )
        if sal is None:
            self.featurize_args["dataset"] = model.DATASET
        self.batch_keys = model.BATCH_KEYS
        # SaL featurization inner-joins both stores: admit only images in each
        self.known_ids = set(ocr_store) if sal is None else set(ocr_store) & set(sal.obj_store)
        if not self.known_ids:
            raise ValueError("no image id is in every feature store")
        self.generate = build_generate_fn(model, max_answer_length)

    def answer(self, requests: Sequence[Request]) -> List[str]:
        unknown = sorted({float(i) for i, _ in requests} - self.known_ids)
        if unknown:
            stores = "OCR store" if self.sal is None else "OCR and object stores"
            raise KeyError(f"image ids {unknown} are not in the {stores}")
        dataset = featurize_requests(
            self.tokenizer, self.ocr_store, self.base_img_path, requests,
            **self.featurize_args,
        )
        rows: List = []
        for batch, n_valid in batch_iterator(dataset, self.batch_size, pad_final=True):
            tb = latr_mod.to_device_batch(batch, self.model.device, self.batch_keys)
            out = self.generate(tb)
            rows.extend(out[:n_valid].tolist())
        if self.answer_tokenizer is not None:
            return decode_answer_rows(self.answer_tokenizer, rows)
        return decode_rows(self.tokenizer, rows)
