"""Synchronous serving engine over the LaTr greedy decode path.

Counterpart of the request path of ``phoneme_vqa_tpu/serving/engine.py``:
requests (image_id, question) are featurized against a preloaded OCR store
(:func:`featurize_requests`), decoded in fixed-size batches with the final
batch padded (as ``BaseExecutor.infer`` pads it), and each row is cut at EOS
and detokenized (as ``BaseExecutor._decode_rows`` does). Threads, queues,
deadlines, the watchdog, adapters, buckets and the encoding cache are not
ported yet.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..data.latr import LaTrDataset
from ..data.loader import batch_iterator
from ..models.generate import make_generate_fn
from ..models.latr import to_device_batch

Request = Tuple[float, str]  # (image_id, question)


def featurize_requests(tokenizer, ocr_store, base_img_path, reqs: Sequence[Request],
                       max_ocr_element: int = 50, max_ocr_length: int = 100,
                       max_q_length: int = 30, max_a_length: int = 20):
    """Requests -> the eval-path ArrayDataset (answers are empty: serving has none)."""
    rows = [
        {"image_id": float(image_id), "question": question, "answer": ""}
        for image_id, question in reqs
    ]
    return LaTrDataset(
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


class ServingEngine:
    """Answers batches of requests with a LaTr model on its device.

    ``answer(requests)`` featurizes, decodes in batches of ``batch_size``
    (the last one padded) and returns one answer string per request."""

    def __init__(self, model, tokenizer, ocr_store, base_img_path: str,
                 batch_size: int = 32, max_answer_length: int = 20,
                 max_ocr_element: int = 50, max_ocr_length: int = 100,
                 max_q_length: int = 30):
        self.model = model
        self.tokenizer = tokenizer
        self.ocr_store = ocr_store
        self.base_img_path = base_img_path
        self.batch_size = batch_size
        self.max_answer_length = max_answer_length
        self.featurize_args = dict(
            max_ocr_element=max_ocr_element, max_ocr_length=max_ocr_length,
            max_q_length=max_q_length,
        )
        self.generate = make_generate_fn(model, max_answer_length)

    def answer(self, requests: Sequence[Request]) -> List[str]:
        dataset = featurize_requests(
            self.tokenizer, self.ocr_store, self.base_img_path, requests,
            **self.featurize_args,
        )
        if len(dataset) != len(requests):
            raise KeyError("a request names an image_id that the OCR store does not hold")
        rows: List = []
        for batch, n_valid in batch_iterator(dataset, self.batch_size, pad_final=True):
            out = self.generate(to_device_batch(batch, self.model.device))
            rows.extend(out[:n_valid].tolist())
        return decode_rows(self.tokenizer, rows)
