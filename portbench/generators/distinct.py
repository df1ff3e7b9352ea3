"""Distinct (image, question) pairs: each question asks about an image
taken in turn from a seeded order of the fixture's images, and no pair
repeats. The mix sets ``question_syllables`` ([low, high]) and, for QA rows,
``answer_words`` ([low, high]) and ``answer_from_ocr`` (the share of
answers copied from the image's OCR, as scene-text answers are)."""

import numpy as np

from portbench import fixture


def _questions(fx, n: int, stream: int):
    rng = fixture.rng(fx.seed, stream)
    lo, hi = fx.mix["question_syllables"]
    lengths = rng.permutation(fixture.sizes(n, lo, hi, 3 + stream))
    images = rng.permutation(np.arange(n) % len(fx.image_ids))
    seen, out = set(), []
    for k, image in zip(lengths, images):
        while True:  # every (image, question) distinct
            q = " ".join(rng.choice(fx.words, int(k)))
            if (image, q) not in seen:
                break
        seen.add((image, q))
        out.append((fx.image_ids[int(image)], q))
    return out, rng


def rows(fx):
    """``mix["rows"]`` QA rows: dicts of image_id, question, answer."""
    n = int(fx.mix["rows"])
    qs, rng = _questions(fx, n, 10)
    lo, hi = fx.mix["answer_words"]
    lengths = rng.permutation(fixture.sizes(n, lo, hi, 20))
    copied = rng.permutation(np.arange(n) < round(n * float(fx.mix["answer_from_ocr"])))
    out = []
    for (image_id, q), k, from_ocr in zip(qs, lengths, copied):
        ocr = fx.texts[int(image_id)]
        if from_ocr:
            start = int(rng.integers(0, max(1, len(ocr) - int(k) + 1)))
            answer = " ".join(ocr[start:start + int(k)])
        else:
            answer = " ".join(rng.choice(fx.words, int(k)))
        out.append({"image_id": image_id, "question": q, "answer": answer,
                    "filename": f"{int(image_id)}.jpg"})
    return out


def requests(fx):
    """``mix["requests"]`` (image_id, question) pairs."""
    return _questions(fx, int(fx.mix["requests"]), 30)[0]
