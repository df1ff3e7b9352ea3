"""The one traffic generator: a seeded fixture of images, their OCR (and
objects), written in the port's on-disk formats, and the request or row
stream a traffic mix asks for.

What a mix may set (its ``.json`` under ``portbench/traffic/``):

* ``images``: images a run (each its own pixels or features and OCR words);
* ``ocr_words``: ``{"median", "sigma"}`` of a lognormal count of OCR words
  an image, clipped to 1..``max_ocr_element`` of the configuration;
* ``generator``: the module ``portbench/generators/<name>.py`` that makes
  the mix's QA rows (``rows``, training) or requests (``requests``,
  serving), with the parameters it documents;
* whatever the family's layout (``portbench/layouts/<name>.py``) and the
  mix's driver read.

Sizes (word counts, lengths) are drawn once from a fixed
stream and handed to every seed in another order, so every seed does the
same work; the seed draws the content (words, boxes, pixels, features,
which image a question asks about) and that order.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from . import manifest

HERE = os.path.dirname(os.path.abspath(__file__))
SIZES_SEED = 20240917  # the fixed stream of sizes


def syllables():
    with open(os.path.join(HERE, "syllables.txt"), encoding="utf-8") as f:
        return [w.strip() for w in f if w.strip()]


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seed's own stream ``stream``: content and order."""
    return np.random.default_rng([int(seed) % 2**63, stream])


def sizes(n: int, low: int, high: int, stream: int) -> np.ndarray:
    """``n`` whole numbers in [low, high] from the fixed stream ``stream``:
    the same for every seed."""
    return np.random.default_rng([SIZES_SEED, stream]).integers(low, high + 1, n)


def ocr_counts(n: int, mix: dict, max_words: int) -> np.ndarray:
    spec = mix["ocr_words"]
    draw = np.random.default_rng([SIZES_SEED, 1]).lognormal(np.log(spec["median"]),
                                                            spec["sigma"], n)
    return np.clip(np.round(draw), 1, max_words).astype(int)


class Fixture:
    """Images, their OCR (and objects), written under ``root`` in the
    port's formats; ``texts`` keeps every image's OCR words."""

    def __init__(self, root: str, seed: int, mix: dict, config: dict, layout: str):
        """``layout``: the module ``portbench/layouts/<layout>.py`` that
        writes the family's files."""
        self.root, self.seed, self.mix, self.config = root, int(seed), mix, config
        self.words = syllables()
        n = int(mix["images"])
        self.image_ids = [float(i) for i in range(n)]
        draw = rng(seed, 0)
        counts = draw.permutation(ocr_counts(n, mix, int(config["max_ocr_element"])))
        self.texts = [list(draw.choice(self.words, int(k))) for k in counts]
        boxes = []
        for k in counts:
            x0y0 = draw.uniform(0.0, 0.85, (int(k), 2))
            wh = draw.uniform(0.02, 0.15, (int(k), 2))
            boxes.append(np.concatenate([x0y0, np.minimum(x0y0 + wh, 0.999)], 1))
        self.boxes = boxes
        self.paths = {}
        manifest.layout(layout).write(self, draw)
        self.generator = manifest.generator(mix["generator"])

    def save(self, d, name, record):
        np.save(os.path.join(d, name), record, allow_pickle=True)

    def rows(self):
        """The mix's QA rows (training)."""
        return self.generator.rows(self)

    def requests(self):
        """The mix's (image_id, question) requests (serving)."""
        return self.generator.requests(self)

    def write_csv(self, name: str, rows) -> str:
        path = os.path.join(self.root, f"qa_{name}.csv")
        with open(path, "w", newline="", encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=("image_id", "question", "answer", "filename"),
                               lineterminator="\n")
            w.writeheader()
            w.writerows(rows)
        return path
