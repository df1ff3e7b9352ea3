"""Fixed-shape array dataset + batch iterator.

Featurization lands in packed, padded numpy arrays; batching is array
slicing (counterpart of ``phoneme_vqa_tpu/data/loader.py``):

* train: shuffled epochs (``np.random.RandomState(seed).permutation``, the
  JAX package's order for the same seed), final partial batch dropped;
* eval/predict: in order, the final partial batch padded up to full size
  with a ``n_valid`` count, so every batch has one shape.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np


class ArrayDataset:
    """A dict of equal-length numpy arrays + optional lazy per-row extras."""

    def __init__(
        self,
        arrays: Dict[str, np.ndarray],
        image_ids=None,
        lazy_fields: Optional[Dict[str, Callable[[np.ndarray], np.ndarray]]] = None,
    ):
        lengths = {k: len(v) for k, v in arrays.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"ragged dataset: {lengths}")
        self.arrays = arrays
        self.image_ids = image_ids
        # lazy_fields: name -> fn(indices) -> array (e.g. pixel values from disk)
        self.lazy_fields = lazy_fields or {}

    def __len__(self) -> int:
        return len(next(iter(self.arrays.values())))

    def gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        batch = {k: v[idx] for k, v in self.arrays.items()}
        for name, fn in self.lazy_fields.items():
            batch[name] = fn(idx)
        return batch


def batch_iterator(
    dataset: ArrayDataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = False,
    pad_final: bool = True,
) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
    """Yields (batch dict, n_valid). Batches always have ``batch_size`` rows
    when ``pad_final`` (the final short batch repeats its last row); with
    ``drop_last`` the final short batch is not yielded."""
    n = len(dataset)
    order = np.random.RandomState(seed).permutation(n) if shuffle else np.arange(n)
    for start in range(0, n, batch_size):
        idx = order[start : start + batch_size]
        n_valid = len(idx)
        if n_valid < batch_size:
            if drop_last:
                return
            if pad_final:
                idx = np.concatenate([idx, np.full(batch_size - n_valid, idx[-1], idx.dtype)])
        yield dataset.gather(idx), n_valid


def num_batches(n_rows: int, batch_size: int, drop_last: bool = False) -> int:
    return n_rows // batch_size if drop_last else -(-n_rows // batch_size)


def make_image_loader(base_img_path: str, image_ids) -> Callable[[np.ndarray], np.ndarray]:
    """Lazy ViT pixel loader: ``{base}/{image_id}.npy`` dicts holding 'image',
    stored as (1, C, H, W) or (C, H, W)."""

    def load(idx: np.ndarray) -> np.ndarray:
        imgs = []
        for i in idx:
            image_id = image_ids[int(i)]
            # float ids like 7.0 may be stored as "7.0.npy" or "7.npy"
            for stem in (str(image_id), str(int(image_id))):
                path = os.path.join(base_img_path, stem + ".npy")
                if os.path.isfile(path):
                    break
            record = np.load(path, allow_pickle=True).tolist()
            img = np.asarray(record["image"], np.float32)
            if img.ndim == 4:
                img = img[0]
            imgs.append(img)
        return np.stack(imgs)

    return load
