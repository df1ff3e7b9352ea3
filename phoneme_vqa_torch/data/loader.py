"""Fixed-shape array dataset + batch iterator.

Featurization lands in packed, padded numpy arrays; batching is array
slicing (counterpart of ``phoneme_vqa_tpu/data/loader.py``):

* train: shuffled epochs (``np.random.RandomState(seed).permutation``, the
  JAX package's order for the same seed), final partial batch dropped;
* eval/predict: in order, the final partial batch padded up to full size
  with a ``n_valid`` count, so every batch has one shape;
* a data-parallel mesh: ``shard`` / ``num_shards`` take each data rank's
  interleaved rows (``order[shard::num_shards]``), so one step's rows over
  all ranks are one process's batch;
* :func:`prefetch` (``NUMWORKERS``) assembles batches on a background
  thread. Unlike the JAX package's, whose consumer ends the epoch quietly
  when the producer raises, it re-raises the producer's exception.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from ..utils import profiling


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
    shard: int = 0,
    num_shards: int = 1,
) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
    """Yields (batch dict, n_valid). Batches always have ``batch_size`` rows
    when ``pad_final`` (the final short batch repeats its last row); with
    ``drop_last`` the final short batch is not yielded. ``shard`` /
    ``num_shards`` keep every ``num_shards``-th row of the order from row
    ``shard`` on."""
    n = len(dataset)
    order = np.random.RandomState(seed).permutation(n) if shuffle else np.arange(n)
    order = order[shard::num_shards]
    for start in range(0, len(order), batch_size):
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


def prefetch(iterator, depth: int = 2):
    """Yields ``iterator``'s items, produced up to ``depth`` ahead on a
    background thread (``NUMWORKERS``: the host assembles the next batch
    while the card runs this one). An exception in the producer is raised
    here, at the item it failed to produce; closing the generator early
    stops the producer."""
    items: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def put(entry) -> bool:
        while not stop.is_set():
            try:
                items.put(entry, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def produce():
        try:
            for item in iterator:
                if not put((item, None)):
                    return
        except Exception as e:  # handed to the consumer, which raises it
            put((end, e))
            return
        put((end, None))

    thread = threading.Thread(target=produce, name="prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item, error = items.get()
            if item is end:
                if error is not None:
                    raise error
                return
            yield item
    finally:
        stop.set()
        thread.join(timeout=30)


def make_image_loader(base_img_path: str, image_ids) -> Callable[[np.ndarray], np.ndarray]:
    """Lazy ViT pixel loader: ``{base}/{image_id}.npy`` dicts holding 'image',
    stored as (1, C, H, W) or (C, H, W). A batch's reads are a
    ``loader.read`` span (``utils/profiling.py``) with the files and bytes."""

    def load(idx: np.ndarray) -> np.ndarray:
        with profiling.span("loader.read", kind="pixels") as sp:
            imgs, nbytes = [], 0
            for i in idx:
                image_id = image_ids[int(i)]
                # float ids like 7.0 may be stored as "7.0.npy" or "7.npy"
                for stem in (str(image_id), str(int(image_id))):
                    path = os.path.join(base_img_path, stem + ".npy")
                    if os.path.isfile(path):
                        break
                record = np.load(path, allow_pickle=True).tolist()
                if sp:
                    nbytes += os.path.getsize(path)
                img = np.asarray(record["image"], np.float32)
                if img.ndim == 4:
                    img = img[0]
                imgs.append(img)
            if sp:
                sp.set(files=len(imgs), bytes=nbytes)
            return np.stack(imgs)

    return load
