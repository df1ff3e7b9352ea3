"""Serving-side frozen-ViT encoding cache (``VIT_CACHE: true`` in serve
mode; counterpart of ``phoneme_vqa_tpu/serving/encoding_cache.py``).

The offline cache (``data/vit_cache.py``) encodes a whole dataset up front;
serving cannot, so this is the online form: an ``image_id -> encoding`` LRU
table owned by the engine. Each gathered batch encodes only its missing
images (deduped, in fixed chunks of ``chunk`` rows), then feeds
``vit_encodings`` to the model in place of ``pixel_values``. The port's
encode is eager (the serving graphs hold the decode only), so the cached
rows go into it as they are and the decode graphs are untouched. VQA
traffic asks several questions of one image: a repeat costs a gather on the
device, no ViT forward and none of its 12 attention-kernel launches.

Validity: the encoder has no dropout, so an entry is exact while the ViT
weights are unchanged. The table is flushed on a weight reload, and the
cache is not built when a serving LoRA adapter targets the ViT.

Threads: ``apply`` runs on the engine's dispatcher (or worker) thread;
``flush`` and ``stats`` on HTTP and watcher threads. The lock guards the
table and counters only; the encode of missing images runs outside it, and
inserts re-check the ``generation`` that every flush bumps, so encodings
made under the old weights never land in the new table. The gathered
engine re-checks the generation before dispatch.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional

import numpy as np
import torch

from ..utils.logger import get_logger

log = get_logger(__name__)


class EncodingCache:
    def __init__(self, executor, chunk: int = 8, max_bytes: int = 4 << 30):
        self.executor = executor
        self.chunk = int(chunk)
        self.max_bytes = int(max_bytes)
        self._table: "OrderedDict[str, torch.Tensor]" = OrderedDict()
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._lock = threading.Lock()
        self._generation = 0  # bumped by flush(); guards stale inserts

    @classmethod
    def maybe_build(cls, executor, adapters=None) -> Optional["EncodingCache"]:
        """The cache when ``VIT_CACHE`` is on and valid for this executor,
        else None with the reason logged (the serve-mode form of
        ``BaseExecutor._maybe_attach_vit_cache``)."""
        config = getattr(executor, "config", None)
        if config is None or not config.get("VIT_CACHE"):
            return None
        if getattr(getattr(executor, "model_config", None), "vit", None) is None:
            log.warning(f"(!) VIT_CACHE ignored: {config.MODEL_CLASS} has no image encoder")
            return None
        for name, spec in (adapters or {}).items():
            if any(n.startswith("vit.") for n in spec.get("lora", {})):
                log.warning(f"(!) VIT_CACHE ignored: serving adapter {name!r} targets the ViT "
                            "(encodings would differ per adapter)")
                return None
        chunk = int(config.get("VIT_CACHE_BATCH", 0) or 8)
        max_bytes = int(float(config.get("VIT_CACHE_MAX_GB", 4)) * 2**30)
        log.info(f"# serving VIT_CACHE on: encode chunk {chunk}, bound {max_bytes >> 20} MiB")
        return cls(executor, chunk, max_bytes)

    def apply(self, ds, image_ids: List) -> None:
        """Swap ``ds``'s lazy ``pixel_values`` for ``vit_encodings`` gathered
        from the table, encoding the batch's missing images first.
        ``image_ids`` align 1:1 with the dataset's rows."""
        if "pixel_values" not in ds.lazy_fields:
            return  # a family without pixels (SaL): nothing to cache
        if len(ds) != len(image_ids):
            raise RuntimeError(f"featurization dropped rows: {len(ds)} != {len(image_ids)}")
        ids = [str(i) for i in image_ids]
        fresh: dict = {}  # this call's own encodes, served even if a flush lands
        n_missing = None
        while True:
            with self._lock:
                gen = self._generation
                need = {}
                for row, i in enumerate(ids):
                    if i not in self._table and i not in fresh and i not in need:
                        need[i] = row
                if n_missing is None:
                    n_missing = len(need)
                if not need:
                    out = []
                    for i in ids:
                        if i in self._table:
                            self._table.move_to_end(i)  # LRU touch
                            out.append(self._table[i])
                        else:  # flushed mid-encode: serve this call's copy
                            out.append(fresh[i])
                    self._hits += len(ids) - n_missing
                    self._misses += n_missing
                    while self._bytes > self.max_bytes and len(self._table) > 1:
                        _, old = self._table.popitem(last=False)
                        self._bytes -= old.numel() * old.element_size()
                    enc = torch.stack(out)
                    break
            new = self._encode_missing(ds, need)  # outside the lock
            with self._lock:
                if self._generation == gen:  # no flush since `need` was read
                    for i, e in new.items():
                        if i not in self._table:
                            self._table[i] = e
                            self._bytes += e.numel() * e.element_size()
            fresh.update(new)
        del ds.lazy_fields["pixel_values"]
        ds.arrays = dict(ds.arrays, vit_encodings=enc)

    @torch.inference_mode()
    def _encode_missing(self, ds, first_row: dict) -> dict:
        """Each missing image encoded once, in ``chunk``-row calls (a short
        chunk repeats its last row). {image_id: encoding}."""
        ex = self.executor
        ex._ensure_params()
        rows = np.fromiter(first_row.values(), dtype=np.int64)
        pixels = ds.lazy_fields["pixel_values"](rows)
        encs = []
        for start in range(0, len(rows), self.chunk):
            pix = pixels[start:start + self.chunk]
            n_valid = len(pix)
            if n_valid < self.chunk:
                pix = np.concatenate([pix, np.repeat(pix[-1:], self.chunk - n_valid, axis=0)])
            pix = torch.from_numpy(np.ascontiguousarray(pix)).to(ex.device)
            encs.append(ex.model.encode_image(pix)[:n_valid])
        return dict(zip(first_row, torch.cat(encs)))

    @property
    def generation(self) -> int:
        """Bumped by every flush: the engine reads it before featurizing a
        batch and again before dispatch, and re-featurizes on a change."""
        with self._lock:
            return self._generation

    def flush(self) -> None:
        """Drop every entry (the weights changed) and bump the generation,
        so an encode in flight cannot insert what it computed before."""
        with self._lock:
            n = len(self._table)
            self._table.clear()
            self._bytes = 0
            self._generation += 1
        if n:
            log.info(f"# serving VIT_CACHE flushed ({n} entries)")

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._table), "bytes": self._bytes, "hits": self._hits,
                    "misses": self._misses}
