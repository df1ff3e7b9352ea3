"""Frozen-ViT encoding cache (``VIT_CACHE: true``; counterpart of
``phoneme_vqa_tpu/data/vit_cache.py``).

The LaTr family freezes its ViT, which has no dropout, so its forward is a
function of (weights, pixels): with the weights fixed, each unique image is
encoded once and the encodings are fed to the model as a batch input
(``vit_encodings``, read by ``FusionModel._img_features``). That takes the
ViT's forward, and its attention-kernel launches, out of every later train
and eval batch, and VQA data carries several questions an image, so even
one eval pass does less ViT work.

The executor decides when a cache is valid
(``train/base_executor.py: _maybe_attach_vit_cache``); this module runs the
encoder over the unique images and swaps the dataset's lazy
``pixel_values`` field for a ``vit_encodings`` gather. The table stays on
the encoder's device, so a batch gathers its rows there and moves no pixels.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def attach_vit_cache(dataset, encode_fn: Callable[[np.ndarray], torch.Tensor],
                     batch_size: int, max_bytes: int = 8 << 30) -> Tuple[bool, str]:
    """Encode every unique image of ``dataset`` with ``encode_fn(pixels) ->
    encodings`` (the model's image encoder at the current weights, before
    the projector, which stays in the step) and replace its lazy
    ``pixel_values`` field with a ``vit_encodings`` gather. Every call of
    ``encode_fn`` gets ``batch_size`` rows (a short last chunk repeats its
    last row). Returns ``(attached, reason)``; a table over ``max_bytes``
    is not built."""
    if getattr(dataset, "_vit_cache_attached", False):
        return True, "already attached"
    if "pixel_values" not in dataset.lazy_fields:
        return False, "dataset has no lazy pixel_values field"
    if dataset.image_ids is None:
        return False, "dataset carries no image_ids (cannot dedup)"

    ids = np.asarray([str(i) for i in dataset.image_ids])
    uniq, first_rows, row_to_uniq = np.unique(ids, return_index=True, return_inverse=True)
    loader = dataset.lazy_fields["pixel_values"]
    chunks = []
    for start in range(0, len(uniq), batch_size):
        rows = first_rows[start:start + batch_size].astype(np.int64)
        n_valid = len(rows)
        if n_valid < batch_size:
            rows = np.concatenate([rows, np.full(batch_size - n_valid, rows[-1], np.int64)])
        enc = encode_fn(loader(rows))[:n_valid]
        if start == 0:
            total = enc[0].numel() * enc.element_size() * len(uniq)
            if total > max_bytes:
                return False, (f"encoding table would be {total / 2**30:.1f} GiB for "
                               f"{len(uniq)} unique images (cap {max_bytes / 2**30:.1f} GiB; "
                               "raise VIT_CACHE_MAX_GB to override)")
        chunks.append(enc)
    table = torch.cat(chunks) if len(chunks) > 1 else chunks[0]
    index = torch.from_numpy(row_to_uniq.reshape(-1).astype(np.int64)).to(table.device)

    lazy = dict(dataset.lazy_fields)
    del lazy["pixel_values"]
    lazy["vit_encodings"] = lambda idx: table[index[torch.from_numpy(
        np.asarray(idx, np.int64)).to(table.device)]]
    dataset.lazy_fields = lazy
    dataset._vit_cache_attached = True
    return True, (f"{len(uniq)} unique images for {len(ids)} rows "
                  f"({table.numel() * table.element_size() / 2**20:.1f} MiB, {table.dtype})")
