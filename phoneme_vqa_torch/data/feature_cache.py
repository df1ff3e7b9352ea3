"""On-disk featurization cache (``FEATURE_CACHE: <dir>``; counterpart of
``phoneme_vqa_tpu/data/feature_cache.py``).

Featurization is a host pass over every QA row (tokenizing questions,
OCR words and answers) that each run, and each resumed run, pays before its
first step. The cache keeps the packed arrays under a key made of
everything that determines them:

* the content of the joined QA rows (question, answer, and the OCR words,
  boxes and object labels the stores give each row), not file names or
  times;
* every featurization parameter (max lengths, the context token, ...);
* the dataset class and a cache format ``VERSION``;
* the tokenizer's identity (class + a hash of its vocabulary where it can
  be read, class + size otherwise);
* a ``cache_tag`` from the executor naming the answer encoder (the
  customized and phoneme families encode answers with their own tokenizer).

A hit opens each array memory-mapped (``np.load(mmap_mode="r")``); a batch
``gather`` reads only its rows. Writes go to a temporary directory renamed
into place, so a run stopped while writing leaves no half entry; an entry
that cannot be read is rebuilt over.

The port has no pandas, so the row fingerprint hashes the port's row dicts
(``rows_fingerprint``), not a DataFrame: its keys differ from the JAX
package's, and a cache directory is not shared between the two packages.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.logger import get_logger

log = get_logger(__name__)

VERSION = 1

BuildFn = Callable[[], Tuple[Dict[str, np.ndarray], list]]


def _plain(value):
    """A JSON-ready copy of a row value (numpy scalars and arrays as
    Python numbers and lists)."""
    if isinstance(value, dict):
        return {str(k): _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, np.ndarray):
        return _plain(value.tolist())
    if isinstance(value, np.generic):
        return value.item()
    return value


def rows_fingerprint(rows: Sequence[dict]) -> str:
    """Content hash of the joined QA rows, in order (row order is the
    featurization order)."""
    h = hashlib.sha1()
    for row in rows:
        h.update(json.dumps(_plain(row), sort_keys=True, ensure_ascii=False,
                            default=str).encode())
        h.update(b"\n")
    return h.hexdigest()[:16]


def tokenizer_tag(tok) -> str:
    """Identity tag for any tokenizer: class + vocab hash when the vocab is
    introspectable (``get_vocab()``, or a ``.vocab`` dict), class + len
    otherwise."""
    name = type(tok).__name__
    get_vocab = getattr(tok, "get_vocab", None) or getattr(
        getattr(tok, "tokenizer", None), "get_vocab", None
    )
    vocab = None
    if callable(get_vocab):
        try:
            vocab = get_vocab()
        except (NotImplementedError, AttributeError, TypeError):
            vocab = None
    if vocab is None:
        vocab = getattr(tok, "vocab", None)
    if isinstance(vocab, dict):
        blob = json.dumps(sorted((str(k), str(v)) for k, v in vocab.items()))
        return f"{name}:{hashlib.sha1(blob.encode()).hexdigest()[:12]}"
    try:
        return f"{name}:{len(tok)}"
    except TypeError:
        return name


def compute_key(parts: dict) -> str:
    blob = json.dumps(parts, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:20]


def _load(entry_dir: str):
    with open(os.path.join(entry_dir, "meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    arrays = {
        name: np.load(os.path.join(entry_dir, name + ".npy"), mmap_mode="r")
        for name in meta["arrays"]
    }
    return arrays, meta["image_ids"]


def _save(entry_dir: str, arrays: Dict[str, np.ndarray], image_ids, parts: dict) -> None:
    parent = os.path.dirname(entry_dir) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".tmp_")
    try:
        for name, arr in arrays.items():
            np.save(os.path.join(tmp, name + ".npy"), np.ascontiguousarray(arr))
        meta = {
            "arrays": sorted(arrays),
            "image_ids": _plain(list(image_ids)) if image_ids is not None else None,
            "parts": {k: str(v) for k, v in parts.items()},  # for a reader's eyes
        }
        with open(os.path.join(tmp, "meta.json"), "w", encoding="utf-8") as f:
            json.dump(meta, f)
        try:
            os.replace(tmp, entry_dir)  # atomic publish
        except OSError:
            pass  # another process published first; keep theirs
    finally:
        if os.path.isdir(tmp):  # lost the race (or failed): discard
            shutil.rmtree(tmp, ignore_errors=True)


def get_or_build(cache_dir: Optional[str], parts: dict,
                 build: BuildFn) -> Tuple[Dict[str, np.ndarray], Optional[List]]:
    """(arrays, image_ids): from the cache when an entry for ``parts``
    exists, else from ``build()``, then written to the cache. ``cache_dir``
    None or empty turns the cache off."""
    if not cache_dir:
        return build()
    parts = dict(parts, _version=VERSION)
    key = compute_key(parts)
    entry_dir = os.path.join(cache_dir, key)
    if os.path.isfile(os.path.join(entry_dir, "meta.json")):
        try:
            arrays, image_ids = _load(entry_dir)
            n = len(next(iter(arrays.values()))) if arrays else 0
            log.info(f"# Feature cache HIT {key} ({n} rows) at {entry_dir}")
            return arrays, image_ids
        except (OSError, ValueError, KeyError, EOFError) as e:  # a corrupt entry: rebuild over it
            log.warning(f"feature cache entry {entry_dir} unreadable ({e!r}); rebuilding")
            shutil.rmtree(entry_dir, ignore_errors=True)
    arrays, image_ids = build()
    try:
        _save(entry_dir, arrays, image_ids, parts)
        log.info(f"# Feature cache MISS -> wrote {key} at {entry_dir}")
    except OSError as e:  # a cache that cannot be written must not stop the run
        log.warning(f"feature cache write failed ({e!r}); continuing uncached")
    return arrays, image_ids


def _dir_stat_fingerprint(root: str) -> str:
    """A directory's identity from (name, size, mtime_ns) of every entry:
    O(files) stats, no content reads (a file rewritten in place with the
    same size and time would go stale, as in the JAX package)."""
    h = hashlib.sha1()
    for fname in sorted(os.listdir(root)):
        st = os.stat(os.path.join(root, fname))
        h.update(f"{fname}:{st.st_size}:{st.st_mtime_ns};".encode())
    return h.hexdigest()[:16]


def cached_adapt(root: str, cache_dir: Optional[str], tag: str, build: Callable[[], dict]):
    """Adapted-frame cache (rides ``FEATURE_CACHE``; the JAX package's
    ``data/adapters.py: _cached_adapt``): scanning a feature directory
    re-reads every per-image ``.npy`` pickle, so the adapted store
    ``{image_id: (words, boxes)}`` is kept as JSON per (directory
    fingerprint, adapter, scales). Atomic writes; an unreadable entry is
    rebuilt."""
    if not cache_dir:
        return build()
    key = hashlib.sha1(f"{tag}|{_dir_stat_fingerprint(root)}".encode()).hexdigest()[:20]
    path = os.path.join(cache_dir, f"adapt_{key}.json")
    if os.path.isfile(path):
        try:
            with open(path, encoding="utf-8") as f:
                raw = json.load(f)
            store = {float(k): (list(v[0]), [list(b) for b in v[1]]) for k, v in raw.items()}
            log.info(f"# Adapted-frame cache HIT {tag} ({len(store)} images)")
            return store
        except (OSError, ValueError, KeyError, IndexError, TypeError) as e:
            log.warning(f"adapted-frame cache {path} unreadable ({e!r}); rebuilding")
    store = build()
    try:
        os.makedirs(cache_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".json.tmp")
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump({repr(float(k)): _plain(v) for k, v in store.items()}, f,
                      ensure_ascii=False)
        os.replace(tmp, path)
        log.info(f"# Adapted-frame cache MISS -> wrote {tag} ({len(store)} images)")
    except OSError as e:  # a cache that cannot be written must not stop the run
        log.warning(f"adapted-frame cache write failed ({e!r}); continuing uncached")
    return store
