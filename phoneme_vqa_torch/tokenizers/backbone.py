"""Backbone (question/OCR) text tokenizer.

The HF tokenizer (``VietAI/vit5-base``) is used when it is cached locally;
otherwise a deterministic, dependency-free subword tokenizer with the same
call surface stands in. Its ids are identical to
``phoneme_vqa_tpu.tokenizers.backbone.FallbackSubwordTokenizer``'s.

The fallback keeps the T5 conventions the data layer relies on:
``pad_token_id=0``, ``eos_token_id=1``, dict-style
``tokenizer(text, padding='max_length', max_length=, truncation=True)``
output with ``input_ids``/``attention_mask``, ``is_split_into_words``
handling, and ``batch_decode``.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional

from ..utils.logger import get_logger

log = get_logger(__name__)


class Encoding(dict):
    """Dict with attribute access, like HF BatchEncoding."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


class FallbackSubwordTokenizer:
    """Deterministic offline subword tokenizer (T5-style id conventions).

    Words are split into chunks of at most 4 characters; each chunk maps to
    a stable hash id. A reverse map built on the fly makes decoding exact
    for any id this instance has produced.
    """

    pad_token_id = 0
    eos_token_id = 1
    unk_token_id = 2
    _NUM_SPECIALS = 3

    # special-token strings in plain text parse to their ids, as HF
    # tokenizers do: the data layer's '"<pad> " + text' decoder-start
    # convention depends on it
    _SPECIAL_STRINGS = {"<pad>": 0, "</s>": 1, "<unk>": 2}

    def __init__(self, vocab_size: int = 32128):
        self.vocab_size = vocab_size
        self._id2piece: Dict[int, str] = {0: "<pad>", 1: "</s>", 2: "<unk>"}

    def __len__(self) -> int:
        return self.vocab_size

    def _piece_id(self, piece: str) -> int:
        digest = hashlib.md5(piece.encode("utf-8")).digest()
        pid = self._NUM_SPECIALS + int.from_bytes(digest[:8], "big") % (
            self.vocab_size - self._NUM_SPECIALS
        )
        self._id2piece.setdefault(pid, piece)
        return pid

    @staticmethod
    def _word_pieces(word: str) -> List[str]:
        # sentencepiece-style: a leading marker distinguishes word starts
        chunks = [word[i : i + 4] for i in range(0, len(word), 4)] or [word]
        return [("▁" + chunks[0])] + chunks[1:]

    def _encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in text.split():
            special = self._SPECIAL_STRINGS.get(word)
            if special is not None:
                ids.append(special)
                continue
            ids.extend(self._piece_id(piece) for piece in self._word_pieces(word))
        return ids

    def __call__(
        self,
        text,
        padding=False,
        max_length: Optional[int] = None,
        truncation: bool = False,
        is_split_into_words: bool = False,
        add_special_tokens: bool = True,
    ) -> Encoding:
        if isinstance(text, list):
            if is_split_into_words:
                # one flat sequence over the word list
                ids: List[int] = []
                for w in text:
                    ids.extend(self._encode_text(w))
                if add_special_tokens:
                    ids.append(self.eos_token_id)
                return Encoding(input_ids=ids, attention_mask=[1] * len(ids))
            # batch of independent texts
            encs = [
                self(t, padding, max_length, truncation, False, add_special_tokens)
                for t in text
            ]
            return Encoding(
                input_ids=[e["input_ids"] for e in encs],
                attention_mask=[e["attention_mask"] for e in encs],
            )

        ids = self._encode_text(text)
        if add_special_tokens:
            ids = ids + [self.eos_token_id]
        if truncation and max_length is not None:
            ids = ids[:max_length]
        mask = [1] * len(ids)
        if padding == "max_length" and max_length is not None:
            pad_n = max_length - len(ids)
            ids = ids + [self.pad_token_id] * pad_n
            mask = mask + [0] * pad_n
        return Encoding(input_ids=ids, attention_mask=mask)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        pieces = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i < self._NUM_SPECIALS:
                continue
            pieces.append(self._id2piece.get(i, "<unk>"))
        return "".join(pieces).replace("▁", " ").strip()

    def batch_decode(self, batch_ids, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(row, skip_special_tokens) for row in batch_ids]


def _hub_caches() -> List[str]:
    """The directories the HF hub and transformers keep downloaded repos in,
    by their environment settings and defaults."""
    home = os.environ.get("HF_HOME") or os.path.join(
        os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache"),
        "huggingface")
    named = [os.environ.get(k) for k in ("HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE",
                                          "TRANSFORMERS_CACHE", "PYTORCH_TRANSFORMERS_CACHE",
                                          "PYTORCH_PRETRAINED_BERT_CACHE")]
    return [d for d in named if d] + [os.path.join(home, "hub")]


def _may_be_local(name: str) -> bool:
    """False only when no local copy of ``name`` can exist: it is no path,
    and no hub cache holds its repo."""
    if os.path.exists(name):
        return True
    repo = "models--" + name.replace("/", "--")
    return any(os.path.isdir(os.path.join(d, repo)) for d in _hub_caches())


def load_backbone_tokenizer(name: str, vocab_size: int = 32128):
    """The HF tokenizer if it is cached locally, else the offline subword
    tokenizer. This picks a tokenizer, not a device. transformers is an
    optional dependency, imported only here, and only when a local copy
    may exist: its import costs a process's start many seconds, for nothing
    where no copy is cached."""
    if _may_be_local(name):
        try:
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(name, local_files_only=True)
        except Exception:
            pass
    log.info(
        f"Backbone tokenizer {name!r} not available locally; "
        "using deterministic offline fallback tokenizer"
    )
    return FallbackSubwordTokenizer(vocab_size=vocab_size)
