"""Flat phoneme answer tokenizer (used by the PhonemeSaL family).

A frozen copy of ``phoneme_vqa_torch/tokenizers/phoneme_flat.py`` (which imports
nothing from the JAX package).

Contract: the reference's `core/tokenizer/phoneme_tokenizer.py:5-177` —
fixed closed vocabulary; each word is linearized as
``[onset][rhyme][tone]<blank>`` where rhyme = medial+nucleus+coda composed
text; bos/eos wrap; pad/truncate to max_length. `decode` maps ``<blank>`` to
a space, strips specials, collapses whitespace.

Divergence from the reference (documented): tokens missing from the closed
vocabulary are skipped instead of raising KeyError.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .phonology.analyze import (
    ONSETS,
    decompose_non_vietnamese_word,
    is_vietnamese_5,
    split_rhyme,
)
from .phonology.compose import compose_word
from .phonology.vocab import FLAT_PHONEME_VOCAB, FLAT_SPECIALS


class PhonemeTokenizer:
    pad_token = "<pad>"
    bos_token = "<bos>"
    eos_token = "<eos>"
    blank_token = "<blank>"

    def __init__(self):
        self.special_tokens = list(FLAT_SPECIALS)
        self.phoneme2idx = {p: i for i, p in enumerate(FLAT_PHONEME_VOCAB)}
        self.idx2phoneme = {i: p for p, i in self.phoneme2idx.items()}
        self.pad_idx = self.phoneme2idx[self.pad_token]
        self.bos_idx = self.phoneme2idx[self.bos_token]
        self.eos_idx = self.phoneme2idx[self.eos_token]
        self.blank_idx = self.phoneme2idx[self.blank_token]
        # aliases used by some call sites
        self.pad_id, self.bos_id, self.eos_id = self.pad_idx, self.bos_idx, self.eos_idx

    @property
    def size(self) -> int:
        return len(self.phoneme2idx)

    def __len__(self) -> int:
        return len(self.phoneme2idx)

    def encode(self, sentence: str, max_length: int) -> List[int]:
        components = []
        for word in sentence.split():
            ok, parts = is_vietnamese_5(word)
            if ok:
                components.append(parts)
            else:
                components.extend(decompose_non_vietnamese_word(word))

        ids: List[int] = []
        for onset, medial, nucleus, coda, tone in components:
            rhyme = compose_word(None, medial, nucleus, coda, None)
            for token in (onset, rhyme, tone):
                if token:
                    idx = self.phoneme2idx.get(token)
                    if idx is not None:
                        ids.append(idx)
            ids.append(self.blank_idx)
        ids = ids[:-1] if ids else ids  # drop trailing word separator
        ids = [self.bos_idx] + ids + [self.eos_idx]

        if len(ids) < max_length:
            ids = ids + [self.pad_idx] * (max_length - len(ids))
        else:
            ids = ids[:max_length]
        return ids

    def batch_encode(self, sentences: List[str], max_length: int) -> np.ndarray:
        rows = [self.encode(s.lower(), max_length) for s in sentences]
        return np.asarray(rows, dtype=np.int32)

    def decode_raw(self, ids: Sequence[int]) -> str:
        """Reference-parity decode: raw component text with literal tone
        tokens (e.g. "quan<sắc>"), exactly as
        `core/tokenizer/phoneme_tokenizer.py:146-162` produces."""
        pieces = []
        for idx in np.asarray(ids).reshape(-1).tolist():
            phoneme = self.idx2phoneme[int(idx)]
            pieces.append(" " if phoneme == self.blank_token else phoneme)
        text = "".join(p for p in pieces if p not in self.special_tokens)
        return " ".join(text.split())

    def decode(self, ids: Sequence[int]) -> str:
        """Diacritic-recomposing decode (intended behavior).

        The reference's decode concatenates component text with literal tone
        tokens, so "quán" round-trips to "quan<sắc>" — and its metrics compare
        that against raw answers. Here each blank-separated component group is
        recomposed with `compose_word`, making phoneme decoding lossless for
        valid syllables. `decode_raw` preserves the reference behavior."""
        n_onsets = len(ONSETS)
        onset_lo = len(self.special_tokens)
        rhyme_lo = onset_lo + n_onsets
        tone_lo = self.size - 5

        groups: List[List[int]] = [[]]
        for idx in np.asarray(ids).reshape(-1).tolist():
            idx = int(idx)
            if idx == self.blank_idx:
                groups.append([])
            elif idx not in (self.pad_idx, self.bos_idx, self.eos_idx):
                groups[-1].append(idx)

        words = []
        for group in groups:
            onset = rhyme = tone = None
            for idx in group:
                token = self.idx2phoneme[idx]
                if idx >= tone_lo:
                    tone = token
                elif idx >= rhyme_lo:
                    rhyme = token
                elif idx >= onset_lo:
                    onset = token
            if rhyme is None:
                word = onset or ""
            else:
                medial, nucleus, coda = split_rhyme(rhyme, q_onset=onset == "q")
                if nucleus is None:
                    # rhyme is punctuation/digit/foreign letter text
                    word = (onset or "") + rhyme
                else:
                    word = compose_word(onset, medial, nucleus, coda, tone) or ""
            if word:
                words.append(word)
        return " ".join(words)

    def batch_decode(self, batch_ids, compose: bool = True) -> List[str]:
        fn = self.decode if compose else self.decode_raw
        return [fn(row) for row in batch_ids]

    def __call__(self, sentences, max_length: int = 30):
        if isinstance(sentences, str):
            return self.encode(sentences.lower(), max_length)
        return self.batch_encode(sentences, max_length)

    def create_mask(self, ids) -> np.ndarray:
        """Pad mask: True where the position is padding."""
        return np.asarray(ids) == self.pad_idx
