"""Structured (onset, rhyme, tone) phoneme tokenizer: triple-id streams.

A copy of ``phoneme_vqa_tpu/tokenizers/phoneme_structured.py``, kept in the
port (which imports nothing from the JAX package). The PhonemeLaTr and
PhonemePreSTU models read and emit (T, 3) id triples; the vocabulary is
built by :class:`~phoneme_vqa_torch.phonology.vocab.VocabBuilder` from
annotation files, or loaded from ``vocab_path``.

The raw ``VocabBuilder`` layout gives <pad> a different id per component,
yet one ``pad_id`` serves all three losses, so the special tokens are
aligned at identical indices in all three parts: every part starts
``none=0, <_>=1, <pad>=2, <bos>=3, <eos>=4``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ..phonology.analyze import is_vietnamese_3, split_rhyme
from ..phonology.compose import compose_word
from ..phonology.vocab import VocabBuilder
from ..utils.registry import TOKENIZERS

_SPECIALS = ["none", "<_>", "<pad>", "<bos>", "<eos>"]


def _align_specials(vocab: dict) -> dict:
    """Re-index each component vocab so the 5 specials share ids 0..4."""
    aligned = {}
    for part, mapping in vocab.items():
        tokens = [t for t, _ in sorted(mapping.items(), key=lambda kv: kv[1])]
        rest = [t for t in tokens if t not in _SPECIALS]
        aligned[part] = {t: i for i, t in enumerate(_SPECIALS + rest)}
    return aligned


@TOKENIZERS.register("StructuredPhonemeTokenizer")
class StructuredPhonemeTokenizer:
    """Encodes text to (T, 3) int triples [onset_id, rhyme_id, tone_id]."""

    NONE_ID = 0
    SPACE_ID = 1
    PAD_ID = 2
    BOS_ID = 3
    EOS_ID = 4

    def __init__(self, vocab_path: Optional[str] = None,
                 annotation_paths: Optional[List[str]] = None):
        if vocab_path and os.path.isfile(vocab_path):
            raw = VocabBuilder.load_vocab(vocab_path)
        else:
            builder = VocabBuilder(annotation_paths or [])
            raw = builder.vocab
            if vocab_path:
                os.makedirs(os.path.dirname(vocab_path) or ".", exist_ok=True)
                builder.save_vocab(vocab_path)
        self.vocab = _align_specials(raw)
        self.inv = {part: {i: t for t, i in mapping.items()}
                    for part, mapping in self.vocab.items()}
        self.pad_id = self.PAD_ID
        self.bos_id = self.BOS_ID
        self.eos_id = self.EOS_ID

    # -- encoding -------------------------------------------------------------

    def _word_triples(self, word: str) -> List[Tuple[int, int, int]]:
        ok, parts = is_vietnamese_3(word)
        if ok:
            onset, rhyme, tone = parts
            return [(
                self.vocab["onset"].get(onset or "none", self.NONE_ID),
                self.vocab["rhyme"].get(rhyme or "none", self.NONE_ID),
                self.vocab["tone"].get(tone or "none", self.NONE_ID),
            )]
        # non-Vietnamese: one triple per character, id in the onset slot
        return [(self.vocab["onset"].get(ch, self.NONE_ID), self.NONE_ID, self.NONE_ID)
                for ch in word]

    def encode(self, sentence: str, max_length: int = 30) -> List[List[int]]:
        triples: List[Tuple[int, int, int]] = []
        for w, word in enumerate(sentence.lower().split()):
            if w > 0:
                triples.append((self.SPACE_ID, self.NONE_ID, self.NONE_ID))
            triples.extend(self._word_triples(word))
        out = [(self.BOS_ID,) * 3] + triples + [(self.EOS_ID,) * 3]
        if len(out) < max_length:
            out = out + [(self.PAD_ID,) * 3] * (max_length - len(out))
        else:
            out = out[:max_length]
        return [list(t) for t in out]

    def batch_encode(self, sentences: List[str], max_length: int = 30) -> np.ndarray:
        return np.asarray([self.encode(s, max_length) for s in sentences], dtype=np.int32)

    def __call__(self, sentences, max_length: int = 30):
        if isinstance(sentences, str):
            return self.encode(sentences, max_length)
        return self.batch_encode(sentences, max_length)

    # -- decoding -------------------------------------------------------------

    def _compose_triple(self, onset_id: int, rhyme_id: int, tone_id: int) -> str:
        # every special maps to "absent" in every slot: an untrained model can
        # argmax <_>/<bos>/<pad> into the rhyme or tone head, and decode must
        # stay total (a crash here would take down serving)
        onset = self.inv["onset"].get(onset_id, "none")
        rhyme = self.inv["rhyme"].get(rhyme_id, "none")
        tone = self.inv["tone"].get(tone_id, "none")
        onset = None if onset in _SPECIALS else onset
        rhyme = None if rhyme in _SPECIALS else rhyme
        tone = None if tone in _SPECIALS else tone
        if rhyme is None:
            return onset or ""
        medial, nucleus, coda = split_rhyme(rhyme, q_onset=onset == "q")
        if nucleus is None:
            return (onset or "") + rhyme
        return compose_word(onset, medial, nucleus, coda, tone) or ""

    def decode(self, triples) -> str:
        arr = np.asarray(triples).reshape(-1, 3)
        words: List[str] = []
        current: List[str] = []
        for onset_id, rhyme_id, tone_id in arr.tolist():
            if onset_id == self.EOS_ID:
                break
            if onset_id in (self.PAD_ID, self.BOS_ID):
                continue
            if onset_id == self.SPACE_ID:
                if current:
                    words.append("".join(current))
                    current = []
                continue
            current.append(self._compose_triple(onset_id, rhyme_id, tone_id))
        if current:
            words.append("".join(current))
        return " ".join(w for w in words if w)

    def batch_decode(self, batch_triples) -> List[str]:
        return [self.decode(t) for t in batch_triples]

    def create_mask(self, triples) -> np.ndarray:
        """Pad mask per timestep: True where the onset slot is <pad>."""
        return np.asarray(triples)[..., 0] == self.PAD_ID

    @property
    def onset_size(self) -> int:
        return len(self.vocab["onset"])

    @property
    def rhyme_size(self) -> int:
        return len(self.vocab["rhyme"])

    @property
    def tone_size(self) -> int:
        return len(self.vocab["tone"])
