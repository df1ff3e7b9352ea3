"""Syllable re-composition — the inverse of `analyze` for valid syllables.

A copy of ``phoneme_vqa_tpu/phonology/compose.py``, kept in the port (which imports
nothing from the JAX package).

Contract from the reference's `decode/word_processing.py:276-334`:
`compose_word` re-attaches the tone diacritic with the correct placement
(medial-vs-nucleus rules, the "gii"→"gi" re-spelling fix) and NFC-normalizes.
This is what makes phoneme-level decoding lossless for valid syllables.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Optional

# token name (either naming scheme) -> combining character
_TONE_TO_MARK = {
    "<huyền>": "̀",
    "<sắc>": "́",
    "<ngã>": "̃",
    "<hỏi>": "̉",
    "<nặng>": "̣",
    "<`>": "̀",
    "</>": "́",
    "<~>": "̃",
    "<?>": "̉",
    "<.>": "̣",
}

# Open syllables with a medial glide normally carry the tone on the *medial*
# (hỏa, thủy) — except after "q" and except nuclei ơ/ê (thuở, huế, huệ),
# which follow the general rule (decode/word_processing.py:290-298).
_GENERAL_RULE_NUCLEI = ("ơ", "ê")


def compose_word(
    onset: Optional[str],
    medial: Optional[str],
    nucleus: Optional[str],
    coda: Optional[str],
    tone: Optional[str],
) -> Optional[str]:
    if nucleus is None:
        return onset

    mark = _TONE_TO_MARK.get(tone) if tone else None
    if tone and mark is None and tone != "<blank>":
        raise ValueError(f"Unknown tone token {tone!r}")

    if mark:
        if (
            onset != "q"
            and medial is not None
            and coda is None
            and nucleus not in _GENERAL_RULE_NUCLEI
        ):
            medial = medial + mark
        elif coda is None:
            # tone goes on the first vowel of the nucleus
            nucleus = nucleus[0] + mark + nucleus[1:]
        else:
            # closed syllable: tone goes on the last vowel of the nucleus
            nucleus = nucleus + mark

    word = "".join(p for p in (onset, medial, nucleus, coda) if p)
    if "gii" in word:
        word = re.sub("gii", "gi", word)
    return unicodedata.normalize("NFC", word)


def preprocess_sentence(sentence: str) -> str:
    """Answer-text cleanup (decode/word_processing.py:319-334)."""
    sentence = sentence.lower()
    replacements = [
        ("&", " và "),
        ("_", ""),
        ("#", ""),
        ("|", ""),
        ("~", ""),
        (";", " , "),
        ("/", " / "),
        ("\\", " / "),
        ("=", " bằng "),
    ]
    for old, new in replacements:
        sentence = sentence.replace(old, new)
    return " ".join(sentence.split())
