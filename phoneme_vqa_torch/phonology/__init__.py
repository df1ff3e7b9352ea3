"""Vietnamese phonology: syllable analysis and re-composition, phoneme
vocabularies (a copy of ``phoneme_vqa_tpu/phonology/``)."""

from .analyze import (
    TONE_ASCII,
    TONE_VI,
    analyze_syllable,
    decompose_non_vietnamese_word,
    get_coda,
    get_medial,
    get_nucleus,
    get_onset,
    get_rhyme,
    get_tone,
    is_vietnamese_3,
    is_vietnamese_5,
    split_non_vietnamese_word,
    split_phoneme,
)
from .compose import compose_word, preprocess_sentence

__all__ = [
    "TONE_ASCII",
    "TONE_VI",
    "analyze_syllable",
    "compose_word",
    "decompose_non_vietnamese_word",
    "get_coda",
    "get_medial",
    "get_nucleus",
    "get_onset",
    "get_rhyme",
    "get_tone",
    "is_vietnamese_3",
    "is_vietnamese_5",
    "preprocess_sentence",
    "split_non_vietnamese_word",
    "split_phoneme",
]
