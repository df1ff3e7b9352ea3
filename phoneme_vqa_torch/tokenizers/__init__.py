"""Tokenizers: the backbone's, and the answer tokenizers of the custom and
phoneme decoders (``TOKENIZERS``, registered on import)."""

from .backbone import FallbackSubwordTokenizer, load_backbone_tokenizer
from .bpe import BPETokenizer
from .byte import ByteTokenizer
from .char import CharTokenizer
from .phoneme_flat import PhonemeTokenizer
from .phoneme_structured import StructuredPhonemeTokenizer

__all__ = [
    "BPETokenizer",
    "ByteTokenizer",
    "CharTokenizer",
    "FallbackSubwordTokenizer",
    "PhonemeTokenizer",
    "StructuredPhonemeTokenizer",
    "load_backbone_tokenizer",
]
