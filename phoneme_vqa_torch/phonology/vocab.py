"""Phoneme vocabularies.

A copy of ``phoneme_vqa_tpu/phonology/vocab.py``, kept in the port (which imports
nothing from the JAX package).

* `FLAT_PHONEME_VOCAB` — the fixed closed vocabulary of the flat
  PhonemeTokenizer (the reference's `core/tokenizer/phoneme_tokenizer.py:14-88`):
  4 specials + 26 onsets + rhymes/punct/digits/foreign letters + 5 tone marks.
* `VocabBuilder` — builds the 3-part (onset / rhyme / tone) vocabulary from
  dataset annotation JSONs (the reference's `core/tokenizer/modules/vocab_builder.py:11-113`).
"""

from __future__ import annotations

import json
import string
from typing import Dict, List, Optional

from .analyze import ONSETS, is_vietnamese_3

_FLAT_RHYMES = (
    # a
    "a ac ach ai am an ang anh ao ap at ay au "
    # ă
    "ă ăc ăm ăn ăng ăp ăt "
    # â
    "â âc âm ân âng âp ât âu ây "
    # e
    "e ec em en eng eo ep et "
    # ê
    "ê êch êm ên ênh êp êt êu "
    # i
    "i ia ich iêc iêm iên iêng iêp iêt iêu im in inh ip it iu "
    # o
    "o oa oac oach oai oam oan oang oanh oao oap oat oay "
    "oăc oăm oăn oăng oăt oc oe oen oeo oet oi om on ong ooc oong op ot "
    # ô
    "ô ôc ôi ôm ôn ông ôp ôt "
    # ơ
    "ơ ơi ơm ơn ơp ơt "
    # u
    "u ua uân uâng uât uây uc uê uêch uênh ui um un ung uơ uôc "
    "uôi uôm uôn uông uôt up ut uy uya uych uyên uyêt uyn uynh uyp uyt uyu "
    "uach uai uan uang uanh uao uat uau uay "
    "uăc uăm uăn uăng uăp uăt uâc uoang "
    "ue uen ueo uet uên uêt uêu uơi "
    # ư
    "ư ưa ưc ưi ưng ươc ươi ươm ươn ương ươp ươt ươu ưt ưu "
    # y
    "y yêm yên yêng yêt yêu"
).split() + list("?,.-/!@():%\"*'+$<>") + list("0123456789") + list("wfzjp")

_FLAT_TONES = ["<huyền>", "<sắc>", "<ngã>", "<hỏi>", "<nặng>"]

FLAT_SPECIALS = ["<pad>", "<bos>", "<eos>", "<blank>"]

FLAT_PHONEME_VOCAB: List[str] = FLAT_SPECIALS + list(ONSETS) + _FLAT_RHYMES + _FLAT_TONES


class VocabBuilder:
    """3-part onset/rhyme/tone vocabulary from annotation JSONs.

    Mirrors the reference's `core/tokenizer/modules/vocab_builder.py:11-113`:
    each part starts with 'none'=0; onset carries '<_>' (space) and the
    specials; Vietnamese words contribute (onset, rhyme, tone) from the
    tokenizer-variant analyzer; non-Vietnamese words contribute their
    lowercase characters to the onset part plus all ascii lowercase/digits/
    punctuation.
    """

    def __init__(self, annotation_paths: Optional[List[str]] = None):
        self.annotation_paths = annotation_paths or []
        self.vocab: Dict[str, Dict[str, int]] = {
            "onset": {"none": 0, "<_>": 1, "<pad>": 2, "<bos>": 3, "<eos>": 4},
            "rhyme": {"none": 0, "<pad>": 1},
            "tone": {"none": 0, "<pad>": 1},
        }
        # provenance tracking for the inspection helpers
        # (vocab_builder.py:34-35,128-135)
        self.word_sources: Dict[str, Dict[str, List[str]]] = {
            "onset": {}, "rhyme": {}, "tone": {},
        }
        self.text_sources: Dict[str, Dict[str, List[str]]] = {"rhyme": {}}
        self._build()

    def _add(self, part: str, token: str) -> None:
        bucket = self.vocab[part]
        if token not in bucket:
            bucket[token] = len(bucket)

    def _track(self, part: str, token: str, word: str, text: str = None) -> None:
        self.word_sources[part].setdefault(token, []).append(word)
        if part == "rhyme" and text is not None:
            self.text_sources["rhyme"].setdefault(token, []).append(text)

    def add_text(self, text: str) -> None:
        for word in text.split():
            word = word.lower()
            is_viet, parts = is_vietnamese_3(word)
            if is_viet:
                onset, rhyme, tone = parts
                onset = onset.lower() if onset else "none"
                rhyme = rhyme.lower() if rhyme else "none"
                tone = tone.lower() if tone else "none"
                self._add("onset", onset)
                self._add("rhyme", rhyme)
                self._add("tone", tone)
                self._track("onset", onset, word)
                self._track("rhyme", rhyme, word, text)
                self._track("tone", tone, word)
            else:
                for ch in word:
                    if ch.islower():
                        self._add("onset", ch)
                        self._track("onset", ch, word)
                for ch in string.ascii_lowercase + string.digits + string.punctuation:
                    self._add("onset", ch)

    # -- inspection helpers (vocab_builder.py:115-135) ------------------------

    def check_vocab(self) -> None:
        print("Vocabulary Size:", {k: len(v) for k, v in self.vocab.items()})
        for part, mapping in self.vocab.items():
            print(f"Category: {part}")
            for token, idx in mapping.items():
                print(f"  {token}: {idx}")

    def find_word_source(self, part: str, key: str) -> None:
        sources = self.word_sources.get(part, {})
        if key in sources:
            print(f"Words that contributed to {part} {key!r}: {sources[key]}")
            if part == "rhyme" and key in self.text_sources["rhyme"]:
                print(
                    f"Original texts that contained rhyme {key!r}: "
                    f"{self.text_sources['rhyme'][key]}"
                )
        else:
            print(f"{part.capitalize()} {key!r} not found in vocabulary.")

    def _build(self) -> None:
        for path in self.annotation_paths:
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
            for ann in data.get("annotations", []):
                for field in ("question", "answers"):
                    if field in ann:
                        value = ann[field]
                        text = value if isinstance(value, str) else value[0]
                        self.add_text(text)

    def save_vocab(self, output_path: str) -> None:
        with open(output_path, "w", encoding="utf-8") as f:
            json.dump(self.vocab, f, ensure_ascii=False, indent=4)

    @staticmethod
    def load_vocab(path: str) -> Dict[str, Dict[str, int]]:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
