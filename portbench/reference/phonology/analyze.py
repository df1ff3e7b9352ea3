"""Vietnamese syllable analysis (pure Python, dependency-free).

A frozen copy of ``phoneme_vqa_torch/phonology/analyze.py``, kept with the
benchmark's reference.

Behavioral contract extracted from the reference's two analyzer variants:

* decode variant  — the reference's `decode/word_processing.py:4-274`
  (5-tuple output ``(onset, medial, nucleus, coda, tone)``, Vietnamese tone
  token names ``<huyền>…<nặng>``, strict rule set).
* tokenizer variant — the reference's `core/tokenizer/modules/word_processing.py:4-288`
  (3-tuple output ``(onset, rhyme, tone)``, ASCII tone token names
  ``<`> </> <~> <?> <.>``, slightly laxer rule set, non-Vietnamese fallback
  through `split_non_vietnamese_word`).

Both variants share one analyzer core here; the validity rules are expressed
as compatibility tables instead of the reference's if-chains. Rules the
reference lists but that are unreachable (``coda == "ph"`` — "ph" is not a
coda; the duplicated ``medial o`` checks) are dropped: behavior is identical.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Tone marks
# ---------------------------------------------------------------------------

# combining char -> Vietnamese token name (decode/word_processing.py:5-11)
TONE_VI = {
    "̀": "<huyền>",
    "́": "<sắc>",
    "̃": "<ngã>",
    "̉": "<hỏi>",
    "̣": "<nặng>",
}
# combining char -> ASCII token name (core/tokenizer/modules/word_processing.py:5-11)
TONE_ASCII = {
    "̀": "<`>",
    "́": "</>",
    "̃": "<~>",
    "̉": "<?>",
    "̣": "<.>",
}

_TONE_MARKS = frozenset(TONE_VI)


def get_tone(word: str, names: dict = TONE_VI) -> Tuple[Optional[str], str]:
    """Strip the tone mark from a word; return (tone token | None, base word).

    NFD-decomposes, removes the (last) tone-combining character, NFC-recomposes
    — matching `decode/word_processing.py:4-22`.
    """
    tone = None
    kept = []
    for ch in unicodedata.normalize("NFD", word):
        if ch in _TONE_MARKS:
            tone = names[ch]
        else:
            kept.append(ch)
    return tone, unicodedata.normalize("NFC", "".join(kept))


# ---------------------------------------------------------------------------
# Component inventories (fixed linguistic data; decode/word_processing.py:25-79)
# ---------------------------------------------------------------------------

ONSETS = (
    "ngh", "tr", "th", "ph", "nh", "ng", "kh",
    "gi", "gh", "ch", "q", "đ", "x", "v", "t",
    "s", "r", "n", "m", "l", "k", "h", "g", "d",
    "c", "b",
)

NUCLEI = (
    "oo", "ươ", "ưa", "uô", "ua", "iê", "yê",
    "ia", "ya", "e", "ê", "u", "ư", "ô", "i",
    "y", "o", "ơ", "â", "a", "ă",
)

CODAS = ("ng", "nh", "ch", "u", "n", "o", "p", "c", "m", "y", "i", "t")

# contexts in which a leading "o"/"u" is a medial glide, not the nucleus
_O_MEDIAL_FOLLOWERS = ("a", "ă", "e")
_U_MEDIAL_FOLLOWERS = ("ê", "y", "ơ", "a", "â", "ya")


def get_onset(word: str) -> Tuple[Optional[str], str]:
    """Longest-prefix onset. Quirk kept from the reference
    (`decode/word_processing.py:24-37`): a "q" onset is reported but NOT
    stripped — `get_medial` later consumes the whole "qu" digraph."""
    for onset in ONSETS:
        if word.startswith(onset):
            rest = word if onset == "q" else word[len(onset):]
            return onset, rest
    return None, word


def get_medial(word: str) -> Tuple[Optional[str], str]:
    """Medial glide o/u (`decode/word_processing.py:39-64`)."""
    if word.startswith("q"):
        # "q" is always followed by the medial "u"; if the (non-Vietnamese)
        # word lacks the "u" nothing is consumed — reference's removeprefix
        return "u", (word[2:] if word.startswith("qu") else word)
    for follower in _O_MEDIAL_FOLLOWERS:
        if word.startswith("o" + follower):
            return "o", word[1:]
    if word.startswith("ua") or word.startswith("uô"):
        return None, word  # "ua"/"uô" are diphthong nuclei, not medial+nucleus
    for follower in _U_MEDIAL_FOLLOWERS:
        if word.startswith("u" + follower):
            return "u", word[1:]
    return None, word


def get_nucleus(word: str) -> Tuple[Optional[str], str]:
    for nucleus in NUCLEI:
        if word.startswith(nucleus):
            return nucleus, word[len(nucleus):]
    return None, word


def get_coda(word: str) -> Optional[str]:
    return word if word in CODAS else None


def split_phoneme(word: str):
    """(onset, medial, nucleus, coda) of a tone-less word
    (`decode/word_processing.py:86-95`)."""
    onset, rest = get_onset(word)
    medial, rest = get_medial(rest)
    nucleus, rest = get_nucleus(rest)
    coda = get_coda(rest)
    return onset, medial, nucleus, coda


def split_rhyme(rhyme: str, q_onset: bool = False):
    """Split rhyme text back into (medial, nucleus, coda). After a "q" onset
    the leading "u" is always the medial glide (get_medial can't see the
    onset, so the caller passes ``q_onset``)."""
    if q_onset and rhyme.startswith("u"):
        medial, rest = "u", rhyme[1:]
    else:
        medial, rest = get_medial(rhyme)
    nucleus, rest = get_nucleus(rest)
    coda = get_coda(rest)
    return medial, nucleus, coda


def get_rhyme(word: str) -> str:
    """medial+nucleus+coda of a (possibly toned) word
    (`core/tokenizer/modules/word_processing.py:93-108`)."""
    _, base = get_tone(word)
    _, rest = get_onset(base)
    medial, rest = get_medial(rest)
    nucleus, rest = get_nucleus(rest)
    coda = get_coda(rest)
    return "".join(p for p in (medial, nucleus, coda) if p)


# ---------------------------------------------------------------------------
# Phonotactic validity
# ---------------------------------------------------------------------------

_FRONT = frozenset({"i", "y", "e", "ê", "iê", "yê", "ia", "ya"})

# onset -> (requires_front, allowed_front_set) with no medial present.
# k/gh/ngh require a front nucleus from their set; c/g/ng forbid it.
_ONSET_FRONT_REQUIRED = {
    "k": _FRONT,
    "gh": frozenset({"i", "e", "ê", "iê"}),
    "ngh": frozenset({"i", "e", "ê", "iê", "yê", "ia", "ya"}),
}
_ONSET_FRONT_FORBIDDEN = {
    "c": _FRONT,
    "g": frozenset({"i", "e", "ê", "iê"}),
    "ng": frozenset({"i", "e", "ê", "iê", "yê", "ia", "ya"}),
}

# medial -> nuclei it may precede
_MEDIAL_ALLOWED_NUCLEI = {
    "o": frozenset({"a", "ă", "e"}),
    "u": frozenset({"yê", "ya", "e", "ê", "y", "ơ", "ô", "a", "â", "ă"}),
}

# coda -> nuclei it may follow (None entry = complement rule below)
_CODA_ALLOWED_NUCLEI = {
    "o": frozenset({"a", "e"}),
    "y": frozenset({"a", "â"}),
    "nh": frozenset({"a", "i", "y", "ê"}),
    "ng": frozenset({"a", "o", "ô", "u", "ư", "e", "iê", "ươ", "â", "ă", "uô", "oo"}),
    "ch": frozenset({"i", "a", "ê", "y"}),
}
_CODA_FORBIDDEN_NUCLEI = {
    "i": frozenset({"ă", "â", "i", "e", "iê", "yê", "ia", "ya"}),
    "c": frozenset({"i", "ê", "e", "ơ"}),
}
# decode-variant only:
_CODA_U_FORBIDDEN_NUCLEI = frozenset(
    {"i", "e", "ơ", "o", "ô", "y", "ia", "ya", "oo", "ưa", "ă"}
)

_NO_CODA_NUCLEI = frozenset({"ua", "ia", "ya"})          # open-syllable-only nuclei
_CODA_REQUIRED_NUCLEI = frozenset({"iê", "yê", "ă", "â"})  # both variants
_CODA_REQUIRED_STRICT = frozenset({"ươ", "uô"})            # decode variant only

# special toneless forms whose written "gi" onset swallows the nucleus "i"
_GI_RESPELL = {
    "gin": "giin",
    "giêng": "giiêng",
    "giêt": "giiêt",
    "giêc": "giiêc",
    "gi": "gii",
}

_VIET_FIRST_CHAR = re.compile(r"[a-zA-Zăâđưôơê]")

_SINGLE_CHAR_VOWELS = frozenset(
    n for n in NUCLEI if len(n) == 1
)  # {e,ê,u,ư,ô,i,y,o,ơ,â,a,ă}


def _one_syllable(word: str) -> bool:
    """At most two vowel runs starting after position 0 — the reference's
    `foundVowels > 2` loop (`decode/word_processing.py:114-135`). Note the
    reference compares single characters against a list that also holds
    digraphs; only single-char vowels can ever match."""
    prev = word[0] in _SINGLE_CHAR_VOWELS
    runs = 0
    for ch in word[1:]:
        cur = ch in _SINGLE_CHAR_VOWELS
        if cur and not prev:
            runs += 1
            if runs > 2:
                return False
        prev = cur
    return True


def _violates(onset, medial, nucleus, coda, strict: bool) -> bool:
    """True if the (onset, medial, nucleus, coda) combination breaks a
    phonotactic rule. ``strict`` selects the decode-variant extras
    (`decode/word_processing.py:143-199` vs the tokenizer variant which
    lacks them)."""
    if strict:
        if nucleus in _CODA_REQUIRED_STRICT and coda is None:
            return True
        if nucleus == "ya" and medial is None:
            return True
        if nucleus == "y" and coda is not None:
            return True
        if onset in ("r", "gi") and medial is not None:
            return True
        if coda == "u" and nucleus in _CODA_U_FORBIDDEN_NUCLEI:
            return True

    if medial is None:
        required = _ONSET_FRONT_REQUIRED.get(onset)
        if required is not None and nucleus not in required:
            return True
        forbidden = _ONSET_FRONT_FORBIDDEN.get(onset)
        if forbidden is not None and nucleus in forbidden:
            return True
    if onset == "q" and medial != "u":
        return True

    if medial is not None:
        allowed = _MEDIAL_ALLOWED_NUCLEI.get(medial)
        if allowed is not None and nucleus not in allowed:
            return True
        if nucleus in _FRONT and coda == "m":
            return True

    if nucleus == "oo" and coda not in ("ng", "c"):
        return True
    if nucleus in _NO_CODA_NUCLEI and coda is not None:
        return True
    if nucleus in _CODA_REQUIRED_NUCLEI and coda is None:
        return True

    if coda is not None:
        allowed = _CODA_ALLOWED_NUCLEI.get(coda)
        if allowed is not None and nucleus not in allowed:
            return True
        forbidden = _CODA_FORBIDDEN_NUCLEI.get(coda)
        if forbidden is not None and nucleus in forbidden:
            return True

    if nucleus == coda:
        return True
    return False


def _analyze(word: str, strict: bool, tone_names: dict):
    """Returns ``(parts | None, base)`` where ``base`` is the tone-stripped
    (and gi-respelled) form — the reference feeds exactly this form to its
    non-Vietnamese fallback."""
    tone, base = get_tone(word, tone_names)
    if not base or not _VIET_FIRST_CHAR.match(base):
        return None, base
    base = _GI_RESPELL.get(base, base)
    if not _one_syllable(base):
        return None, base

    onset, medial, nucleus, coda = split_phoneme(base)
    if nucleus is None:
        return None, base
    # reassembly check: the split must consume the word exactly
    if "".join(p for p in (onset, medial, nucleus, coda) if p) != base:
        return None, base
    if _violates(onset, medial, nucleus, coda, strict):
        return None, base
    return (onset, medial, nucleus, coda, tone), base


def analyze_syllable(
    word: str, strict: bool, tone_names: dict
) -> Optional[Tuple[Optional[str], Optional[str], Optional[str], Optional[str], Optional[str]]]:
    """Full analysis of one lowercase word.

    Returns ``(onset, medial, nucleus, coda, tone)`` if the word is a valid
    Vietnamese syllable under the chosen rule set, else None.
    """
    parts, _ = _analyze(word, strict, tone_names)
    return parts


# ---------------------------------------------------------------------------
# Public variant APIs (drop-in equivalents of the two reference functions)
# ---------------------------------------------------------------------------


def is_vietnamese_5(word: str):
    """decode-variant `is_Vietnamese` (`decode/word_processing.py:97-247`):
    (True, (onset, medial, nucleus, coda, tone)) with Vietnamese tone names,
    or (False, None)."""
    parts = analyze_syllable(word, strict=True, tone_names=TONE_VI)
    if parts is None:
        return False, None
    return True, parts


def is_vietnamese_3(word: str):
    """tokenizer-variant `is_Vietnamese`
    (`core/tokenizer/modules/word_processing.py:121-288`):
    (True, (onset, rhyme, tone)) with ASCII tone names, or
    (False, split_non_vietnamese_word(tone-stripped word))."""
    parts, base = _analyze(word, strict=False, tone_names=TONE_ASCII)
    if parts is None:
        return False, split_non_vietnamese_word(base)
    onset, medial, nucleus, coda, tone = parts
    rhyme = "".join(p for p in (medial, nucleus, coda) if p)
    return True, (onset, rhyme, tone)


def split_non_vietnamese_word(word: str):
    """Non-Vietnamese fallback of the tokenizer variant
    (`core/tokenizer/modules/word_processing.py:109-120`): if the
    NFD-decomposed token is a bare onset return it in the onset slot,
    otherwise put everything in the coda slot."""
    decomposed = unicodedata.normalize("NFD", word)
    onset_set = {
        "m", "b", "v", "t", "đ", "n", "x", "s", "l", "h", "r", "g", "d",
        "k", "q", "c", "ph", "th", "nh", "tr", "ch", "kh", "gh", "gi",
        "ng", "ngh",
    }
    if decomposed in onset_set:
        return decomposed, "", ""
    return "", "", decomposed


# Effective single-char vowel set of `decompose_non_vietnamese_word`
# (`decode/word_processing.py:250-253`). The reference list contains the
# implicit string concatenation `"ê" "i"` == "êi", so neither "ê" nor "i"
# ever matches — kept bug-compatible because the flat PhonemeTokenizer's
# round-trip depends on it.
_DECOMPOSE_VOWELS = frozenset({"a", "ă", "â", "e", "o", "ô", "ơ", "u", "ư"})


def decompose_non_vietnamese_word(word: str):
    """Per-character 5-tuples for non-Vietnamese words
    (`decode/word_processing.py:249-274`)."""
    out = []
    for ch in word:
        tone, base = get_tone(ch, TONE_VI)
        if base in _DECOMPOSE_VOWELS:
            out.append((None, None, base, None, tone))
        else:
            out.append((base, None, None, None, tone))
    return out
