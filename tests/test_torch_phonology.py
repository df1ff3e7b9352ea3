"""The port's copies of the phonology engine and the answer tokenizers
against the JAX package's, exactly: each public function over the fixture
answers and a word list (real, foreign and boundary words), the flat phoneme
vocabulary, and the phoneme, BPE, byte and char tokenizers' encode and
decode. One parametrised test per function."""

import json

import pytest

from phoneme_vqa_torch import phonology as t_ph
from phoneme_vqa_torch.phonology import analyze as t_an
from phoneme_vqa_torch.phonology import vocab as t_vocab
from phoneme_vqa_torch.tokenizers import bpe as t_bpe
from phoneme_vqa_torch.tokenizers import byte as t_byte
from phoneme_vqa_torch.tokenizers import char as t_char
from phoneme_vqa_torch.tokenizers import phoneme_flat as t_flat
from phoneme_vqa_torch.utils.registry import TOKENIZERS as T_TOKENIZERS
from phoneme_vqa_tpu import phonology as j_ph
from phoneme_vqa_tpu.phonology import analyze as j_an
from phoneme_vqa_tpu.phonology import vocab as j_vocab
from phoneme_vqa_tpu.tokenizers import bpe as j_bpe
from phoneme_vqa_tpu.tokenizers import byte as j_byte
from phoneme_vqa_tpu.tokenizers import char as j_char
from phoneme_vqa_tpu.tokenizers import phoneme_flat as j_flat

from .fixtures import ANSWERS, OCR_WORDS, QUESTIONS

SENTENCES = list(ANSWERS) + list(QUESTIONS) + [
    "Quán Phở, 24h!", "giá 30.000đ / tô", "COVID-19 ok", "khúc khuỷu  ngoằn ngoèo",
    "Nguyễn Huệ - Quận 1", "  ", "", "email@abc.com", "thuở xưa, huế ơi!",
]
WORDS = sorted({w for s in SENTENCES for w in s.lower().split()} | {
    w for ws in OCR_WORDS for w in ws} | set(
    "gì gìn giếng giết chào người việt thành phố hồ chí minh quá trời hoa quả thủy "
    "điện thuở huệ nước mắm bún chả nem rán bánh mì đường xe máy ô tô trường sách "
    "vở bút viết màu xanh vàng tím trắng đen nâu một hai ba bốn năm sáu bảy tám chín "
    "mười triệu tỷ khuya khoắn quyết quyển xuyến chuyển nguyệt yêu thương ưu tú ượp "
    "ươn oong boong xoong moóc giây giấy dây đây đấy ấy ơi ạ ừ ứ ị ọ ẹ loà xoà hoạ "
    "sĩ goá ky cy ki ci ke ce ghe ge ghi gia nghe nge nghia ngia qua quy q qa oa hoă "
    "oe ua uô muô mua muôn uya ya yá yà uy tuy túy tùy oo ooc mooc hooh iê miê miên "
    "yê yên ây tây ă ằ ăn ri rua roa gioa giua riêng mao meo mio muo may mây mấy "
    "miy mai măi mâi mii mei manh mênh monh munh mang mong mông mung mưng meng "
    "hello world 123 covid-19 ok! xyz qwerty pizza 3d abc123 đđđ ngh tr ph z w f j "
    "email.com n0n ăăă ôôô 24h 0123456789 30.000đ".split()))


def _outcome(fn, *args):
    """The result, or the exception's type and message."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - an exception is an outcome to compare
        return ("raised", type(e).__name__, str(e))


# name -> how to call it on a word, given the module
WORD_FUNCTIONS = {
    "analyze_syllable_strict": lambda m, w: m.analyze_syllable(w, True, m.TONE_VI),
    "analyze_syllable_lax": lambda m, w: m.analyze_syllable(w, False, m.TONE_ASCII),
    "is_vietnamese_5": lambda m, w: m.is_vietnamese_5(w),
    "is_vietnamese_3": lambda m, w: m.is_vietnamese_3(w),
    "split_non_vietnamese_word": lambda m, w: m.split_non_vietnamese_word(w),
    "decompose_non_vietnamese_word": lambda m, w: m.decompose_non_vietnamese_word(w),
    "get_tone": lambda m, w: m.get_tone(w),
    "get_tone_ascii": lambda m, w: m.get_tone(w, m.TONE_ASCII),
    "get_onset": lambda m, w: m.get_onset(w),
    "get_medial": lambda m, w: m.get_medial(w),
    "get_nucleus": lambda m, w: m.get_nucleus(w),
    "get_coda": lambda m, w: (m.get_coda(w[-2:]), m.get_coda(w[-1:])),
    "split_phoneme": lambda m, w: m.split_phoneme(m.get_tone(w)[1]),
    "get_rhyme": lambda m, w: m.get_rhyme(w),
    "split_rhyme": lambda m, w: m.split_rhyme(m.get_rhyme(w)),
    "split_rhyme_after_q": lambda m, w: m.split_rhyme(m.get_rhyme(w), q_onset=True),
}


@pytest.mark.parametrize("name", list(WORD_FUNCTIONS))
def test_word_function_equals_the_jax_copy(name):
    call = WORD_FUNCTIONS[name]
    got = [_outcome(call, t_an, w) for w in WORDS]
    want = [_outcome(call, j_an, w) for w in WORDS]
    assert got == want
    assert any(o[0] == "ok" and o[1] not in (None, (False, None)) for o in got)


def test_compose_word_equals_the_jax_copy_and_round_trips():
    """Equal to the JAX copy on every syllable's parts; the word itself comes
    back except where the tone mark moves to the modern placement ("goá" ->
    "góa")."""
    n_viet = n_back = 0
    for word in WORDS:
        ok, comps = j_an.is_vietnamese_5(word)
        if not ok:
            continue
        n_viet += 1
        got = t_ph.compose_word(*comps)
        assert got == j_ph.compose_word(*comps), word
        n_back += got == word
        medial_nucleus_coda = comps[1:4]
        assert t_ph.compose_word(None, *medial_nucleus_coda, None) == \
            j_ph.compose_word(None, *medial_nucleus_coda, None)
    assert n_viet > 100 and n_back > 0.95 * n_viet, (n_back, n_viet)


@pytest.mark.parametrize("name", ["preprocess_sentence"])
def test_sentence_function_equals_the_jax_copy(name):
    assert [getattr(t_ph, name)(s) for s in SENTENCES] == \
        [getattr(j_ph, name)(s) for s in SENTENCES]


def test_vocabularies_equal_the_jax_copies(tmp_path):
    assert t_vocab.FLAT_PHONEME_VOCAB == j_vocab.FLAT_PHONEME_VOCAB
    assert len(t_vocab.FLAT_PHONEME_VOCAB) == 253
    assert t_vocab.FLAT_SPECIALS == j_vocab.FLAT_SPECIALS
    path = tmp_path / "ann.json"
    path.write_text(json.dumps({"annotations": [
        {"question": q, "answers": [a]} for q, a in zip(QUESTIONS, SENTENCES)]},
        ensure_ascii=False), encoding="utf-8")
    got, want = t_vocab.VocabBuilder([str(path)]), j_vocab.VocabBuilder([str(path)])
    assert got.vocab == want.vocab and got.word_sources == want.word_sources


# -- tokenizers ------------------------------------------------------------------


def _phoneme_cases(tok):
    out = []
    for s in SENTENCES:
        ids = tok.encode(t_ph.preprocess_sentence(s), 40)
        out.append((ids, tok.decode(ids), tok.decode_raw(ids), tok(s, max_length=12)))
    out.append(tok.batch_encode(SENTENCES, 16).tolist())
    out.append(tok.batch_decode([tok.encode(s, 40) for s in SENTENCES]))
    return out


def _bpe_pair(tmp_path):
    corpus = [s for s in SENTENCES if s.strip()] * 3
    return (t_bpe.BPETokenizer(data=corpus, step=4, save_path=str(tmp_path / "port.json"),
                               max_vocab_size=300),
            j_bpe.BPETokenizer(data=corpus, step=4, save_path=str(tmp_path / "jax.json"),
                               max_vocab_size=300))


def _subword_cases(tok):
    """Encode (padded, truncated, without specials, batched) and decode."""
    out = []
    for s in SENTENCES:
        ids = tok(s, max_length=40, padding=True)
        out.append((ids, tok.encode(s, 6), tok.encode(s, add_special_tokens=False),
                    tok.decode(ids), tok.batch_decode([ids])))
    out.append(tok.batch_encode(SENTENCES, 40))
    out.append((len(tok), tok.pad_id, tok.bos_id, tok.eos_id))
    return out


@pytest.mark.parametrize("kind", ["phoneme", "bpe", "byte", "char"])
def test_tokenizer_encode_decode_equals_the_jax_copy(kind, tmp_path):
    if kind == "phoneme":
        got, want = _phoneme_cases(t_flat.PhonemeTokenizer()), _phoneme_cases(
            j_flat.PhonemeTokenizer())
    elif kind == "bpe":
        port, jax_tok = _bpe_pair(tmp_path)
        got, want = _subword_cases(port), _subword_cases(jax_tok)
        # a second instance loads the saved vocab instead of training
        reloaded = t_bpe.BPETokenizer(save_path=str(tmp_path / "port.json"))
        assert _subword_cases(reloaded) == got
    else:
        mod_t, mod_j = {"byte": (t_byte, j_byte), "char": (t_char, j_char)}[kind]
        cls = {"byte": "ByteTokenizer", "char": "CharTokenizer"}[kind]
        got = _subword_cases(getattr(mod_t, cls)())
        want = _subword_cases(getattr(mod_j, cls)())
    assert got == want


@pytest.mark.parametrize("name", ["PhonemeTokenizer", "BPE_Tokenizer", "ByteTokenizer",
                                  "CharTokenizer"])
def test_tokenizer_registry_names(name):
    from phoneme_vqa_tpu.utils.registry import TOKENIZERS as J_TOKENIZERS

    assert T_TOKENIZERS.get(name).__name__ == J_TOKENIZERS.get(name).__name__
    assert T_TOKENIZERS.get(name).__module__.startswith("phoneme_vqa_torch.")


def test_phoneme_decode_recomposes_diacritics_and_splits_what_it_cannot_hold():
    tok = t_flat.PhonemeTokenizer()
    rt = lambda s: tok.decode(tok.encode(t_ph.preprocess_sentence(s), 40))
    assert rt("Quán Phở Hà Nội") == "quán phở hà nội"
    assert rt("nguyễn huệ") == "nguyễn huệ"
    assert rt("24h") == "2 4 h"  # digits and foreign letters are tokens of their own
    assert rt("0123456789") == "0 1 2 3 4 5 6 7 8 9"
