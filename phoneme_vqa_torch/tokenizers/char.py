"""Character-level answer tokenizer.

A copy of ``phoneme_vqa_tpu/tokenizers/char.py``, kept in the port (which imports
nothing from the JAX package).

Contract: the reference's `core/tokenizer/char_tokenizer.py:1-94` —
vocabulary = Vietnamese diacritic characters + `string.printable` + the four
specials, unknown chars fall back to <unk>, decode cuts at first eos.
"""

from __future__ import annotations

import string
from typing import List, Optional, Sequence

from ..utils.registry import TOKENIZERS

VIETNAMESE_DIACRITIC_CHARACTERS = (
    "ÀÁÂÃÈÉÊÌÍÒÓÔÕÙÚÝàáâãèéêìíòóôõùúýĂăĐđĨĩŨũƠơƯư"
    "ẠạẢảẤấẦầẨẩẪẫẬậẮắẰằẲẳẴẵẶặẸẹẺẻẼẽẾếỀềỂểỄễỆệỈỉỊị"
    "ỌọỎỏỐốỒồỔổỖỗỘộỚớỜờỞởỠỡỢợỤụỦủỨứỪừỬửỮữỰự"
    "ỲỳỴỵỶỷỸỹ"
)


@TOKENIZERS.register("CharTokenizer")
class CharTokenizer:
    def __init__(
        self,
        pad_token: str = "<pad>",
        bos_token: str = "<bos>",
        eos_token: str = "<eos>",
        unk_token: str = "<unk>",
    ):
        self.pad_token = pad_token
        self.bos_token = bos_token
        self.eos_token = eos_token
        self.unk_token = unk_token
        self.special_tokens = [pad_token, bos_token, eos_token, unk_token]

        self.idx2str = (
            list(VIETNAMESE_DIACRITIC_CHARACTERS)
            + list(string.printable)
            + self.special_tokens
        )
        self.str2idx = {s: i for i, s in enumerate(self.idx2str)}
        self.pad_id = self.str2idx[pad_token]
        self.bos_id = self.str2idx[bos_token]
        self.eos_id = self.str2idx[eos_token]
        self.unk_id = self.str2idx[unk_token]

    def __len__(self) -> int:
        return len(self.idx2str)

    def __call__(self, text, max_length=None, padding=True, add_special_tokens=True):
        if isinstance(text, list):
            return self.batch_encode(text, max_length, padding, add_special_tokens)
        return self.encode(text, max_length, padding, add_special_tokens)

    def encode(
        self,
        text: str,
        max_length: Optional[int] = None,
        padding: bool = True,
        add_special_tokens: bool = True,
    ) -> List[int]:
        ids = [self.str2idx.get(ch, self.unk_id) for ch in text]
        total = len(ids) + 2
        if max_length is None:
            max_length = total
        if total > max_length:
            ids = ids[: max_length - 2]
            total = max_length
        if not add_special_tokens:
            return ids
        out = [self.bos_id] + ids + [self.eos_id]
        if padding:
            out += [self.pad_id] * (max_length - total)
        return out

    def batch_encode(self, texts, max_length=None, padding=True, add_special_tokens=True):
        return [self.encode(t, max_length, padding, add_special_tokens) for t in texts]

    def _cut_at_eos(self, ids: Sequence[int]) -> List[int]:
        ids = list(ids)
        try:
            return ids[1 : ids.index(self.eos_id)]
        except ValueError:
            return ids

    def decode(self, ids: Sequence[int]) -> List[str]:
        return self.batch_decode([ids])

    def batch_decode(self, batch_ids) -> List[str]:
        # the reference filters `item not in self.special_tokens`, comparing
        # int ids against token *strings* — always true — so only the eos cut
        # actually filters; replicate by dropping nothing else except range
        out = []
        for ids in batch_ids:
            kept = self._cut_at_eos(ids)
            out.append("".join(self.idx2str[i] for i in kept))
        return out
