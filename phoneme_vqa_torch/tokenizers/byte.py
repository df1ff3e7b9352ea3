"""UTF-8 byte answer tokenizer.

A copy of ``phoneme_vqa_tpu/tokenizers/byte.py``, kept in the port (which imports
nothing from the JAX package).

Contract: the reference's `core/tokenizer/byte_tokenizer.py:1-66` —
raw UTF-8 bytes with pad=256 / bos=257 / eos=258, vocab size 259,
truncate-then-wrap encode, decode cuts at the first eos and drops ids >255.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..utils.registry import TOKENIZERS


@TOKENIZERS.register("ByteTokenizer")
class ByteTokenizer:
    pad_id = 256
    bos_id = 257
    eos_id = 258

    def __len__(self) -> int:
        return 259

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
        ids = list(text.encode("utf-8"))
        total = len(ids) + 2  # room for bos/eos
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

    def _cut_at_eos(self, ids: Sequence[int]) -> Sequence[int]:
        ids = list(ids)
        try:
            return ids[1 : ids.index(self.eos_id)]
        except ValueError:
            return ids

    def decode(self, ids: Sequence[int]) -> List[str]:
        return self.batch_decode([ids])

    def batch_decode(self, batch_ids) -> List[str]:
        out = []
        for ids in batch_ids:
            kept = bytes(i for i in self._cut_at_eos(ids) if 0 <= i < 256)
            out.append(kept.decode("utf-8", errors="ignore"))
        return out
