"""BPE answer tokenizer backed by HuggingFace `tokenizers`.

A copy of ``phoneme_vqa_tpu/tokenizers/bpe.py``, kept in the port (which imports
nothing from the JAX package).

Contract: the reference's `core/tokenizer/bpe_tokenizer.py:14-109` —
byte-level BPE trained from the answer corpus on first use, persisted to a
JSON vocab file; specials <pad> <bos> <eos> <unk>; encode wraps bos/eos and
pads to max_length.
"""

from __future__ import annotations

from typing import List, Optional

from ..utils.logger import get_logger
from ..utils.registry import TOKENIZERS

log = get_logger(__name__)


@TOKENIZERS.register("BPE_Tokenizer")
class BPETokenizer:
    def __init__(
        self,
        data=None,
        step: Optional[int] = None,
        save_path: str = "bpevocab.json",
        max_vocab_size: int = 5000,
        pad_token: str = "<pad>",
        bos_token: str = "<bos>",
        eos_token: str = "<eos>",
        unk_token: str = "<unk>",
    ):
        import os

        from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

        self.pad_token = pad_token
        self.bos_token = bos_token
        self.eos_token = eos_token
        self.unk_token = unk_token
        self.special_tokens = [pad_token, bos_token, eos_token, unk_token]

        if os.path.isfile(save_path):
            log.info(f"Loading trained bpe tokenizer from {save_path}")
            self.tokenizer = Tokenizer.from_file(save_path)
        else:
            log.info(f"Training bpe tokenizer ({max_vocab_size} max vocab)")
            tok = Tokenizer(models.BPE(unk_token=unk_token))
            tok.pre_tokenizer = pre_tokenizers.ByteLevel()
            trainer = trainers.BpeTrainer(
                vocab_size=max_vocab_size,
                special_tokens=self.special_tokens,
                unk_token=unk_token,
            )
            corpus = list(data or [])
            step = step or max(1, len(corpus))

            def batches():
                for i in range(0, len(corpus), step):
                    yield corpus[i : i + step]

            tok.train_from_iterator(batches(), trainer=trainer)
            tok.decoder = decoders.ByteLevel()
            self.tokenizer = tok
            self.tokenizer.save(save_path)

        self.bos_id = self.tokenizer.token_to_id(bos_token)
        self.eos_id = self.tokenizer.token_to_id(eos_token)
        self.pad_id = self.tokenizer.token_to_id(pad_token)

    def __len__(self) -> int:
        return len(self.tokenizer.get_vocab())

    def __call__(self, text, max_length=None, padding=True, add_special_tokens=True):
        if isinstance(text, list):
            return self.batch_encode(text, max_length, padding, add_special_tokens)
        return self.encode(text, max_length, padding, add_special_tokens)

    def encode(self, text, max_length=None, padding=True, add_special_tokens=True) -> List[int]:
        if not add_special_tokens:
            return self.tokenizer.encode(text).ids
        ids = self.tokenizer.encode(self.bos_token + text + self.eos_token).ids
        if max_length and padding:
            ids = ids + [self.pad_id] * (max_length - len(ids))
        return ids

    def batch_encode(self, texts, max_length=None, padding=True, add_special_tokens=True):
        wrapped = [self.bos_token + t + self.eos_token for t in texts]
        rows = [e.ids for e in self.tokenizer.encode_batch(wrapped)]
        if add_special_tokens and max_length and padding:
            rows = [r + [self.pad_id] * (max_length - len(r)) for r in rows]
        return rows

    def decode(self, ids) -> str:
        return self.tokenizer.decode(list(ids)).strip()

    def batch_decode(self, batch_ids) -> List[str]:
        return [s.strip() for s in self.tokenizer.decode_batch([list(i) for i in batch_ids])]
