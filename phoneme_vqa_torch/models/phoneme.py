"""Phoneme decoding models (counterpart of ``phoneme_vqa_tpu/models/phoneme.py``).

* PhonemeLaTr / PhonemePreSTU — (onset, rhyme, tone) TRIPLE streams over the
  LaTr and PreSTU encoders (:class:`PhonemeTripleDecoder`): a 3-part
  embedding (onset width d - 2·⌊d/3⌋, rhyme and tone ⌊d/3⌋) concatenated and
  added to the sinusoidal PE **unscaled** (the custom decoder scales its
  embedding by √d), the post-LN layer stack of ``custom_decoder.py``, and a
  shared d -> d projection whose output each of the three heads reads a
  slice of. Greedy decoding argmaxes each head per step and stops a row at
  its onset EOS (``decode/greedy.py: multi_head_greedy_decode``). The
  labels are (B, T, 3) ids of ``tokenizers/phoneme_structured.py``.
* PhonemeSaL — a FLAT phoneme stream over the SaL encoder: the
  CustomizedSaL model with the closed flat phoneme vocabulary
  (``tokenizers/phoneme_flat.py``, 253 ids), whose ids the executor puts in
  its config. Like the JAX package it keeps the custom decoder's scaled
  token embedding.

The triple decoder's submodules carry the flax scope names
(``onset_embed``, ``layer_i``, ``shared_lm_head``, ``onset_lm_head``, ...),
so ``models/bridge.py`` maps a flax tree 1:1; the PE table is a
non-persistent buffer. Its dropout (after the PE, in every layer) draws
from the backbone's stream, as the custom decoder's does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..utils.registry import MODELS
from .custom_decoder import Cache, CustomDecoderConfig, DecoderStack
from .customized import CustomizedSaL
from .latr import LaTr, LaTrConfig
from .prestu import PreSTU
from .t5 import DropoutRNG


@dataclasses.dataclass(frozen=True)
class PhonemeDecoderConfig:
    onset_vocab: int = 64
    rhyme_vocab: int = 256
    tone_vocab: int = 16
    d_model: int = 768
    num_heads: int = 12
    num_layers: int = 4
    d_ff: int = 2048
    dropout_rate: float = 0.1
    max_len: int = 5000
    pad_id: int = 2
    bos_id: int = 3
    eos_id: int = 4
    dtype: torch.dtype = torch.bfloat16

    @property
    def rt_dim(self) -> int:
        return self.d_model // 3

    @property
    def onset_dim(self) -> int:
        return self.d_model - 2 * self.rt_dim


@dataclasses.dataclass(frozen=True)
class PhonemeLaTrConfig(LaTrConfig):
    phoneme_decoder: PhonemeDecoderConfig = dataclasses.field(
        default_factory=PhonemeDecoderConfig)


class PhonemeTripleDecoder(DecoderStack, nn.Module):
    """Triple-stream decoder: 3-part embedding -> post-LN stack -> shared
    projection -> 3 sliced heads, each returning f32 logits."""

    def __init__(self, cfg: PhonemeDecoderConfig, device=None,
                 rng: Optional[DropoutRNG] = None):
        super().__init__()
        self.cfg = cfg
        embed = lambda v, d: nn.Embedding(v, d, device=device, dtype=torch.float32)
        self.onset_embed = embed(cfg.onset_vocab, cfg.onset_dim)
        self.rhyme_embed = embed(cfg.rhyme_vocab, cfg.rt_dim)
        self.tone_embed = embed(cfg.tone_vocab, cfg.rt_dim)
        layer_cfg = CustomDecoderConfig(
            vocab_size=1,  # unused: the layers need only the widths
            d_model=cfg.d_model, num_heads=cfg.num_heads, num_layers=cfg.num_layers,
            d_ff=cfg.d_ff, dropout_rate=cfg.dropout_rate, max_len=cfg.max_len, dtype=cfg.dtype,
        )
        self._add_stack(layer_cfg, device, rng or DropoutRNG())
        dense = lambda d_in, d_out: nn.Linear(d_in, d_out, device=device, dtype=cfg.dtype)
        self.shared_lm_head = dense(cfg.d_model, cfg.d_model)
        self.onset_lm_head = dense(cfg.onset_dim, cfg.onset_vocab)
        self.rhyme_lm_head = dense(cfg.rt_dim, cfg.rhyme_vocab)
        self.tone_lm_head = dense(cfg.rt_dim, cfg.tone_vocab)

    def _embed(self, triples: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """(B, T, 3) -> (B, T, d): the three embeddings concatenated, plus
        the PE rows from ``offset`` (unscaled), in the compute dtype."""
        x = torch.cat([self.onset_embed(triples[..., 0]), self.rhyme_embed(triples[..., 1]),
                       self.tone_embed(triples[..., 2])], dim=-1)
        return self._with_pe(x, offset)

    def _heads(self, hidden: torch.Tensor):
        c = self.cfg
        shared = self.shared_lm_head(hidden)
        onset = self.onset_lm_head(shared[..., : c.onset_dim])
        rhyme = self.rhyme_lm_head(shared[..., c.onset_dim : c.onset_dim + c.rt_dim])
        tone = self.tone_lm_head(shared[..., c.onset_dim + c.rt_dim :])
        return onset.float(), rhyme.float(), tone.float()

    def forward(self, triples, memory, memory_mask=None, tgt_keep_mask=None):
        """Teacher-forced: (B, T, 3) ids -> (onset, rhyme, tone) (B, T, V_c)
        f32 logits."""
        return self._heads(self._run_stack(self._embed(triples), memory, memory_mask,
                                           tgt_keep_mask))

    def step(self, triples: torch.Tensor, cache: Cache, index: int, memory_mask=None):
        """One decode step at position ``index``: triples (B, 3) -> (3-tuple
        of (B, V_c) f32 logits, cache), the cache written in place."""
        x = self._step_stack(self._embed(triples[:, None, :], offset=index), cache, index,
                             memory_mask)
        onset, rhyme, tone = self._heads(x)
        return (onset[:, 0], rhyme[:, 0], tone[:, 0]), cache

    def step_k(self, triples: torch.Tensor, cache: Cache, pos, memory_mask=None):
        """A K-triple decode step at the per-row positions ``pos`` (B,):
        triples (B, K, 3) -> (3-tuple of (B, K, V_c) f32 logits, cache), the
        window's K/V written in place."""
        x = torch.cat([self.onset_embed(triples[..., 0]), self.rhyme_embed(triples[..., 1]),
                       self.tone_embed(triples[..., 2])], dim=-1)
        return self._heads(self._step_k_stack(self._with_pe_rows(x, pos), cache, pos,
                                              memory_mask)), cache


def phoneme_decoder_from_yaml(config, t5, onset_vocab: int, rhyme_vocab: int, tone_vocab: int,
                              pad_id: int, bos_id: int, eos_id: int) -> PhonemeDecoderConfig:
    return PhonemeDecoderConfig(
        onset_vocab=onset_vocab,
        rhyme_vocab=rhyme_vocab,
        tone_vocab=tone_vocab,
        d_model=t5.d_model,
        num_heads=config.get("n_head", 12),
        num_layers=config.get("num_decoder_layers", 4),
        dropout_rate=config.get("dropout_rate", 0.1),
        pad_id=pad_id,
        bos_id=bos_id,
        eos_id=eos_id,
        dtype=t5.dtype,
    )


class _PhonemeTripleMixin:
    """Triple-decoder plumbing over any model with ``encode(batch)``."""

    decode_components = 3
    # prompt-lookup drafts are backbone token ids, not triples
    spec_decode_supported = False

    def _add_decoder(self):
        self.decoder = PhonemeTripleDecoder(self.cfg.phoneme_decoder, self.device,
                                            rng=self.t5.dropout_rng)

    def forward(self, batch, labels, label_mask):
        """Teacher-forced (onset, rhyme, tone) f32 logits of (B, T, 3)
        labels."""
        enc_out, enc_mask = self.encode(batch)
        return self.decoder(labels, enc_out, enc_mask, label_mask)

    def encode_for_generate(self, batch, max_length: int):
        enc_out, enc_mask = self.encode(batch)
        return self.decoder.init_cache(enc_out, max_length), None, enc_mask

    def decode_step(self, tokens, cache, index: int, full_bias, enc_mask):
        return self.decoder.step(tokens, cache, index, enc_mask)

    def decode_step_k(self, tokens, cache, pos, full_bias, enc_mask):
        """A K-triple step at per-row positions (the pool decode)."""
        return self.decoder.step_k(tokens, cache, pos, enc_mask)

    @property
    def decode_token_ids(self):
        """(bos, eos, pad) of the structured phoneme vocabulary."""
        c = self.cfg.phoneme_decoder
        return c.bos_id, c.eos_id, c.pad_id


@MODELS.register("PhonemeLaTr")
class PhonemeLaTr(_PhonemeTripleMixin, LaTr):
    def __init__(self, cfg: PhonemeLaTrConfig, device="cuda"):
        super().__init__(cfg, device, t5_decoder=False)
        self._add_decoder()


@MODELS.register("PhonemePreSTU")
class PhonemePreSTU(_PhonemeTripleMixin, PreSTU):
    def __init__(self, cfg: PhonemeLaTrConfig, device="cuda"):
        super().__init__(cfg, device, t5_decoder=False)
        self._add_decoder()


@MODELS.register("PhonemeSaL")
class PhonemeSaL(CustomizedSaL):
    """Flat phoneme stream over the SaL encoder; config
    ``CustomizedSaL_config``."""
