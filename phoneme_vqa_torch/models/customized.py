"""Customized{LaTr, PreSTU, SaL}: the stock fusion encoders with the custom
post-LN answer decoder over a pluggable answer-tokenizer vocabulary
(counterpart of ``phoneme_vqa_tpu/models/customized.py``).

The backbone is encoder-only: ``t5`` holds the encoder and the shared
embedding, and ``decoder`` is :class:`~.custom_decoder.CustomDecoder`,
whose dropout draws from the backbone's stream. :class:`_CustomDecodeMixin`
works over any model with ``encode(batch) -> (encoder output, mask)``
(``FusionModel`` for LaTr and PreSTU, ``SaLFusion``). The LaTr and PreSTU
variants freeze their ViT. Generation is the same KV-cached greedy loop as
the stock families, with the answer vocabulary's (bos, eos, pad)
(:attr:`_CustomDecodeMixin.decode_token_ids`).
"""

from __future__ import annotations

import dataclasses

from ..utils.registry import MODEL_CONFIGS, MODELS
from .custom_decoder import CustomDecoder, CustomDecoderConfig
from .latr import LaTr, LaTrConfig, t5_config_from_yaml, vit_config_from_yaml
from .prestu import PreSTU
from .sal import SaLConfig, SaLFusion
from .t5 import T5Config


@dataclasses.dataclass(frozen=True)
class CustomizedLaTrConfig(LaTrConfig):
    decoder: CustomDecoderConfig = dataclasses.field(default_factory=CustomDecoderConfig)


@dataclasses.dataclass(frozen=True)
class CustomizedSaLConfig(SaLConfig):
    decoder: CustomDecoderConfig = dataclasses.field(default_factory=CustomDecoderConfig)


def decoder_config_from_yaml(config, t5: T5Config, tgt_vocab_size: int, pad_id: int,
                             bos_id: int, eos_id: int) -> CustomDecoderConfig:
    return CustomDecoderConfig(
        vocab_size=tgt_vocab_size,
        d_model=t5.d_model,
        num_heads=config.get("n_head", 12),
        num_layers=config.get("num_decoder_layers", 4),
        dropout_rate=config.get("dropout_rate", 0.1),
        pad_id=pad_id,
        bos_id=bos_id,
        eos_id=eos_id,
        dtype=t5.dtype,
    )


@MODEL_CONFIGS.register("CustomizedLaTr_config")
class CustomizedLaTr_config:
    """YAML Config -> CustomizedLaTrConfig (frozen ViT); the executor passes
    the answer tokenizer's size and ids."""

    def build(self, config, tgt_vocab_size: int = 1000, pad_id: int = 0, bos_id: int = 1,
              eos_id: int = 2) -> CustomizedLaTrConfig:
        t5 = t5_config_from_yaml(config)
        return CustomizedLaTrConfig(
            t5=t5,
            vit=vit_config_from_yaml(config),
            max_2d_position_embeddings=config.get("max_2d_position_embeddings", 1024),
            freeze_vit=True,
            decoder=decoder_config_from_yaml(config, t5, tgt_vocab_size, pad_id, bos_id,
                                             eos_id),
        )


@MODEL_CONFIGS.register("CustomizedPreSTU_config")
class CustomizedPreSTU_config(CustomizedLaTr_config):
    """The same config for PreSTU (the ViT frozen, as the JAX package's
    builder freezes it); PreSTU has no spatial stream, so
    ``max_2d_position_embeddings`` goes unused."""


@MODEL_CONFIGS.register("CustomizedSaL_config")
class CustomizedSaL_config:
    """YAML Config -> CustomizedSaLConfig; the executor passes the answer
    tokenizer's size and ids, and the backbone tokenizer's length."""

    def build(self, config, tgt_vocab_size: int = 1000, pad_id: int = 0, bos_id: int = 1,
              eos_id: int = 2, new_token_embedding_size: int | None = None
              ) -> CustomizedSaLConfig:
        t5 = t5_config_from_yaml(config)
        if new_token_embedding_size:
            t5 = dataclasses.replace(t5, vocab_size=new_token_embedding_size)
        return CustomizedSaLConfig(
            t5=t5,
            ocr_hidden=config.get("ocr_hidden", 512),
            obj_hidden=config.get("obj_hidden", 2048),
            max_ques=config.get("max_q_length", 80),
            max_ocr=config.get("max_ocr_length", 128),
            decoder=decoder_config_from_yaml(config, t5, tgt_vocab_size, pad_id, bos_id,
                                             eos_id),
        )


class _CustomDecodeMixin:
    """The custom decoder in place of the T5 decoder."""

    # prompt-lookup drafts are backbone token ids, not the answer vocabulary's
    spec_decode_supported = False

    def forward(self, batch, labels, label_mask):
        """Teacher-forced (B, T, V) f32 logits over the answer vocabulary."""
        enc_out, enc_mask = self.encode(batch)
        return self.decoder(labels, enc_out, enc_mask, label_mask)

    def encode_for_generate(self, batch, max_length: int):
        """(cache, None, encoder mask): the custom decoder has no relative
        bias."""
        enc_out, enc_mask = self.encode(batch)
        return self.decoder.init_cache(enc_out, max_length), None, enc_mask

    def decode_step(self, tokens, cache, index: int, full_bias, enc_mask):
        return self.decoder.step(tokens, cache, index, enc_mask)

    def decode_step_k(self, tokens, cache, pos, full_bias, enc_mask):
        """A K-token step at per-row positions (the pool decode); the custom
        decoder has no relative bias."""
        return self.decoder.step_k(tokens, cache, pos, enc_mask)

    @property
    def decode_token_ids(self):
        """(bos, eos, pad) of the answer vocabulary, not the backbone's."""
        c = self.cfg.decoder
        return c.bos_id, c.eos_id, c.pad_id


@MODELS.register("CustomizedLaTr")
class CustomizedLaTr(_CustomDecodeMixin, LaTr):
    def __init__(self, cfg: CustomizedLaTrConfig, device="cuda"):
        super().__init__(cfg, device, t5_decoder=False)
        self.decoder = CustomDecoder(cfg.decoder, self.device, rng=self.t5.dropout_rng)


@MODELS.register("CustomizedPreSTU")
class CustomizedPreSTU(_CustomDecodeMixin, PreSTU):
    def __init__(self, cfg: CustomizedLaTrConfig, device="cuda"):
        super().__init__(cfg, device, t5_decoder=False)
        self.decoder = CustomDecoder(cfg.decoder, self.device, rng=self.t5.dropout_rng)


@MODELS.register("CustomizedSaL")
class CustomizedSaL(_CustomDecodeMixin, SaLFusion):
    def __init__(self, cfg: CustomizedSaLConfig, device="cuda"):
        super().__init__(cfg, device, t5_decoder=False)
        self.decoder = CustomDecoder(cfg.decoder, self.device, rng=self.t5.dropout_rng)
