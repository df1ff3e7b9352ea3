"""SaL: spatially-aware T5 for scene-text VQA (counterpart of
``phoneme_vqa_tpu/models/sal.py``).

The encoder input is ``concat([T5-embed(question), ocr_embed, obj_embed])``
where each feature stream's embed is ``RMSNorm(proj(features)) +
RMSNorm(proj(bbox4)) + T5-embed(ids)``, with one norm per stream applied to
the two projections apart. A 2D position bias (1D sequence + SCP spatial on
the OCR block, ``models/rel_bias_2d.py``) replaces the encoder's own
relative bias. :class:`SaLFusion` holds this shared front end and encoder;
:class:`SaL` adds the stock T5 decoder and tied LM head, and
``models/customized.py`` the custom answer decoders.

How the bias reaches the encoder is the ``SAL_FUSED`` knob
(``ops.attention.enable_sal_fused``, set by the executor), see
:func:`encoder_bias`: on, every encoder layer gets the factored form, so on
the card each encoder attention is the SaL kernel
(``ops/sal_fused_attention.py``), in training under ``SalAttentionFn``
(kernel forward; in bf16 the backward kernels, whose logits' gradient the
tables' gradients sum); off,
the (B, H, L, L) f32 bias is materialized once per forward and every layer
reads it through the attention kernel. Both compute the same function. The
JAX package materializes in training whatever the knob (``train_bias``),
because XLA on a TPU v5e ran the fused kernel's recompute backward slower;
that is an XLA means and does not carry over: the port keeps the factored
form in training too and lets the knob, set from H100 times (PERF.md),
choose. Dropout sits in the T5 blocks (``models/t5.py``).

Model surface as ``models/latr.py``: ``forward(batch, labels, label_mask)``,
``fuse(batch)``, ``encode_for_generate(batch, max_len)`` and
``decode_step(...)``; a batch is a dict of tensors on the model's device
(``models.latr.to_device_batch`` with :data:`BATCH_KEYS`).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import attention as attn_mod
from ..ops.sal_fused_attention import FusedSalBias
from ..utils.device import resolve_device
from ..utils.registry import MODEL_CONFIGS, MODELS
from .latr import init_random_, t5_config_from_yaml
from .rel_bias_2d import Sal2DPositionBias
from .t5 import RMSNorm, T5, T5Config

# the model's inputs (phoneme_vqa_tpu/train/sal_executor.py: BATCH_KEYS)
BATCH_KEYS = (
    "input_ids",
    "src_attention_mask",
    "tokenized_ocr",
    "ocr_attention_mask",
    "ocr_coordinates",
    "ocr_features",
    "tokenized_obj",
    "obj_attention_mask",
    "obj_coordinates",
    "obj_features",
)


@dataclasses.dataclass(frozen=True)
class SaLConfig:
    t5: T5Config = dataclasses.field(default_factory=T5Config)
    ocr_hidden: int = 512
    obj_hidden: int = 2048
    max_ques: int = 80
    max_ocr: int = 128


@MODEL_CONFIGS.register("SaL_config")
class SaL_config:
    """YAML Config -> SaLConfig; ``new_token_embedding_size`` (the tokenizer
    length once the ``<c>`` context token is added) replaces the vocab."""

    def build(self, config, new_token_embedding_size: int | None = None) -> SaLConfig:
        t5 = t5_config_from_yaml(config)
        if new_token_embedding_size:
            t5 = dataclasses.replace(t5, vocab_size=new_token_embedding_size)
        return SaLConfig(
            t5=t5,
            ocr_hidden=config.get("ocr_hidden", 512),
            obj_hidden=config.get("obj_hidden", 2048),
            max_ques=config.get("max_q_length", 80),
            max_ocr=config.get("max_ocr_length", 128),
        )


def encoder_bias(bias: FusedSalBias):
    """The 2D bias as every encoder layer receives it: the factored form
    when ``SAL_FUSED`` is on (the SaL kernel on the card), else the (B, H, L,
    L) f32 bias materialized once (the attention kernel on the card)."""
    return bias if attn_mod.sal_fused_enabled() else bias.materialize()


class SaLFusion(nn.Module):
    """The SaL family's front end (stream embeddings, the 2D bias) and T5
    encoder; subclasses add a decoder. ``t5_decoder`` builds the stock T5
    decoder into ``t5``."""

    BATCH_KEYS = BATCH_KEYS
    # the stock T5 decoder verifies speculative windows (``decode_step_k``);
    # the custom and phoneme decoder mixins turn this off
    spec_decode_supported = True

    def __init__(self, cfg: SaLConfig, device="cuda", t5_decoder: bool = True):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        t5c = cfg.t5
        dense = lambda d_in: nn.Linear(d_in, t5c.d_model, device=device, dtype=t5c.dtype)
        norm = lambda: RMSNorm(t5c.d_model, t5c.layer_norm_epsilon, t5c.dtype, device)
        self.t5 = T5(t5c, device, encoder_rel_bias=False, decoder=t5_decoder)
        self.rel2d = Sal2DPositionBias(t5c.num_heads, device=device)
        self.ocr_feature_projector = dense(cfg.ocr_hidden)
        self.ocr_bbox_projector = dense(4)
        self.ocr_norm = norm()
        self.obj_feature_projector = dense(cfg.obj_hidden)
        self.obj_bbox_projector = dense(4)
        self.obj_norm = norm()

    @property
    def device(self) -> torch.device:
        return self.t5.shared.weight.device

    def _stream_embed(self, ids, coords, features, feature_projector, bbox_projector, norm):
        dtype = self.cfg.t5.dtype
        return (
            norm(feature_projector(features.to(dtype)))
            + norm(bbox_projector(coords.float().to(dtype)))
            + self.t5.embed(ids)
        )

    def fuse(self, batch):
        """[question | OCR | OBJ], its mask and the factored 2D bias."""
        ocr = self._stream_embed(
            batch["tokenized_ocr"], batch["ocr_coordinates"], batch["ocr_features"],
            self.ocr_feature_projector, self.ocr_bbox_projector, self.ocr_norm,
        )
        obj = self._stream_embed(
            batch["tokenized_obj"], batch["obj_coordinates"], batch["obj_features"],
            self.obj_feature_projector, self.obj_bbox_projector, self.obj_norm,
        )
        ques = self.t5.embed(batch["input_ids"])
        embeds = torch.cat([ques, ocr, obj], dim=1)
        mask = torch.cat(
            [
                batch["src_attention_mask"].to(torch.int32),
                batch["ocr_attention_mask"].to(torch.int32),
                batch["obj_attention_mask"].to(torch.int32),
            ],
            dim=1,
        )
        bias = self.rel2d(embeds.shape[1], batch["ocr_coordinates"], self.cfg.max_ques,
                          self.cfg.max_ocr)
        # the kernel reads bias1d every layer: carry both tables in the
        # compute dtype (in bf16 this rounding is part of the function)
        dtype = self.cfg.t5.dtype
        bias = bias._replace(bias1d=bias.bias1d.to(dtype), cell_bias=bias.cell_bias.to(dtype))
        return embeds, mask, bias

    def encode(self, batch):
        """(encoder output, encoder mask) of a batch."""
        embeds, enc_mask, bias = self.fuse(batch)
        return self.t5.encode(embeds, enc_mask, position_bias=encoder_bias(bias)), enc_mask


@MODELS.register("SaL")
class SaL(SaLFusion):
    """SaL with the stock T5 decoder and tied LM head."""

    def forward(self, batch, labels, label_mask):
        """Teacher-forced (B, T, V) f32 logits."""
        enc_out, enc_mask = self.encode(batch)
        return self.t5.decode(labels, enc_out, enc_mask, label_mask)

    def encode_for_generate(self, batch, max_length: int):
        enc_out, enc_mask = self.encode(batch)
        cache, full_bias = self.t5.init_cache(enc_out, max_length)
        return cache, full_bias, enc_mask

    def decode_step(self, tokens, cache, index: int, full_bias, enc_mask):
        return self.t5.decode_step(tokens, cache, index, full_bias, enc_mask)

    def decode_step_k(self, tokens, cache, pos, full_bias, enc_mask):
        """A K-token step at per-row positions (speculative verification,
        the pool decode)."""
        return self.t5.decode_step_k(tokens, cache, pos, full_bias, enc_mask)


def build_sal(config, device="cuda", seed: int = 0, model_cls=None, cfg=None) -> SaLFusion:
    """A SaL-family model (``model_cls``, default :class:`SaL`; ``cfg``,
    default ``SaL_config().build(config)``) from a YAML-style config with
    seeded random weights (``models.latr.init_random_``). Modules are built
    on the meta device first, so no default init runs."""
    device = resolve_device(device)
    cfg = SaL_config().build(config) if cfg is None else cfg
    with torch.device("meta"):
        model = (model_cls or SaL)(cfg, device="meta")
    model = model.to_empty(device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return init_random_(model, generator).eval()
