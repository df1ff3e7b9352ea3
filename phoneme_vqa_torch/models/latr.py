"""LaTr: layout-aware T5 for scene-text VQA (counterpart of
``phoneme_vqa_tpu/models/latr.py``).

The encoder input is ``concat([ViT(img) -> visual_projector,
T5-embed(ocr) + SpatialModule(coords), T5-embed(question)])`` with mask
``[ones(img), ocr_mask, src_mask]``, followed by a full T5 decoder and the
tied LM head. The ViT is frozen (``LaTrConfig.freeze_vit``, as in the
reference): it runs under ``torch.no_grad``, so no gradient reaches it, and
the trainer gives it no optimizer state. :class:`FusionModel` is the part
LaTr shares with PreSTU (``models/prestu.py``), whose ViT trains.

Model surface: ``forward(batch, labels, label_mask)`` for teacher-forced
logits, ``fuse(batch)``, ``encode(batch)`` (encoder output and mask, as
``SaLFusion.encode``), ``encode_for_generate(batch, max_len)`` and
``decode_step(...)`` for greedy decoding. A batch is a dict of tensors on
the model's device (:func:`to_device_batch`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..data.latr import LaTrDataset
from ..utils.device import resolve_device
from ..utils.registry import MODEL_CONFIGS, MODELS
from .spatial import SpatialModule
from .t5 import RMSNorm, T5, T5Config
from .vit import LayerNorm, ViT, ViTConfig


@dataclasses.dataclass(frozen=True)
class LaTrConfig:
    t5: T5Config = dataclasses.field(default_factory=T5Config)
    vit: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    max_2d_position_embeddings: int = 1024
    freeze_vit: bool = True


def _dtype_of(config) -> torch.dtype:
    name = str(config.get("DTYPE", "bfloat16"))
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def t5_config_from_yaml(config) -> T5Config:
    """Backbone dims. Defaults are vit5-base; YAML keys override."""
    return T5Config(
        vocab_size=config.get("t5_vocab_size", 36096),
        d_model=config.get("d_model", 768),
        d_kv=config.get("d_kv", 64),
        num_heads=config.get("num_heads", 12),
        d_ff=config.get("d_ff", 3072),
        num_layers=config.get("num_encoder_layers", 12),
        num_decoder_layers=config.get("num_t5_decoder_layers", 12),
        feed_forward_proj=config.get("feed_forward_proj", "gated-gelu"),
        tie_word_embeddings=config.get("tie_word_embeddings", True),
        dropout_rate=config.get("dropout_rate", 0.1),
        dtype=_dtype_of(config),
    )


def vit_config_from_yaml(config) -> ViTConfig:
    """ViT dims. Defaults are ViT-base 224/16; YAML keys override."""
    return ViTConfig(
        image_size=config.get("vit_image_size", 224),
        patch_size=config.get("vit_patch_size", 16),
        hidden_size=config.get("vit_hidden_size", 768),
        num_layers=config.get("vit_num_layers", 12),
        num_heads=config.get("vit_num_heads", 12),
        mlp_dim=config.get("vit_mlp_dim", 3072),
        dtype=_dtype_of(config),
    )


@MODEL_CONFIGS.register("LaTr_config")
class LaTr_config:
    """YAML Config -> LaTrConfig."""

    def build(self, config) -> LaTrConfig:
        return LaTrConfig(
            t5=t5_config_from_yaml(config),
            vit=vit_config_from_yaml(config),
            max_2d_position_embeddings=config.get("max_2d_position_embeddings", 1024),
        )


BATCH_KEYS = (
    "pixel_values",
    "coordinates",
    "input_ids",
    "src_attention_mask",
    "ocr_attention_mask",
    "tokenized_ocr",
)


def to_device_batch(batch: Dict[str, np.ndarray], device, keys=BATCH_KEYS):
    """numpy batch -> tensors on ``device`` (the model's inputs only)."""
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device) for k in keys if k in batch}


class FusionModel(nn.Module):
    """The shared skeleton of the LaTr and PreSTU families: the T5 backbone,
    the ViT and its projector; ``fuse`` (the subclass's) builds the encoder
    input. ``t5_decoder`` builds the stock T5 decoder into ``t5`` (a model
    with its own answer decoder passes False, as ``SaLFusion`` does). A
    subclass names its inputs (``BATCH_KEYS``) and the dataset that
    featurizes them (``DATASET``); the executors and the serving engine read
    both from the model class."""

    BATCH_KEYS: tuple = ()
    DATASET: type
    # the stock T5 decoder verifies speculative windows (``decode_step_k``);
    # the custom and phoneme decoder mixins turn this off
    spec_decode_supported = True

    def __init__(self, cfg: LaTrConfig, device="cuda", t5_decoder: bool = True):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        t5c = cfg.t5
        self.t5 = T5(t5c, device, decoder=t5_decoder)
        self.vit = ViT(cfg.vit, device)
        self.visual_projector = nn.Linear(
            cfg.vit.hidden_size, t5c.d_model, device=device, dtype=t5c.dtype
        )

    @property
    def device(self) -> torch.device:
        return self.t5.shared.weight.device

    def encode_image(self, pixel_values):
        """Raw ViT encodings (pre-projector)."""
        return self.vit(pixel_values)

    def _img_features(self, batch):
        """Projected image features from live pixels or from precomputed
        ViT encodings (``vit_encodings``). The ViT takes gradients only when
        the model does not freeze it (``freeze_vit``: LaTr, the customized
        and phoneme families; PreSTU trains it)."""
        if "vit_encodings" in batch:
            return self.visual_projector(batch["vit_encodings"].to(self.cfg.t5.dtype))
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.cfg.freeze_vit):
            encodings = self.vit(batch["pixel_values"])
        return self.visual_projector(encodings)

    def fuse(self, batch):
        raise NotImplementedError

    def encode(self, batch):
        """(encoder output, encoder mask) of a batch."""
        embeds, enc_mask = self.fuse(batch)
        return self.t5.encode(embeds, enc_mask), enc_mask

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


@MODELS.register("LaTr")
class LaTr(FusionModel):
    BATCH_KEYS = BATCH_KEYS
    DATASET = LaTrDataset

    def __init__(self, cfg: LaTrConfig, device="cuda", t5_decoder: bool = True):
        super().__init__(cfg, device, t5_decoder)
        self.spatial = SpatialModule(
            cfg.max_2d_position_embeddings, cfg.t5.d_model, cfg.t5.dtype, self.device
        )

    def fuse(self, batch):
        """[ViT patches | OCR embed + spatial | question] and its mask."""
        img_feat = self._img_features(batch)
        layout_feat = self.t5.embed(batch["tokenized_ocr"]) + self.spatial(batch["coordinates"])
        lang_feat = self.t5.embed(batch["input_ids"])
        embeds = torch.cat([img_feat, layout_feat, lang_feat], dim=1)
        mask = torch.cat(
            [
                torch.ones(img_feat.shape[:2], dtype=torch.int32, device=img_feat.device),
                batch["ocr_attention_mask"].to(torch.int32),
                batch["src_attention_mask"].to(torch.int32),
            ],
            dim=1,
        )
        return embeds, mask


def random_params(model: nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Seeded random values of every parameter, drawn in f32 in
    ``named_parameters`` order on the parameters' device: matrices and
    lookup tables N(0, fan_in^-1/2) (a table's fan-in is its row width, so
    token embeddings stay small beside the residual stream and greedy
    answers depend on the inputs), spatial tables N(0, 1), position
    embeddings N(0, 0.02), biases and the CLS token 0, norm scales (the
    weight of every ``RMSNorm`` and ``LayerNorm``, whatever its name) 1.
    The f32 source of a bf16 model's weights and of its training masters."""
    norm_weights = {
        f"{name}.weight" for name, m in model.named_modules() if isinstance(m, (RMSNorm, LayerNorm))
    }
    out = {}
    for name, p in model.named_parameters():
        value = torch.empty(p.shape, dtype=torch.float32, device=p.device)
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("cls_token") or (leaf == "bias" and p.dim() == 1):
            value.zero_()
        elif name in norm_weights:
            value.fill_(1.0)
        elif name.endswith("position_embeddings"):
            value.normal_(0.0, 0.02, generator=generator)
        elif name.endswith("tables"):
            value.normal_(0.0, 1.0, generator=generator)
        elif "embedding" in name or "shared" in name:  # (rows, width) tables
            value.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
        else:  # Linear (out, in) and Conv (out, in, kh, kw) weights
            value.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
        out[name] = value
    return out


def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fills every parameter with :func:`random_params`, rounded to the
    parameter's dtype."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, value in random_params(model, generator).items():
            params[name].copy_(value)
    return model


def build_latr(config, device="cuda", seed: int = 0, model_cls=None, cfg=None) -> FusionModel:
    """A LaTr-family model (``model_cls``, default :class:`LaTr`; ``cfg``,
    default ``LaTr_config().build(config)``; PreSTU and the customized and
    phoneme models too) from a YAML-style config with seeded random weights.
    Modules are built on the meta device first, so no default init runs."""
    device = resolve_device(device)
    cfg = LaTr_config().build(config) if cfg is None else cfg
    with torch.device("meta"):
        model = (model_cls or LaTr)(cfg, device="meta")
    model = model.to_empty(device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return init_random_(model, generator).eval()
