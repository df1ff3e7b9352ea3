"""PreSTU: OCR-aware T5 without layout embeddings (counterpart of
``phoneme_vqa_tpu/models/prestu.py``).

The encoder input is ``concat([ViT(img) -> visual_projector,
T5-embed(question ⊕ OCR ids)])`` with mask ``[ones(img), src_mask]``: the
dataset fuses the OCR tokens into ``input_ids`` (``data/prestu.py``), and
there is no bounding-box stream. The ViT is **not** frozen
(``PreSTU_config``: ``freeze_vit=False``): it trains with the rest, so in a
train step its 12 attention layers run under ``FusedAttentionFn`` on the
card. Everything else is :class:`~.latr.FusionModel`'s.
"""

from __future__ import annotations

import torch

from ..data.prestu import PreSTUDataset
from ..utils.registry import MODEL_CONFIGS, MODELS
from .latr import FusionModel, LaTrConfig, t5_config_from_yaml, vit_config_from_yaml

# the model's inputs (phoneme_vqa_tpu/train/prestu_executor.py: BATCH_KEYS)
BATCH_KEYS = ("pixel_values", "input_ids", "src_attention_mask")


@MODEL_CONFIGS.register("PreSTU_config")
class PreSTU_config:
    """YAML Config -> LaTrConfig with a trainable ViT."""

    def build(self, config) -> LaTrConfig:
        return LaTrConfig(
            t5=t5_config_from_yaml(config),
            vit=vit_config_from_yaml(config),
            freeze_vit=False,
        )


@MODELS.register("PreSTU")
class PreSTU(FusionModel):
    BATCH_KEYS = BATCH_KEYS
    DATASET = PreSTUDataset

    def fuse(self, batch):
        """[ViT patches | question ⊕ OCR tokens] and its mask."""
        img_feat = self._img_features(batch)
        lang_feat = self.t5.embed(batch["input_ids"])
        embeds = torch.cat([img_feat, lang_feat], dim=1)
        mask = torch.cat(
            [
                torch.ones(img_feat.shape[:2], dtype=torch.int32, device=img_feat.device),
                batch["src_attention_mask"].to(torch.int32),
            ],
            dim=1,
        )
        return embeds, mask
