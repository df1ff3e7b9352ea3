"""HF and reference-checkpoint weight import (counterpart of
``phoneme_vqa_tpu/models/hf_import.py``).

The reference starts from ``T5ForConditionalGeneration.from_pretrained`` and
``ViTModel.from_pretrained``. Where the weights exist as local files this
module maps a torch state dict (``model.safetensors`` or
``pytorch_model.bin``) onto the port's parameters by name. The import
writes into a dict of f32 masters (``name -> tensor``, the train state's
``params``) and returns a new one; the executor binds it into the model, so
the compute copies are cast from the imported masters.

HF Linear weights are (out, in), the port's layout: nothing is transposed,
and the ViT's patch convolution is the port's Conv2d as it is. Every
checkpoint key's fate lands in :class:`ImportReport` (mapped, failed with a
reason, unused), and so does every port parameter that no key filled
(``unfilled``: those keep their init and are counted, never skipped
silently).

The card machine has no ``safetensors`` package: :func:`read_safetensors`
reads the format with numpy and the standard library.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.logger import get_logger

log = get_logger(__name__)

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class ImportReport:
    """Every checkpoint key's fate, so a partial import can never pass
    silently.

    * ``mapped``   - checkpoint keys copied into the parameters
    * ``failed``   - (key, reason): shape mismatch, no destination, missing
    * ``unused``   - checkpoint keys no rule reads
    * ``unfilled`` - port parameters no checkpoint key filled (keep init)
    """

    mapped: List[str] = dataclasses.field(default_factory=list)
    failed: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    unused: List[str] = dataclasses.field(default_factory=list)
    unfilled: List[str] = dataclasses.field(default_factory=list)

    def log_summary(self, what: str) -> None:
        log.info(f"{what} import: mapped {len(self.mapped)} tensors")
        for key, reason in self.failed:
            log.warning(f"{what} import FAILED for {key!r}: {reason}")
        if self.unused:
            log.warning(f"{what} import: {len(self.unused)} checkpoint tensors unused "
                        f"(first few: {self.unused[:5]})")
        if self.unfilled:
            log.warning(f"{what} import: {len(self.unfilled)} parameters keep their init "
                        f"(first few: {self.unfilled[:5]})")

    def raise_if_failed(self, what: str) -> None:
        if self.failed:
            lines = "\n".join(f"  {k}: {r}" for k, r in self.failed)
            raise ValueError(f"{what} weight import failed for:\n{lines}")


# -- reading checkpoints -------------------------------------------------------

_SAFETENSORS_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4", "I16": "<i2",
    "I8": "i1", "U8": "u1", "BOOL": "?",
}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file as numpy arrays: an 8-byte little-endian
    header length, a JSON header of dtype, shape and byte offsets per
    tensor, then the raw bytes. BF16 is read through a uint16 view and
    widened to f32 (exact). An unknown dtype raises."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    body = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        kind, shape = info["dtype"], tuple(info["shape"])
        start, end = info["data_offsets"]
        raw = body[start:end]
        if kind == "BF16":
            bits = raw.view("<u2").astype(np.uint32) << 16
            out[name] = bits.view(np.float32).reshape(shape)
        elif kind in _SAFETENSORS_DTYPES:
            out[name] = np.array(raw.view(_SAFETENSORS_DTYPES[kind]).reshape(shape))
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {kind!r}")
    return out


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint file, or a directory holding ``model.safetensors`` or
    ``pytorch_model.bin``, as numpy arrays (``.bin`` through
    ``torch.load(weights_only=True)``)."""
    candidates = [path] if os.path.isfile(path) else [
        os.path.join(path, n) for n in ("model.safetensors", "pytorch_model.bin")
        if os.path.isfile(os.path.join(path, n))]
    if not candidates:
        raise FileNotFoundError(f"no weights found under {path}")
    f = candidates[0]
    if f.endswith(".safetensors"):
        return read_safetensors(f)
    sd = torch.load(f, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in sd.items()}


# -- writing into the masters ----------------------------------------------------

class _Writer:
    """Shape-checked f32 writes into a copy of ``params``, every outcome in
    the report; ``filled`` records the destinations."""

    def __init__(self, params: Params, report: ImportReport):
        self.out = dict(params)
        self.report = report
        self.filled: set = set()

    def put(self, name: str, key: str, value) -> bool:
        target = self.out.get(name)
        value = np.asarray(value)
        if target is None:
            self.report.failed.append((key, f"no destination parameter {name!r}"))
            return False
        if tuple(target.shape) != tuple(value.shape):
            self.report.failed.append((key, f"shape mismatch at {name!r}: ours "
                                            f"{tuple(target.shape)} vs checkpoint "
                                            f"{tuple(value.shape)}"))
            return False
        self.out[name] = torch.from_numpy(np.array(value, np.float32)).to(target.device)
        self.report.mapped.append(key)
        self.filled.add(name)
        return True

    def unfilled(self, prefix: str = "") -> List[str]:
        return sorted(n for n in self.out if n.startswith(prefix) and n not in self.filled)


def _n_blocks(params: Params, stack: str, word: str = "block") -> int:
    pat = re.compile(rf"^{re.escape(stack + '.') if stack else ''}{word}_(\d+)\.")
    idx = {int(m.group(1)) for n in params for m in [pat.match(n)] if m}
    return max(idx) + 1 if idx else 0


def _t5_block_map(prefix: str, i: int, decoder: bool) -> Dict[str, str]:
    """HF T5 block keys -> the port's names within a stack."""
    hf = f"{prefix}.block.{i}.layer"
    b = f"block_{i}"
    if not decoder:
        return {
            f"{hf}.0.SelfAttention.q.weight": f"{b}.attn.q.weight",
            f"{hf}.0.SelfAttention.k.weight": f"{b}.attn.k.weight",
            f"{hf}.0.SelfAttention.v.weight": f"{b}.attn.v.weight",
            f"{hf}.0.SelfAttention.o.weight": f"{b}.attn.o.weight",
            f"{hf}.0.layer_norm.weight": f"{b}.ln0.weight",
            f"{hf}.1.DenseReluDense.wi_0.weight": f"{b}.ffn.wi_0.weight",
            f"{hf}.1.DenseReluDense.wi_1.weight": f"{b}.ffn.wi_1.weight",
            f"{hf}.1.DenseReluDense.wi.weight": f"{b}.ffn.wi.weight",
            f"{hf}.1.DenseReluDense.wo.weight": f"{b}.ffn.wo.weight",
            f"{hf}.1.layer_norm.weight": f"{b}.ln1.weight",
        }
    return {
        f"{hf}.0.SelfAttention.q.weight": f"{b}.self_attn.q.weight",
        f"{hf}.0.SelfAttention.k.weight": f"{b}.self_attn.k.weight",
        f"{hf}.0.SelfAttention.v.weight": f"{b}.self_attn.v.weight",
        f"{hf}.0.SelfAttention.o.weight": f"{b}.self_attn.o.weight",
        f"{hf}.0.layer_norm.weight": f"{b}.ln0.weight",
        f"{hf}.1.EncDecAttention.q.weight": f"{b}.cross_attn.q.weight",
        f"{hf}.1.EncDecAttention.k.weight": f"{b}.cross_attn.k.weight",
        f"{hf}.1.EncDecAttention.v.weight": f"{b}.cross_attn.v.weight",
        f"{hf}.1.EncDecAttention.o.weight": f"{b}.cross_attn.o.weight",
        f"{hf}.1.layer_norm.weight": f"{b}.ln1.weight",
        f"{hf}.2.DenseReluDense.wi_0.weight": f"{b}.ffn.wi_0.weight",
        f"{hf}.2.DenseReluDense.wi_1.weight": f"{b}.ffn.wi_1.weight",
        f"{hf}.2.DenseReluDense.wi.weight": f"{b}.ffn.wi.weight",
        f"{hf}.2.DenseReluDense.wo.weight": f"{b}.ffn.wo.weight",
        f"{hf}.2.layer_norm.weight": f"{b}.ln2.weight",
    }


# HF T5 ties lm_head to shared and re-exports the embedding under these names
_T5_ALIASES = ("encoder.embed_tokens.weight", "decoder.embed_tokens.weight", "lm_head.weight")


def t5_key_map(params: Params, prefix: str = "t5.") -> Dict[str, str]:
    """HF T5 key -> port parameter name for the T5 under ``prefix``. The
    relative bias sits in block 0 of each stack only; ``lm_head.weight``
    maps only where the model carries an untied head; an encoder-only T5
    (the custom-decoder families) has no decoder keys."""
    mapping = {
        "shared.weight": f"{prefix}shared.weight",
        "encoder.final_layer_norm.weight": f"{prefix}encoder.final_ln.weight",
        "decoder.final_layer_norm.weight": f"{prefix}decoder.final_ln.weight",
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
            f"{prefix}encoder.rel_bias.rel_embedding.weight",
        "decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
            f"{prefix}decoder.rel_bias.rel_embedding.weight",
    }
    if f"{prefix}lm_head.weight" in params:
        mapping["lm_head.weight"] = f"{prefix}lm_head.weight"
    for stack, decoder in (("encoder", False), ("decoder", True)):
        for i in range(_n_blocks(params, f"{prefix}{stack}")):
            for hf_key, ours in _t5_block_map(stack, i, decoder).items():
                mapping[hf_key] = f"{prefix}{stack}.{ours}"
    return mapping


def _import_t5(w: _Writer, sd: Dict[str, np.ndarray], prefix: str) -> None:
    mapping = t5_key_map(w.out, prefix)
    for hf_key, name in mapping.items():
        if hf_key in sd:
            w.put(name, hf_key, sd[hf_key])
    w.report.unused += [k for k in sd if k not in mapping and k not in _T5_ALIASES]


def import_t5_params(params: Params, sd: Dict[str, np.ndarray], strict: bool = False,
                     report: Optional[ImportReport] = None, prefix: str = "t5.") -> Params:
    """A HF T5 state dict into the T5 under ``prefix``: tied or untied
    ``lm_head``, the gated (``wi_0``/``wi_1``) or plain (``wi``) FFN. A key
    that cannot be placed (a missing destination, a shape mismatch such as
    SaL's +1 context-token vocabulary row) is reported as failed;
    ``strict=True`` raises."""
    rep = report if report is not None else ImportReport()
    w = _Writer(params, rep)
    _import_t5(w, sd, prefix)
    if report is None:
        rep.unfilled += w.unfilled(prefix)
        rep.log_summary("T5")
    if strict:
        rep.raise_if_failed("T5")
    return w.out


def vit_key_map(params: Params, prefix: str = "vit.") -> Dict[str, str]:
    """HF ``ViTModel(add_pooling_layer=False)`` key -> port parameter name."""
    mapping = {
        "embeddings.cls_token": f"{prefix}cls_token",
        "embeddings.position_embeddings": f"{prefix}position_embeddings",
        "embeddings.patch_embeddings.projection.weight": f"{prefix}patch_embed.weight",
        "embeddings.patch_embeddings.projection.bias": f"{prefix}patch_embed.bias",
        "layernorm.weight": f"{prefix}final_ln.weight",
        "layernorm.bias": f"{prefix}final_ln.bias",
    }
    for i in range(_n_blocks(params, prefix.rstrip("."))):
        hf, b = f"encoder.layer.{i}", f"{prefix}block_{i}"
        for hf_mod, ours in ((f"{hf}.attention.attention.query", f"{b}.attention.query"),
                             (f"{hf}.attention.attention.key", f"{b}.attention.key"),
                             (f"{hf}.attention.attention.value", f"{b}.attention.value"),
                             (f"{hf}.attention.output.dense", f"{b}.attention.out"),
                             (f"{hf}.intermediate.dense", f"{b}.fc1"),
                             (f"{hf}.output.dense", f"{b}.fc2"),
                             (f"{hf}.layernorm_before", f"{b}.ln_before"),
                             (f"{hf}.layernorm_after", f"{b}.ln_after")):
            for leaf in ("weight", "bias"):
                mapping[f"{hf_mod}.{leaf}"] = f"{ours}.{leaf}"
    return mapping


def _import_vit(w: _Writer, sd: Dict[str, np.ndarray], prefix: str) -> None:
    mapping = vit_key_map(w.out, prefix)
    for hf_key, name in mapping.items():
        if hf_key in sd:
            w.put(name, hf_key, sd[hf_key])
        else:
            w.report.failed.append((hf_key, f"missing from the checkpoint (for {name!r})"))
    w.report.unused += [k for k in sd if k not in mapping]


def import_vit_params(params: Params, sd: Dict[str, np.ndarray], strict: bool = False,
                      report: Optional[ImportReport] = None, prefix: str = "vit.") -> Params:
    """A HF ViTModel state dict into the ViT under ``prefix``."""
    rep = report if report is not None else ImportReport()
    w = _Writer(params, rep)
    _import_vit(w, sd, prefix)
    if report is None:
        rep.unfilled += w.unfilled(prefix)
        rep.log_summary("ViT")
    if strict:
        rep.raise_if_failed("ViT")
    return w.out


def import_latr_weights(params: Params, weights_root: str, strict: bool = False,
                        report: Optional[ImportReport] = None) -> Params:
    """``weights_root`` may hold ``t5/`` and ``vit/`` checkpoint
    directories; each present one is imported, parameters that no key fills
    (the projector, the spatial tables, an absent ``vit/``) keep their
    init and are listed as ``unfilled``."""
    rep = report if report is not None else ImportReport()
    w = _Writer(params, rep)
    t5_dir = os.path.join(weights_root, "t5")
    if os.path.isdir(t5_dir):
        _import_t5(w, _load_state_dict(t5_dir), "t5.")
    vit_dir = os.path.join(weights_root, "vit")
    if os.path.isdir(vit_dir) and any(n.startswith("vit.") for n in params):
        _import_vit(w, _load_state_dict(vit_dir), "vit.")
    rep.unfilled += w.unfilled()
    rep.log_summary("LaTr weights")
    if strict:
        rep.raise_if_failed("LaTr weights")
    return w.out


# -- reference checkpoints -----------------------------------------------------

def import_torch_decoder_layers(w: _Writer, sd: Dict[str, np.ndarray], prefix: str) -> None:
    """torch ``nn.TransformerDecoder`` layers (``prefix`` addresses the
    layer list, e.g. ``decoder.decoder.layers``) into the port's custom
    decoder layers: the packed ``in_proj`` split three ways, post-LN norms."""
    i = 0
    while f"{prefix}.{i}.self_attn.in_proj_weight" in sd:
        src, dst = f"{prefix}.{i}", f"decoder.layer_{i}"
        if not any(n.startswith(dst + ".") for n in w.out):
            w.report.failed.append((src, f"our decoder has no layer_{i}"))
            i += 1
            continue
        d_model = sd[f"{src}.self_attn.in_proj_weight"].shape[1]
        for torch_name, ours in (("self_attn", "self_attn"), ("multihead_attn", "cross_attn")):
            weight = sd[f"{src}.{torch_name}.in_proj_weight"]
            bias = sd[f"{src}.{torch_name}.in_proj_bias"]
            for j, proj in enumerate(("q", "k", "v")):
                rows = slice(j * d_model, (j + 1) * d_model)
                w.put(f"{dst}.{ours}.{proj}.weight", f"{src}.{torch_name}.{proj}", weight[rows])
                w.put(f"{dst}.{ours}.{proj}.bias", f"{src}.{torch_name}.{proj}.b", bias[rows])
            for leaf in ("weight", "bias"):
                key = f"{src}.{torch_name}.out_proj.{leaf}"
                w.put(f"{dst}.{ours}.out.{leaf}", key, sd[key])
        for torch_name, ours in (("linear1", "fc1"), ("linear2", "fc2"), ("norm1", "ln1"),
                                 ("norm2", "ln2"), ("norm3", "ln3")):
            for leaf in ("weight", "bias"):
                key = f"{src}.{torch_name}.{leaf}"
                w.put(f"{dst}.{ours}.{leaf}", key, sd[key])
        i += 1


_SPATIAL_TABLE_ORDER = ("top_left_x", "top_left_y", "bottom_right_x", "bottom_right_y",
                        "width_emb", "height_emb")
_SAL_REL1D = "rel2Dbias.Relative1D.relative_attention_bias.weight"


def import_reference_state_dict(params: Params, sd: Dict[str, np.ndarray],
                                report: Optional[ImportReport] = None) -> Params:
    """A reference model's ``state_dict()`` (any of the nine families) into
    the port's parameters, routed by prefix:

    * ``backbone.`` (stock HF T5) or ``encoder.`` (the encoder-only T5 of
      the custom-decoder families) -> :func:`import_t5_params`; a SaL
      checkpoint's encoder layer-0 relative bias is dropped (the 2-D bias
      replaces it, so the port has none);
    * ``vit.`` -> :func:`import_vit_params`;
    * ``visual_projector`` and ``spatial_feat_extractor`` (LaTr families);
    * ``rel2Dbias`` and the per-stream projectors and norms (SaL families);
    * ``tgt_tok_emb`` / ``lm_head`` / ``decoder.decoder.layers`` (the custom
      decoders); a plain ``nn.Embedding`` ``tgt_tok_emb`` (PhonemeSaL) is
      imported as weight/sqrt(d), since the port's embedding scales by
      sqrt(d).

    Returns a new dict; every key's fate lands in ``report``."""
    rep = report if report is not None else ImportReport()
    w = _Writer(params, rep)
    sd = {k: np.asarray(v) for k, v in sd.items()}

    def group(prefix):
        p = prefix + "."
        return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}

    t5_sd = group("backbone") or group("encoder")
    if t5_sd:
        if _SAL_REL1D in sd:
            t5_sd.pop("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
                      None)
        _import_t5(w, t5_sd, "t5.")
    vit_sd = group("vit")
    if vit_sd and any(n.startswith("vit.") for n in params):
        _import_vit(w, vit_sd, "vit.")
    elif vit_sd:
        rep.failed.append(("vit.*", f"checkpoint has {len(vit_sd)} ViT tensors but our model "
                                    "has no vit subtree (wrong --config-file family?)"))

    for name in ("visual_projector.weight", "visual_projector.bias"):
        if name in sd:
            w.put(name, name, sd[name])
    if "spatial_feat_extractor.top_left_x.weight" in sd:
        tables = np.stack([sd[f"spatial_feat_extractor.{n}.weight"]
                           for n in _SPATIAL_TABLE_ORDER])
        w.put("spatial.tables", "spatial_feat_extractor.*", tables)
    if _SAL_REL1D in sd:
        w.put("rel2d.rel1d.weight", _SAL_REL1D, sd[_SAL_REL1D])
        key = "rel2Dbias.SCP.relative_attention_bias.weight"
        w.put("rel2d.scp.weight", key, sd[key])
    for stream in ("ocr", "obj"):
        if f"{stream}_feature_projector.weight" not in sd:
            continue
        for mod in ("feature_projector", "bbox_projector"):
            for leaf in ("weight", "bias"):
                key = f"{stream}_{mod}.{leaf}"
                w.put(key, key, sd[key])
        key = f"{stream}_feature_layer_norm.weight"
        w.put(f"{stream}_norm.weight", key, sd[key])

    has_decoder = any(n.startswith("decoder.") for n in params)
    dec_keys = [k for k in sd if k.startswith(("tgt_tok_emb.", "lm_head.", "decoder."))]
    if not has_decoder and dec_keys:
        rep.failed.append(("decoder.*", f"checkpoint has {len(dec_keys)} custom-decoder "
                                        "tensors but our model has no decoder subtree "
                                        "(wrong --config-file family?)"))
    if has_decoder:
        if "tgt_tok_emb.embedding.weight" in sd:  # the sqrt(d)-scaled TokenEmbedding
            key = "tgt_tok_emb.embedding.weight"
            w.put("decoder.embed.weight", key, sd[key])
        elif "tgt_tok_emb.weight" in sd:  # a plain nn.Embedding (PhonemeSaL)
            table = sd["tgt_tok_emb.weight"]
            w.put("decoder.embed.weight", "tgt_tok_emb.weight", table / np.sqrt(table.shape[1]))
        for leaf in ("weight", "bias"):
            if f"lm_head.{leaf}" in sd:
                w.put(f"decoder.lm_head.{leaf}", f"lm_head.{leaf}", sd[f"lm_head.{leaf}"])
        import_torch_decoder_layers(w, sd, "decoder.decoder.layers")

    if report is None:
        rep.unfilled += w.unfilled()
        rep.log_summary("reference checkpoint")
    return w.out
