"""Weight bridge: a flax param tree (nested dicts of numpy arrays) -> the
port's ``state_dict``.

Submodules of the port carry the flax scope names, so the map is 1:1 apart
from layout:

* Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in)
* ViT ``patch_embed`` Conv ``kernel`` (kh, kw, in, out) -> Conv2d ``weight``
  (out, in, kh, kw); flax convolves NHWC and the port NCHW over the same
  row-by-row patch order
* LayerNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``
  (so SaL's ``rel2d/rel1d/embedding`` -> ``rel2d.rel1d.weight``, and the
  phoneme triple decoder's ``decoder/onset_embed/embedding`` ->
  ``decoder.onset_embed.weight``; its ``shared_lm_head`` and three heads
  are Dense layers like any other)
* Dense ``bias``, RMSNorm ``weight``, ``rel_embedding`` (32, H),
  ``spatial/tables`` (6, 1024, d), ``cls_token`` and ``position_embeddings``
  as they are

Both block layouts are accepted: per-block ``block_{i}`` and the
``SCAN_LAYERS``-stacked ``blocks`` (every leaf with a leading layer axis).
A flax leaf with no counterpart, or a port parameter left unfilled, raises.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn


def unstack_block_params(tree):
    """Scanned layout -> unrolled layout (``blocks/...`` -> ``block_i/...``);
    a numpy copy of ``phoneme_vqa_tpu.models.scan_utils.unstack_block_params``."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "blocks" and isinstance(v, dict):
            leaves = list(_flatten(v).values())
            n = np.shape(leaves[0])[0] if leaves else 0
            for i in range(n):
                out[f"block_{i}"] = _map_tree(lambda leaf: leaf[i], v)
        else:
            out[k] = unstack_block_params(v)
    return out


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _flatten(tree, prefix=()) -> Dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _torch_leaf(path: tuple, value: np.ndarray):
    """(flax path, array) -> (port parameter name, array in the port's layout)."""
    *scope, leaf = path
    if leaf == "kernel":
        leaf = "weight"
        value = value.T if value.ndim == 2 else value.transpose(3, 2, 0, 1)
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return ".".join([*scope, leaf]), value


def flax_to_state_dict(params, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Map a flax param tree (any model of the port) onto ``model``'s
    parameter names.

    Raises ``KeyError`` on a flax leaf with no counterpart, a shape that
    disagrees, or a port parameter that no flax leaf fills."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    want = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    unmapped = []
    for path, value in _flatten(unstack_block_params(params)).items():
        name, array = _torch_leaf(path, np.asarray(value, np.float32))
        if name not in want or tuple(want[name].shape) != array.shape:
            unmapped.append("/".join(path))
            continue
        out[name] = torch.tensor(array)
    left_over = sorted(set(want) - set(out))
    if unmapped or left_over:
        raise KeyError(
            f"flax -> torch bridge: unmapped flax leaves {unmapped}; "
            f"port parameters left over {left_over}"
        )
    return out


def load_flax_params(model: nn.Module, params) -> nn.Module:
    """Copy a flax param tree into ``model`` (cast to each parameter's dtype)."""
    model.load_state_dict(flax_to_state_dict(params, model), strict=True)
    return model


def flax_lora_to_adapters(lora_tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX LoRA adapter tree (``.../m/kernel: {"a", "b"}``, either block
    layout) as the port's adapters (``train/lora.py``): keyed by the adapted
    Linear weight's name, ``a`` (in, r) and ``b`` (r, out) in f32, the same
    orientation on both sides."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict) and set(node) == {"a", "b"}:
            if path[-1] != "kernel":
                raise KeyError(f"adapter at {'/'.join(path)} does not adapt a kernel")
            out[".".join(path[:-1] + ("weight",))] = {
                k: torch.tensor(np.asarray(node[k], np.float32)) for k in ("a", "b")}
            return
        for k, v in node.items():
            walk(v, path + (k,))

    walk(unstack_block_params(lora_tree), ())
    return out
