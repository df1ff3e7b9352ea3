"""LoRA fine-tuning (counterpart of ``phoneme_vqa_tpu/train/lora.py``).

Adapters are keyed by the name of the Linear weight they adapt
(``t5.encoder.block_0.attn.q.weight``), each ``{"a": (in, r), "b": (r,
out)}`` in f32, the JAX package's (flax) orientation, so a JAX adapter tree
carries over by name (``models.bridge.flax_lora_to_adapters``). The port's Linear weight is (out,
in), so the merged weight is ``W + scale * (A @ B)^T`` with ``scale =
alpha / rank``. Training (``train/base_executor.py``) rebuilds it in each
step with the base frozen and the optimizer holding state for the adapters
alone; checkpoints hold ``{"base", "lora"}`` and ``lora_scale``, so eval,
predict and serve merge with the saved scale and need no ``LORA_*`` keys.

YAML knobs::

    LORA_RANK: 8          # > 0 turns LoRA on
    LORA_ALPHA: 16        # scale numerator; default 2 * rank
    LORA_TARGETS: attn    # attn (default) | all | a list of module names

``attn`` adapts every attention projection (T5 q/k/v/o, custom-decoder
q/k/v/out, ViT query/key/value/out); ``all`` adds the FFN products (wi*/wo,
fc1/fc2).

Over a mesh's model axis (``parallel/``) an adapter is split with its
weight (:func:`shard_adapter`): a column-split weight's adapter splits ``b``
over the output features, a row-split one's ``a`` over the input features,
and the other factor is whole on every model rank, its gradient summed over
the axis (``BaseExecutor._collect_grads``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

ATTN_MODULES = ("q", "k", "v", "o", "out", "query", "key", "value")
FFN_MODULES = ("wi", "wi_0", "wi_1", "wo", "fc1", "fc2", "lin1", "lin2")

Adapters = Dict[str, Dict[str, torch.Tensor]]  # weight name -> {"a", "b"}


@dataclass(frozen=True)
class LoraSpec:
    rank: int
    alpha: float
    targets: tuple

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def from_config(config) -> Optional[LoraSpec]:
    rank = int(config.get("LORA_RANK", 0) or 0)
    if rank <= 0:
        return None
    alpha = float(config.get("LORA_ALPHA", 2 * rank))
    raw = config.get("LORA_TARGETS", "attn")
    if isinstance(raw, str):
        if raw == "attn":
            targets = ATTN_MODULES
        elif raw == "all":
            targets = ATTN_MODULES + FFN_MODULES
        else:
            targets = tuple(t.strip() for t in raw.split(",") if t.strip())
    else:
        targets = tuple(raw)
    return LoraSpec(rank=rank, alpha=alpha, targets=targets)


def is_composite(params) -> bool:
    """True for the ``{"base", "lora"}`` tree of a LoRA checkpoint."""
    return isinstance(params, dict) and set(params) == {"base", "lora"}


def target_names(model: nn.Module, targets) -> list:
    """The weight names of every Linear whose module name is in
    ``targets`` (the JAX package's 2-D ``kernel`` leaves)."""
    return [f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, nn.Linear) and name.rsplit(".", 1)[-1] in targets]


def init_lora(model: nn.Module, spec: LoraSpec, generator: torch.Generator,
              device=None, shapes: Optional[Dict[str, tuple]] = None) -> Adapters:
    """An adapter for each targeted weight: ``a`` Gaussian over sqrt(in),
    ``b`` zeros, so the merged model starts exactly at the base. Draws in
    ``named_modules`` order from ``generator`` (the JAX package splits a
    ``jax.random`` key: the same distribution, not the same draws), at the
    weights' ``shapes`` where given (a split model's full shapes).
    Raises when the targets match no weight."""
    out: Adapters = {}
    for name in target_names(model, spec.targets):
        d_out, d_in = (shapes or {}).get(name) or model.get_parameter(name).shape
        a = torch.randn(d_in, spec.rank, generator=generator, device=generator.device)
        out[name] = {"a": (a / d_in**0.5).to(device or generator.device),
                     "b": torch.zeros(spec.rank, d_out, device=device or generator.device)}
    if not out:
        raise ValueError(f"LORA_TARGETS={spec.targets} matched no kernel in the model: "
                         "check the module names (e.g. 'attn' covers q/k/v/o)")
    return out


def shard_adapter(adapter: Dict[str, torch.Tensor], dim: int, rank: int, parts: int
                  ) -> Dict[str, torch.Tensor]:
    """The part ``rank`` of ``parts`` of the adapter of a weight split along
    ``dim`` (the port's layout: 0 splits the output features, 1 the input
    features): ``b`` (r, out) sliced by output feature, or ``a`` (in, r) by
    input feature, so :func:`merged_weight` of the parts is the part of the
    merged weight."""
    key, axis = ("b", 1) if dim == 0 else ("a", 0)
    size = adapter[key].shape[axis] // parts
    return dict(adapter, **{key: adapter[key].narrow(axis, rank * size, size)})


def merged_weight(base: torch.Tensor, adapter: Dict[str, torch.Tensor],
                  scale: float) -> torch.Tensor:
    """``base + scale * (A @ B)^T`` in f32, with the rounding of the JAX
    package's ``merge_lora`` (f32 base, f32 product, the scaled product
    added)."""
    return base.float() + scale * torch.matmul(adapter["a"].float(), adapter["b"].float()).t()


def merge_lora(base: Dict[str, torch.Tensor], lora: Adapters, scale: float
               ) -> Dict[str, torch.Tensor]:
    """Flat parameters: each adapted weight merged, every other one passed
    through by reference."""
    return {n: merged_weight(p, lora[n], scale).to(p.dtype) if n in lora else p
            for n, p in base.items()}


def unmatched_adapter_paths(base: Dict[str, torch.Tensor], lora: Adapters) -> list:
    """Adapter names with no base weight of matching (out, in): an adapter
    of another family must be refused, not served half applied."""
    bad = []
    for name, ad in lora.items():
        w = base.get(name)
        a_shape, b_shape = tuple(ad["a"].shape), tuple(ad["b"].shape)
        if (w is None or w.dim() != 2 or a_shape[0] != w.shape[1]
                or b_shape[1] != w.shape[0] or a_shape[1] != b_shape[0]):
            bad.append(name)
    return bad


def n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(n_params(v) for v in tree.values())
    return int(tree.numel())

