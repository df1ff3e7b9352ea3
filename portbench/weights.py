"""Seeded weights, made on the card in one draw.

Both sides get the same float32 values: the program through its executor's
``load_params``, the reference as they are. A parameter's values are a
slice of one normal draw from a ``torch.Generator`` on the card, scaled by
its standard deviation, or set to one (norm scales) or zero (biases), as
the configuration's reference ``param_spec`` says."""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import torch


def make(spec: "OrderedDict[str, tuple]", seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor (views of one buffer) on ``device``."""
    total = sum(_numel(shape) for shape, _ in spec.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    scaled = {}
    for name, (shape, init) in spec.items():
        n = _numel(shape)
        view = flat[at:at + n].view(shape)
        at += n
        if init == "one":
            view.fill_(1.0)
        elif init == "zero":
            view.zero_()
        else:
            scaled.setdefault(float(init), []).append(view)
        out[name] = view
    for std, views in scaled.items():
        torch._foreach_mul_(views, std)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
