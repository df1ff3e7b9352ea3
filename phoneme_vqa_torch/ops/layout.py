"""What the port's attention kernels take of a tensor's layout.

The kernels read q, k, v, the bias tables and write the output in place, by
strides: the bf16 path through TMA tensor maps, which need a unit stride
along the last dimension, every other stride a multiple of 16 bytes and a
16-byte aligned start. So a (B, H, L, D) view of the models' (B, L, H, D)
storage (``T5Attention._split``, the ViT ``split``) goes in without a copy,
and the output is written as (B, L, H, D) storage, which the models' merge
reshapes without a copy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

ALIGN = 16  # bytes: TMA's alignment of a start address and of every stride


def _inspect(t: torch.Tensor) -> Tuple[Optional[str], Tuple[int, ...]]:
    """(why the kernels cannot take ``t`` in place or None, its outer
    strides), in one pass: the wrappers run it on every launch."""
    ptr = t.data_ptr()
    if ptr % ALIGN:
        return f"starts {ptr % ALIGN} bytes past a {ALIGN}-byte boundary", ()
    shape, stride, size = t.shape, t.stride(), t.element_size()
    last = len(shape) - 1
    if last >= 0 and shape[last] != 1 and stride[last] != 1:
        return f"has stride {stride[last]} along its last dimension, not 1", ()
    outer = []
    for i in range(last):
        n, s = shape[i], stride[i]
        if n == 1:
            outer.append(0)
        elif s <= 0 or (s * size) % ALIGN:
            return (f"has stride {s} along dimension {i}, not a positive multiple of "
                    f"{ALIGN} bytes"), ()
        else:
            outer.append(s)
    return None, tuple(outer)


def kernel_operand(t: torch.Tensor, refuse: Optional[str] = None
                   ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """``(t, its outer strides)`` after one look at ``t``'s layout: the
    element strides of every dimension but the last, as the kernels take
    them (0 for a dimension of extent 1, which is never stepped; any other
    needs a stride above 0). A layout the kernels do not take raises
    ValueError(f"{refuse} <why>") when ``refuse`` is given; else ``t`` is
    copied into rows 16 bytes apart (the storage's last dimension padded)
    and that copy, a view of ``t``'s shape, is returned with its strides."""
    err, outer = _inspect(t)
    if err is None:
        return t, outer
    if refuse is not None:
        raise ValueError(f"{refuse} {err}")
    n = t.shape[-1]
    per = max(1, ALIGN // t.element_size())
    buf = torch.empty(*t.shape[:-1], -(-n // per) * per, dtype=t.dtype, device=t.device)
    copy = buf[..., :n]
    copy.copy_(t)
    return copy, _inspect(copy)[1]


def empty_output(q: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """A (B, H, L, D) output like ``q``, laid out as (B, L, H, D) storage,
    and its outer strides as ``kernel_operand`` gives them."""
    b, h, l, d = q.shape
    strides = (l * h * d, d, h * d)
    out = torch.empty_strided((b, h, l, d), (*strides, 1), dtype=q.dtype, device=q.device)
    return out, tuple(0 if n == 1 else s for n, s in zip((b, h, l), strides))
