"""Device choice for the port's entry points: the card unless the caller
asks for the CPU, and an error, never a quiet CPU run, when there is no card."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available; pass device='cpu' to run on the CPU"
        )
    return device
