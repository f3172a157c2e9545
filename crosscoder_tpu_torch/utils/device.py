"""Device resolution for the port's public entry points.

Every entry point runs on ``cuda`` unless the caller names another device.
With no device named and no CUDA present it raises: the port never drops
to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass "
                "device='cpu' to run the plain PyTorch paths on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
