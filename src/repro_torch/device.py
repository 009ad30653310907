"""Device selection for the port's entry points.

Entry points default to the card.  The CPU is used only when the caller
names it (as the tests do); with no card and no explicit CPU request they
raise instead of quietly running on the host.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
