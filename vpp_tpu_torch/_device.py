"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The card unless the caller asks for the CPU; never a silent fallback.

    Raises ``RuntimeError`` when a CUDA device is asked for (the entry
    points' default) and this PyTorch build or machine has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vpp_tpu_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch path")
    return dev
