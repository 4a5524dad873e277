"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Dict, Tuple

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


_CONSTANTS: Dict[Tuple, torch.Tensor] = {}


def device_constant(values, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """A small constant tensor on ``device``, made once per process and
    then reused. On a card it is copied from pinned memory without
    blocking the host, so no per-call copy stalls a step."""
    key = (tuple(values), dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        host = torch.tensor(list(values), dtype=dtype)
        if key[2].type == "cuda":
            host = host.pin_memory()
        t = host.to(key[2], non_blocking=True)
        _CONSTANTS[key] = t
    return t
