"""Global image reductions (port of ``vpp_tpu.ops.reductions``).

The JAX package runs without 64-bit types, so an integer sum is int32 and
wraps on overflow; ``sum_`` copies that (PyTorch would promote to int64).
``argmin``/``argmax`` return the int32 (row, col) of the first extremum,
summing the channels first for a multi-channel image. ``avg`` is a
float32 mean, whose summation order differs from XLA's.
"""

from __future__ import annotations

import torch

from ..core.image import Image2d, _as_tensor


def _arr(img) -> torch.Tensor:
    return img.interior if isinstance(img, Image2d) else _as_tensor(img)


def int32_sum(a: torch.Tensor) -> torch.Tensor:
    """The sum of an integer or bool tensor as JAX's int32 sum gives it:
    the exact sum modulo 2^32, in [-2^31, 2^31)."""
    total = a.sum(dtype=torch.int64)
    return (torch.remainder(total + 2 ** 31, 2 ** 32) - 2 ** 31).to(
        torch.int32)


def sum_(img, dtype=None) -> torch.Tensor:
    """Sum of the interior. Integers (bool too) accumulate as int32, as the
    JAX package without 64-bit types does; ``dtype`` (a torch dtype) picks
    another accumulator (int64 does not wrap)."""
    a = _arr(img)
    if dtype is None and not a.dtype.is_floating_point:
        dtype = torch.int32
    if dtype == torch.int32:
        return int32_sum(a)
    return a.sum(dtype=dtype)


def min_(img) -> torch.Tensor:
    return torch.amin(_arr(img))


def max_(img) -> torch.Tensor:
    return torch.amax(_arr(img))


def avg(img) -> torch.Tensor:
    return torch.mean(_arr(img).to(torch.float32))


def _channel_sum(a: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H, W): the channels summed in order, in the type
    XLA's sum gives (int32 for narrower integers)."""
    if not a.dtype.is_floating_point and a.dtype != torch.int64:
        a = a.to(torch.int32)
    out = a[..., 0]
    for c in range(1, a.shape[-1]):
        out = out + a[..., c]
    return out


def _arg(img, reducer):
    a = _arr(img)
    flat = (_channel_sum(a) if a.dim() == 3 else a).reshape(-1)
    idx = reducer(flat)
    w = a.shape[1]
    return torch.stack([idx // w, idx % w]).to(torch.int32)


def argmin(img) -> torch.Tensor:
    """(row, col) of the first minimum."""
    return _arg(img, torch.argmin)


def argmax(img) -> torch.Tensor:
    """(row, col) of the first maximum."""
    return _arg(img, torch.argmax)
