"""Colorspace conversions (port of ``vpp_tpu.ops.color``).

Whole-image tensor ops; the border region is converted too.
"""

from __future__ import annotations

import torch

from ..core.image import Image2d, saturate_cast


def rgb_to_graylevel(img: Image2d, dtype=None) -> Image2d:
    """gray = (r + g + b) / 3 of a 3- or 4-channel image (alpha ignored).
    Integer pixels sum in int32 and floor-divide; ``dtype`` (a torch
    dtype) defaults to the image's."""
    a = img.data
    if a.dim() != 3 or a.shape[2] not in (3, 4):
        raise ValueError(f"rgb_to_graylevel: expected (H, W, 3|4), got "
                         f"{tuple(a.shape)}")
    if a.dtype.is_floating_point:
        g = (a[..., 0] + a[..., 1] + a[..., 2]) / 3
    else:
        rgb = a[..., :3].to(torch.int32)
        g = torch.div(rgb[..., 0] + rgb[..., 1] + rgb[..., 2], 3,
                      rounding_mode="floor")
    return Image2d(data=g.to(dtype if dtype is not None else a.dtype),
                   border=img.border)


def graylevel_to_rgb(img: Image2d) -> Image2d:
    """Replicate gray into 3 channels."""
    a = img.data
    if a.dim() != 2:
        raise ValueError(f"graylevel_to_rgb: expected (H, W), got "
                         f"{tuple(a.shape)}")
    return Image2d(data=torch.stack([a, a, a], dim=-1), border=img.border)


def hsv_to_rgb(h, s, v) -> torch.Tensor:
    """HSV → RGB by the reference's sector formula: h in degrees [0, 360),
    s and v in [0, 1]; uint8 RGB of ``h``'s shape plus (3,). Channel values
    truncate (``(c * 255)`` cast to uint8) and NaN converts to 0, as in the
    JAX package."""
    dev = h.device if isinstance(h, torch.Tensor) else None
    h = torch.as_tensor(h, dtype=torch.float32, device=dev)
    s = torch.as_tensor(s, dtype=torch.float32, device=h.device)
    v = torch.as_tensor(v, dtype=torch.float32, device=h.device)
    c = s * v
    h2 = h / 60.0
    x = c * (1 - (torch.remainder(h2, 2) - 1).abs())
    C = saturate_cast(c * 255, torch.uint8)
    X = saturate_cast(x * 255, torch.uint8)
    Z = torch.zeros_like(C)
    sector = saturate_cast(h2, torch.int32).clamp(0, 6)
    # sectors 0..5 -> (C,X,0),(X,C,0),(0,C,X),(0,X,C),(X,0,C),(C,0,X); 6 -> 0

    def pick(*choices):
        out = Z
        for i in range(5, -1, -1):
            out = torch.where(sector == i, choices[i], out)
        return out

    return torch.stack([pick(C, X, Z, Z, X, C), pick(X, C, C, X, Z, Z),
                        pick(Z, Z, X, C, C, X)], dim=-1)
