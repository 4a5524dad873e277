"""Border fills (port of ``vpp_tpu.core.border``).

* value:   every border cell gets a constant.
* mirror:  cell at interior-relative coord ``-k`` reads interior ``k-1``
           (symmetric reflection including the edge pixel, fill.hh).
* closest: clamp-to-edge.
"""

from __future__ import annotations

import torch

from .image import Image2d, from_array, pad2d


def _repad(img: Image2d, mode: str, value=0) -> Image2d:
    b = img.border
    if b == 0:
        return img
    return Image2d(data=pad2d(img.interior, b, b, b, b, mode, value),
                   border=b)


def fill(img: Image2d, value) -> Image2d:
    """Fill the interior; border content preserved."""
    return img.with_interior(torch.full(img.interior.shape, value,
                                        dtype=img.dtype, device=img.device))


def fill_with_border(img: Image2d, value) -> Image2d:
    return Image2d(data=torch.full(img.data.shape, value, dtype=img.dtype,
                                   device=img.device), border=img.border)


def fill_border_with_value(img: Image2d, value) -> Image2d:
    return _repad(img, "constant", value)


def fill_border_mirror(img: Image2d) -> Image2d:
    return _repad(img, "symmetric")


def fill_border_closest(img: Image2d) -> Image2d:
    return _repad(img, "edge")


def clone(img: Image2d, *, border: int | None = None,
          border_mode: str = "zero") -> Image2d:
    """Deep copy with optional border override."""
    b = img.border if border is None else border
    return from_array(img.interior.clone(), border=b,
                      border_mode=border_mode)
