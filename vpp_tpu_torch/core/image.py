"""Bordered 2-D image container — the central data structure.

Port of ``vpp_tpu.core.image``: a pixel buffer of shape
``(H + 2b, W + 2b[, C])`` with a materialised border around the logical
domain, O(1) subimage views and shifted interior views for stencils.

Border padding modes follow numpy's names: ``mirror`` is numpy's
``symmetric`` (the edge pixel is repeated, reference fill.hh), ``closest``
is ``edge``. ``torch.nn.functional.pad(mode="reflect")`` is numpy's
``reflect`` (edge not repeated) and is NOT used: the pads here are index
maps, which also work for every dtype and any border width.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .box import Box2d


@dataclasses.dataclass
class Image2d:
    """Bordered image. ``data`` is ``(nrows + 2*border, ncols + 2*border)``
    or ``(..., C)``; ``border`` is static metadata."""

    data: torch.Tensor
    border: int = 0

    # -- geometry ----------------------------------------------------------
    @property
    def nrows(self) -> int:
        return self.data.shape[0] - 2 * self.border

    @property
    def ncols(self) -> int:
        return self.data.shape[1] - 2 * self.border

    @property
    def nchannels(self) -> int:
        return 1 if self.data.ndim == 2 else self.data.shape[2]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def domain(self) -> Box2d:
        return Box2d(0, 0, self.nrows - 1, self.ncols - 1)

    def domain_with_border(self) -> Box2d:
        return self.domain().grow(self.border)

    # -- views -------------------------------------------------------------
    @property
    def interior(self) -> torch.Tensor:
        """The logical (border-free) pixel array (a view)."""
        b = self.border
        if b == 0:
            return self.data
        return self.data[b:-b, b:-b]

    def with_interior(self, values: torch.Tensor) -> "Image2d":
        """A new image whose interior is ``values`` (border kept)."""
        b = self.border
        values = torch.as_tensor(values, device=self.device)
        if b == 0:
            return Image2d(data=values, border=0)
        new = self.data.clone()
        new[b:b + self.nrows, b:b + self.ncols] = values.to(new.dtype)
        return Image2d(data=new, border=b)

    def shifted(self, dr: int, dc: int) -> torch.Tensor:
        """Interior-shaped view shifted by (dr, dc) into the border.
        Requires ``|dr|, |dc| <= border``."""
        b = self.border
        if abs(dr) > b or abs(dc) > b:
            raise ValueError(f"shift ({dr},{dc}) exceeds border {b}")
        r0, c0 = b + dr, b + dc
        return self.data[r0:r0 + self.nrows, c0:c0 + self.ncols]

    def subimage(self, box: Box2d) -> "Image2d":
        """Domain-restricted view that keeps the full parent border: pixels
        beyond the box edge hold the parent's neighbouring content."""
        b = self.border
        sl = self.data[box.r1: box.r2 + 1 + 2 * b,
                       box.c1: box.c2 + 1 + 2 * b]
        return Image2d(data=sl, border=b)

    def __or__(self, box: Box2d) -> "Image2d":
        return self.subimage(box)

    def __call__(self, r, c):
        """Border-aware pixel read; accepts negative (border) coords."""
        b = self.border
        return self.data[b + r, b + c]

    # -- conversions ---------------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        return self.interior.detach().cpu().numpy()

    def astype(self, dtype) -> "Image2d":
        return Image2d(data=self.data.to(dtype), border=self.border)


def _as_tensor(arr, device=None) -> torch.Tensor:
    """Tensor from an array; numpy 64-bit types narrow to 32 bits, as the
    JAX package's arrays do."""
    if isinstance(arr, torch.Tensor):
        return arr if device is None else arr.to(device)
    a = np.asarray(arr)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.as_tensor(a, device=device)


def pad_index(n: int, before: int, after: int, mode: str,
              device=None) -> torch.Tensor:
    """Source index for every position of a padded axis of length n.

    ``symmetric`` repeats the edge pixel (period 2n, numpy's symmetric),
    ``edge`` clamps."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "symmetric":
        m = torch.remainder(i, 2 * n)
        return torch.where(m >= n, 2 * n - 1 - m, m)
    raise ValueError(f"unknown pad mode {mode!r}")


def pad2d(arr: torch.Tensor, top: int, bottom: int, left: int, right: int,
          mode: str, value=0) -> torch.Tensor:
    """Pad the two leading axes: ``constant`` | ``symmetric`` | ``edge``."""
    h, w = arr.shape[0], arr.shape[1]
    if mode == "constant":
        out = torch.full((h + top + bottom, w + left + right) + arr.shape[2:],
                         value, dtype=arr.dtype, device=arr.device)
        out[top:top + h, left:left + w] = arr
        return out
    ri = pad_index(h, top, bottom, mode, arr.device)
    ci = pad_index(w, left, right, mode, arr.device)
    return arr.index_select(0, ri).index_select(1, ci)


def pad_hw(arr: torch.Tensor, top: int, bottom: int, left: int, right: int,
           mode: str, value=0) -> torch.Tensor:
    """``pad2d`` on the two trailing axes of an (..., H, W) array: the
    pads of stacked (S, H, W) buffers, one stream a leading index."""
    h, w = arr.shape[-2], arr.shape[-1]
    if mode == "constant":
        out = torch.full(arr.shape[:-2] + (h + top + bottom, w + left + right),
                         value, dtype=arr.dtype, device=arr.device)
        out[..., top:top + h, left:left + w] = arr
        return out
    ri = pad_index(h, top, bottom, mode, arr.device)
    ci = pad_index(w, left, right, mode, arr.device)
    return arr.index_select(-2, ri).index_select(-1, ci)


_MODES = {"zero": "constant", "mirror": "symmetric", "closest": "edge"}


def image2d(nrows: int, ncols: int, *, dtype=torch.float32, border: int = 0,
            channels: int = 0, device=None) -> Image2d:
    """Allocate a zero image."""
    shape = (nrows + 2 * border, ncols + 2 * border)
    if channels:
        shape = shape + (channels,)
    return Image2d(data=torch.zeros(shape, dtype=dtype, device=device),
                   border=border)


def from_array(arr, *, border: int = 0, border_mode: str = "zero",
               device=None) -> Image2d:
    """Wrap an (H, W[, C]) array, materialising the border padding.

    ``border_mode``: 'zero' | 'mirror' | 'closest'. A tensor keeps its
    device unless ``device`` is given; a numpy array goes to ``device``
    (the CPU when None)."""
    arr = _as_tensor(arr, device)
    if border == 0:
        return Image2d(data=arr, border=0)
    data = pad2d(arr, border, border, border, border, _MODES[border_mode])
    return Image2d(data=data, border=border)


def pad_to_multiple(arr, row_mult: int = 8, col_mult: int = 128,
                    value=0) -> torch.Tensor:
    """Pad the leading (H, W) dims at their ends up to multiples of
    ``row_mult`` and ``col_mult`` with ``value`` (the JAX package's
    hardware-tile alignment; nothing on the card needs it)."""
    arr = _as_tensor(arr)
    h, w = arr.shape[0], arr.shape[1]
    ph, pw = (-h) % row_mult, (-w) % col_mult
    if ph == 0 and pw == 0:
        return arr
    return pad2d(arr, 0, ph, 0, pw, "constant", value)


def saturate_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float to integer as XLA converts (the JAX package's ``astype``): the
    fraction truncated, NaN to 0, values past the type's range to its
    bounds. A plain ``.to`` leaves NaN and overflow to the platform: INT_MIN
    on the CPU, 0 on the card."""
    info = torch.iinfo(dtype)
    return x.nan_to_num(0.0).double().clamp(info.min, info.max).to(dtype)
