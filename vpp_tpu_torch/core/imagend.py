"""N-dimensional bordered image container and its 3-D alias (port of
``vpp_tpu.core.imagend``).

One tensor of shape ``(D1 + 2b, ..., DN + 2b[, C])``: the border is
materialised padding, views (interior, shifted neighbours, subimages) are
slices of it, and ``linear_interpolate`` blends the 2^N corners of each
position. The JAX class is a pytree; this one is a frozen dataclass over
one tensor, and ``with_interior`` writes into a copy, never into the
caller's buffer.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from .image import _MODES, _as_tensor, pad_index


@dataclasses.dataclass(frozen=True)
class BoxNd:
    """Inclusive N-d box: p1 and p2 both inside."""

    p1: Tuple[int, ...]
    p2: Tuple[int, ...]

    def __post_init__(self):
        if len(self.p1) != len(self.p2):
            raise ValueError(f"BoxNd corners differ in rank: {self.p1}, "
                             f"{self.p2}")

    @property
    def ndim(self) -> int:
        return len(self.p1)

    def size(self, axis: int) -> int:
        return self.p2[axis] - self.p1[axis] + 1

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.size(i) for i in range(self.ndim))

    def has(self, p: Sequence[int]) -> bool:
        return all(self.p1[i] <= p[i] <= self.p2[i]
                   for i in range(self.ndim))

    def grow(self, border: int) -> "BoxNd":
        return BoxNd(tuple(a - border for a in self.p1),
                     tuple(a + border for a in self.p2))

    def shrink(self, border: int) -> "BoxNd":
        return self.grow(-border)


def make_box3d(nslices: int, nrows: int, ncols: int) -> BoxNd:
    return BoxNd((0, 0, 0), (nslices - 1, nrows - 1, ncols - 1))


def make_boxNd(shape: Sequence[int]) -> BoxNd:
    return BoxNd((0,) * len(shape), tuple(s - 1 for s in shape))


@dataclasses.dataclass(frozen=True, eq=False)
class ImageNd:
    """Immutable bordered N-d image.

    ``data`` has shape ``(*[d + 2*border], C?)``; ``nsdim`` says how many
    leading axes are spatial (the rest are channels)."""

    data: torch.Tensor
    border: int = 0
    nsdim: int = 3

    @property
    def shape(self) -> Tuple[int, ...]:
        b = 2 * self.border
        return tuple(self.data.shape[i] - b for i in range(self.nsdim))

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def domain(self) -> BoxNd:
        return make_boxNd(self.shape)

    def domain_with_border(self) -> BoxNd:
        return self.domain().grow(self.border)

    @property
    def interior(self) -> torch.Tensor:
        b = self.border
        if b == 0:
            return self.data
        return self.data[tuple(slice(b, -b) for _ in range(self.nsdim))]

    def with_interior(self, values) -> "ImageNd":
        """A new image whose interior is ``values`` (border kept), in a
        copy of the buffer."""
        values = torch.as_tensor(values, device=self.device)
        b = self.border
        if b == 0:
            return ImageNd(data=values.clone(), border=0, nsdim=self.nsdim)
        new = self.data.clone()
        sl = tuple(slice(b, b + s) for s in self.shape)
        new[sl] = values.to(new.dtype)
        return ImageNd(data=new, border=b, nsdim=self.nsdim)

    def shifted(self, *offsets: int) -> torch.Tensor:
        """Interior-shaped view shifted into the border (relative access
        in N-d; requires |offset| <= border)."""
        b = self.border
        if len(offsets) != self.nsdim:
            raise ValueError(f"{len(offsets)} offsets for {self.nsdim} "
                             "spatial axes")
        if any(abs(o) > b for o in offsets):
            raise ValueError(f"shift {offsets} exceeds border {b}")
        return self.data[tuple(slice(b + o, b + o + s)
                               for o, s in zip(offsets, self.shape))]

    def subimage(self, box: BoxNd) -> "ImageNd":
        """Domain-restricted view that keeps the full parent border, with
        the parent's neighbouring content in it."""
        b = self.border
        sl = tuple(slice(box.p1[i], box.p2[i] + 1 + 2 * b)
                   for i in range(self.nsdim))
        return ImageNd(data=self.data[sl], border=b, nsdim=self.nsdim)

    def __or__(self, box: BoxNd) -> "ImageNd":
        return self.subimage(box)

    def __call__(self, *p):
        """Border-aware read; negative coords reach into the border."""
        b = self.border
        return self.data[tuple(b + q for q in p)]

    def linear_interpolate(self, pos) -> torch.Tensor:
        """Multilinear interpolation at float position(s) ``pos`` (...,
        nsdim) in interior coordinates: floor, each corner's index clipped
        to the bordered buffer, the 2^N corners summed in order (bit i of
        the corner number picks the upper neighbour on axis i), each
        product and sum rounded in float32 as the JAX module rounds it."""
        b = self.border
        nd = self.nsdim
        p = torch.as_tensor(pos, dtype=torch.float32,
                            device=self.device) + b
        lo = torch.floor(p).to(torch.int32)
        frac = p - lo
        out = 0.0
        for corner in range(1 << nd):
            w = 1.0
            idx = []
            for i in range(nd):
                bit = (corner >> i) & 1
                w = w * (frac[..., i] if bit else 1.0 - frac[..., i])
                idx.append((lo[..., i] + bit).clamp(
                    0, self.data.shape[i] - 1).long())
            val = self.data[tuple(idx)]
            extra = val.dim() - w.dim()
            out = out + val * w.reshape(w.shape + (1,) * extra)
        return out

    def to_numpy(self) -> np.ndarray:
        return self.interior.detach().cpu().numpy()

    def astype(self, dtype) -> "ImageNd":
        return ImageNd(data=self.data.to(dtype), border=self.border,
                       nsdim=self.nsdim)


def imagend(shape: Sequence[int], *, dtype=torch.float32, border: int = 0,
            channels: int = 0, device="cuda") -> ImageNd:
    """A zero N-d image on ``device`` (the card unless asked for the
    CPU)."""
    full = tuple(s + 2 * border for s in shape)
    if channels:
        full = full + (channels,)
    return ImageNd(data=torch.zeros(full, dtype=dtype,
                                    device=resolve_device(device)),
                   border=border, nsdim=len(shape))


def image3d(nslices: int, nrows: int, ncols: int, *, dtype=torch.float32,
            border: int = 0, channels: int = 0, device="cuda") -> ImageNd:
    """A zero 3-D image (slices, rows, cols)."""
    return imagend((nslices, nrows, ncols), dtype=dtype, border=border,
                   channels=channels, device=device)


def from_array_nd(arr, *, nsdim: int | None = None, border: int = 0,
                  border_mode: str = "zero", device="cuda") -> ImageNd:
    """Wrap an array on ``device``, materialising the border on the
    spatial axes: 'zero' | 'mirror' (numpy's symmetric) | 'closest'
    (edge)."""
    arr = _as_tensor(arr, resolve_device(device))
    if nsdim is None:
        nsdim = arr.dim()
    if border == 0:
        return ImageNd(data=arr, border=0, nsdim=nsdim)
    mode = _MODES[border_mode]
    if mode == "constant":
        full = tuple(s + 2 * border for s in arr.shape[:nsdim]) + \
            tuple(arr.shape[nsdim:])
        data = torch.zeros(full, dtype=arr.dtype, device=arr.device)
        data[tuple(slice(border, border + s)
                   for s in arr.shape[:nsdim])] = arr
    else:
        data = arr
        for ax in range(nsdim):
            data = data.index_select(ax, pad_index(
                arr.shape[ax], border, border, mode, arr.device))
    return ImageNd(data=data, border=border, nsdim=nsdim)
