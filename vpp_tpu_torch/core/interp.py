"""Sampling: bilinear interpolation and batched patch extraction (port of
``vpp_tpu.core.interp``).

``extract_patches`` (from centres) and ``extract_patches_at_tl`` (from
top-lefts) are kernel K5 (``kernels/csrc/patches.cu``): a plain gather of
N size × size patches, bit-equal to the JAX one-hot matmuls (exact at
``Precision.HIGHEST``) and to its gather branch for integer types. A CUDA
tensor launches the kernel, which also subtracts ``size // 2`` and clamps;
a CPU tensor takes the plain versions, ``extract_patches_plain`` and
``extract_patches_at_tl_plain``. The other functions are plain PyTorch.

Streams: (S, N, 2) centres (or top-lefts) cut from S buffers (S, H, W[,
C]), stream s's patches from buffer s, in one launch; ``bilinear`` and
``extract_patches_bilinear`` take ``streams=True`` for the same layout.
"""

from __future__ import annotations

import torch

from ..kernels import LAUNCHES, require_cuda, stream_handle
from .image import Image2d


def bilinear(data: torch.Tensor, pts: torch.Tensor,
             streams: bool = False) -> torch.Tensor:
    """Bilinear sample of an (H, W[, C]) array at (..., 2) float (row, col);
    reads are clamped to the buffer. With ``streams``, data (S, H, W[, C])
    and points (S, ..., 2): stream s samples buffer s."""
    lead = 1 if streams else 0
    h, w = data.shape[lead], data.shape[lead + 1]
    r, c = pts[..., 0], pts[..., 1]
    r0f, c0f = torch.floor(r), torch.floor(c)
    fr, fc = r - r0f, c - c0f
    if data.dim() == 3 + lead:
        fr, fc = fr[..., None], fc[..., None]
    r0 = r0f.to(torch.int64).clamp(0, h - 1)
    c0 = c0f.to(torch.int64).clamp(0, w - 1)
    r1 = (r0 + 1).clamp(max=h - 1)
    c1 = (c0 + 1).clamp(max=w - 1)
    if streams:
        si = torch.arange(data.shape[0], device=data.device).view(
            (-1,) + (1,) * (r0.dim() - 1))
        top = data[si, r0, c0] * (1 - fc) + data[si, r0, c1] * fc
        bot = data[si, r1, c0] * (1 - fc) + data[si, r1, c1] * fc
    else:
        top = data[r0, c0] * (1 - fc) + data[r0, c1] * fc
        bot = data[r1, c0] * (1 - fc) + data[r1, c1] * fc
    return top * (1 - fr) + bot * fr


def bilinear_image(img: Image2d, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear sample at (..., 2) points in interior coordinates; reads
    that fall in the border are valid."""
    return bilinear(img.data, pts + img.border)


def nearest(data: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sample at float (row, col) points, clamped."""
    h, w = data.shape[0], data.shape[1]
    r = torch.round(pts[..., 0]).to(torch.int64).clamp(0, h - 1)
    c = torch.round(pts[..., 1]).to(torch.int64).clamp(0, w - 1)
    return data[r, c]


def _clamp_tl(tl: torch.Tensor, h: int, w: int, size: int) -> torch.Tensor:
    return torch.stack([tl[..., 0].clamp(0, h - size),
                        tl[..., 1].clamp(0, w - size)], dim=-1)


def extract_patches_at_tl_plain(data: torch.Tensor, tl: torch.Tensor,
                                size: int) -> torch.Tensor:
    """Plain version of K5: advanced indexing at top-lefts clamped into the
    buffer (the JAX gather branch clamps too); (S, N, 2) top-lefts index
    buffers (S, H, W[, C])."""
    lead = tl.dim() - 2
    h, w = data.shape[lead], data.shape[lead + 1]
    tl = _clamp_tl(tl.to(torch.int64), h, w, size)
    ar = torch.arange(size, device=data.device)
    rows = (tl[..., 0, None] + ar)[..., :, None]             # (.., N, S, 1)
    cols = (tl[..., 1, None] + ar)[..., None, :]             # (.., N, 1, S)
    if lead:
        si = torch.arange(data.shape[0], device=data.device).view(-1, 1, 1, 1)
        return data[si, rows, cols]
    return data[rows, cols]


def extract_patches_plain(data: torch.Tensor, centers: torch.Tensor,
                          size: int) -> torch.Tensor:
    """Plain version of K5 from centres: top-left = centre - size // 2,
    clamped into the buffer."""
    return extract_patches_at_tl_plain(data, centers.to(torch.int64)
                                       - size // 2, size)


def _check_patches(data: torch.Tensor, tl: torch.Tensor, size: int) -> None:
    lead = 1 if tl.dim() == 3 else 0
    if data.dim() - lead not in (2, 3) or (lead and data.shape[0]
                                           != tl.shape[0]):
        raise ValueError(f"extract_patches: data must be (H, W) or (H, W, "
                         f"C), (S, ...) with (S, N, 2) centres, got "
                         f"{tuple(data.shape)} and {tuple(tl.shape)}")
    if tl.dim() not in (2, 3) or tl.shape[-1] != 2:
        raise ValueError(f"extract_patches: tl must be (N, 2) or (S, N, 2), "
                         f"got {tuple(tl.shape)}")
    if not (0 < size <= min(data.shape[lead], data.shape[lead + 1])):
        raise ValueError(f"extract_patches: size {size} does not fit "
                         f"{tuple(data.shape[lead:lead + 2])}")


_ELEM_BYTES = (1, 2, 4, 8)


def _launch_patches(data: torch.Tensor, idx: torch.Tensor, off: int,
                    size: int) -> torch.Tensor:
    """K5 on CUDA tensors: one launch into one ``torch.empty``, for every
    stream where ``idx`` is (S, N, 2). The kernel reads int32 or int64
    ``idx`` as they come and clamps ``idx - off`` into the buffer; any
    other index type is converted first."""
    esize = data.element_size()
    if esize not in _ELEM_BYTES:
        raise ValueError(f"extract_patches: {data.dtype} is not 1, 2, 4 or "
                         "8 bytes wide")
    lead = idx.dim() - 2
    n_streams = data.shape[0] if lead else 1
    h, w = data.shape[lead], data.shape[lead + 1]
    ch = data.shape[lead + 2] if data.dim() == lead + 3 else 1
    n = idx.shape[-2]
    if (n_streams * h * w * ch >= 2 ** 31
            or n_streams * n * size * size * ch >= 2 ** 31):
        raise ValueError("extract_patches: more than 2^31 elements")
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.to(torch.int64)
    data, idx = data.contiguous(), idx.contiguous()
    require_cuda("extract_patches", data, idx, dtypes=(data.dtype, idx.dtype))
    out = torch.empty(idx.shape[:-1] + (size, size) + data.shape[lead + 2:],
                      dtype=data.dtype, device=data.device)
    if n == 0:
        return out
    from ..kernels import _build
    code = _build.load().vpp_patches(
        data.data_ptr(), h, w, ch, esize, idx.data_ptr(), idx.element_size(),
        off, n, n_streams, size, out.data_ptr(), stream_handle(data))
    LAUNCHES["patches"] += 1
    _build.check(code, "patches")
    return out


def extract_patches_at_tl(data: torch.Tensor, tl: torch.Tensor,
                          size: int) -> torch.Tensor:
    """K5: (N, size, size[, C]) patches at (N, 2) integer top-lefts
    (clamped into the buffer); (S, N, 2) top-lefts into S buffers give
    (S, N, size, size[, C]). Any dtype; 2-D or channel-last 3-D data."""
    _check_patches(data, tl, size)
    if data.device.type == "cpu":
        return extract_patches_at_tl_plain(data, tl, size)
    return _launch_patches(data, tl, 0, size)


def extract_patches(data: torch.Tensor, centers: torch.Tensor,
                    size: int) -> torch.Tensor:
    """K5 from centres: integer-aligned (size × size) patches around (N, 2)
    int centers, clamped so every patch lies inside the buffer. Returns
    (N, size, size[, C]); (S, N, 2) centres into S buffers (S, H, W[, C])
    give (S, N, size, size[, C]). On a CUDA tensor, one launch for every
    stream: the kernel takes int32 or int64 centres as they are and does
    the arithmetic itself."""
    _check_patches(data, centers, size)
    if data.device.type == "cpu":
        return extract_patches_plain(data, centers, size)
    return _launch_patches(data, centers, size // 2, size)


def extract_patches_bilinear(data: torch.Tensor, centers: torch.Tensor,
                             size: int, streams: bool = False
                             ) -> torch.Tensor:
    """(size × size) patches at fractional (N, 2) float centers, each pixel
    bilinearly sampled. Returns (N, size, size[, C]); with ``streams``,
    (S, N, 2) centres in S buffers give (S, N, size, size[, C])."""
    half = (size - 1) / 2.0
    offs = torch.arange(size, dtype=centers.dtype,
                        device=centers.device) - half
    dr, dc = torch.meshgrid(offs, offs, indexing="ij")
    grid = torch.stack([dr, dc], dim=-1)
    return bilinear(data, centers[..., :, None, None, :] + grid, streams)
