"""Sampling: bilinear interpolation and batched patch extraction (port of
``vpp_tpu.core.interp``).

``extract_patches_at_tl`` is kernel K5 (``kernels/csrc/patches.cu``): a
plain gather of N size × size patches, bit-equal to the JAX one-hot
matmuls (exact at ``Precision.HIGHEST``) and to its gather branch for
integer types. A CUDA tensor launches the kernel; a CPU tensor takes the
plain version, ``extract_patches_at_tl_plain``. The other functions are
plain PyTorch.
"""

from __future__ import annotations

import torch

from ..kernels import LAUNCHES, require_cuda, stream_handle


def bilinear(data: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an (H, W[, C]) array at (..., 2) float (row, col);
    reads are clamped to the buffer."""
    h, w = data.shape[0], data.shape[1]
    r, c = pts[..., 0], pts[..., 1]
    r0f, c0f = torch.floor(r), torch.floor(c)
    fr, fc = r - r0f, c - c0f
    if data.dim() == 3:
        fr, fc = fr[..., None], fc[..., None]
    r0 = r0f.to(torch.int64).clamp(0, h - 1)
    c0 = c0f.to(torch.int64).clamp(0, w - 1)
    r1 = (r0 + 1).clamp(max=h - 1)
    c1 = (c0 + 1).clamp(max=w - 1)
    top = data[r0, c0] * (1 - fc) + data[r0, c1] * fc
    bot = data[r1, c0] * (1 - fc) + data[r1, c1] * fc
    return top * (1 - fr) + bot * fr


def nearest(data: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sample at float (row, col) points, clamped."""
    h, w = data.shape[0], data.shape[1]
    r = torch.round(pts[..., 0]).to(torch.int64).clamp(0, h - 1)
    c = torch.round(pts[..., 1]).to(torch.int64).clamp(0, w - 1)
    return data[r, c]


def _clamp_tl(tl: torch.Tensor, h: int, w: int, size: int) -> torch.Tensor:
    return torch.stack([tl[:, 0].clamp(0, h - size),
                        tl[:, 1].clamp(0, w - size)], dim=-1)


def extract_patches_at_tl_plain(data: torch.Tensor, tl: torch.Tensor,
                                size: int) -> torch.Tensor:
    """Plain version of K5: advanced indexing at top-lefts clamped into the
    buffer (the callers clamp already; the JAX gather branch clamps too)."""
    h, w = data.shape[0], data.shape[1]
    tl = _clamp_tl(tl.to(torch.int64), h, w, size)
    ar = torch.arange(size, device=data.device)
    rows = (tl[:, 0, None] + ar)[:, :, None]                 # (N, S, 1)
    cols = (tl[:, 1, None] + ar)[:, None, :]                 # (N, 1, S)
    return data[rows, cols]


def _check_patches(data: torch.Tensor, tl: torch.Tensor, size: int) -> None:
    if data.dim() not in (2, 3):
        raise ValueError(f"extract_patches: data must be (H, W) or "
                         f"(H, W, C), got {tuple(data.shape)}")
    if tl.dim() != 2 or tl.shape[1] != 2:
        raise ValueError(f"extract_patches: tl must be (N, 2), got "
                         f"{tuple(tl.shape)}")
    if not (0 < size <= min(data.shape[0], data.shape[1])):
        raise ValueError(f"extract_patches: size {size} does not fit "
                         f"{tuple(data.shape[:2])}")


_ELEM_BYTES = (1, 2, 4, 8)


def extract_patches_at_tl(data: torch.Tensor, tl: torch.Tensor,
                          size: int) -> torch.Tensor:
    """K5: (N, size, size[, C]) patches at (N, 2) integer top-lefts
    (clamped into the buffer). Any dtype; 2-D or channel-last 3-D data."""
    _check_patches(data, tl, size)
    if data.device.type == "cpu":
        return extract_patches_at_tl_plain(data, tl, size)
    esize = data.element_size()
    if esize not in _ELEM_BYTES:
        raise ValueError(f"extract_patches: {data.dtype} is not 1, 2, 4 or "
                         "8 bytes wide")
    h, w = data.shape[0], data.shape[1]
    ch = data.shape[2] if data.dim() == 3 else 1
    n = tl.shape[0]
    if h * w * ch >= 2 ** 31 or n * size * size * ch >= 2 ** 31:
        raise ValueError("extract_patches: more than 2^31 elements")
    data = data.contiguous()
    tl32 = tl.to(torch.int32).contiguous()
    require_cuda("extract_patches", data, tl32,
                 dtypes=(data.dtype, torch.int32))
    out = torch.empty((n, size, size) + tuple(data.shape[2:]),
                      dtype=data.dtype, device=data.device)
    if n == 0:
        return out
    from ..kernels import _build
    lib = _build.load()
    code = lib.vpp_patches(data.data_ptr(), h, w, ch, esize, tl32.data_ptr(),
                           n, size, out.data_ptr(), stream_handle(data))
    LAUNCHES["patches"] += 1
    _build.check(code, "patches")
    return out


def extract_patches(data: torch.Tensor, centers: torch.Tensor,
                    size: int) -> torch.Tensor:
    """Integer-aligned (size × size) patches around (N, 2) int centers,
    clamped so every patch lies inside the buffer. Returns
    (N, size, size[, C])."""
    _check_patches(data, centers, size)
    h, w = data.shape[0], data.shape[1]
    half = size // 2
    tl = _clamp_tl(centers.to(torch.int32) - half, h, w, size)
    return extract_patches_at_tl(data, tl, size)


def extract_patches_bilinear(data: torch.Tensor, centers: torch.Tensor,
                             size: int) -> torch.Tensor:
    """(size × size) patches at fractional (N, 2) float centers, each pixel
    bilinearly sampled. Returns (N, size, size[, C])."""
    half = (size - 1) / 2.0
    offs = torch.arange(size, dtype=centers.dtype,
                        device=centers.device) - half
    dr, dc = torch.meshgrid(offs, offs, indexing="ij")
    grid = torch.stack([dr, dc], dim=-1)
    return bilinear(data, centers[:, None, None, :] + grid[None])
