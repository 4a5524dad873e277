"""Gaussian image pyramids (port of ``vpp_tpu.algorithms.pyramid``).

* ``antialiasing_lowpass_filter`` — separable binomial 1-4-6-4-1 / 16,
  columns then rows, mirror border between passes; integer pixel types
  accumulate in int32 and floor-divide, floats stay float.
* ``subsample2`` — stride-2 decimation at even coordinates.
* level i+1 extent = ``1 + int(extent_i / factor)``.

Float levels with factor 2 take the fused path: filter + decimate, with
the JAX package's documented 2-px rim behaviour (it mirrors the input,
where the reference chain mirrors the filtered values between passes), and
each level's symmetric border. On the card that is kernel K4
(``kernels/csrc/pyramid_decim.cu``): one launch builds the whole float32
pyramid from the frame's interior (a raw frame, or a bordered image's
strided interior), level 0's bordered copy included, into one buffer
(levels past 32 in a chain of launches, each from the last one's final
level). A deep pyramid's levels stop shrinking at 2 px; a 2-px level
decimated to 2 px reads its last tap at index -1, which ``_decim_matrix``'s
numpy index wraps to the level's last pixel, and K4 does the same. A 1-row
or 1-column frame's levels keep that one row or column, every tap folded
onto it as ``_decim_matrix`` folds them.
Its plain version (``pyramid_plain``) is the JAX formulation, a pad and,
per level, two banded float32 products ``A @ x @ Bᵀ`` (``_decim_matrix``)
and a pad, in full float32: TF32 is off in this package.

``pyramid_streams`` builds the pyramids of S frames ((S, H, W), any stream
and row stride) at once, as (S, h + 2b, w + 2b) level buffers: one K4
launch for every stream on the card, the plain chain with a leading S on
the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.border import fill_border_mirror
from ..core.image import Image2d, from_array, pad2d, pad_hw
from ..kernels import LAUNCHES, stream_handle

_BINOMIAL = (1.0, 4.0, 6.0, 4.0, 1.0)


def _is_float(dtype) -> bool:
    return dtype.is_floating_point


def _lowpass_1d(padded: torch.Tensor, axis: int, h: int, w: int,
                offset: int, integer: bool) -> torch.Tensor:
    """5-tap binomial along ``axis`` of a border-padded array, returning the
    interior extent. ``offset`` is the border width."""
    s = None
    for k, coef in enumerate(_BINOMIAL):
        d = k - 2
        if axis == 1:
            sl = padded[offset:offset + h, offset + d:offset + d + w]
        else:
            sl = padded[offset + d:offset + d + h, offset:offset + w]
        tap = (sl.to(torch.int32) * int(coef) if integer
               else sl.to(torch.float32) * coef)
        s = tap if s is None else s + tap
    return torch.div(s, 16, rounding_mode="floor") if integer else s / 16


def antialiasing_lowpass_filter(img: Image2d) -> Image2d:
    """Separable 1-4-6-4-1/16 blur; needs border >= 2."""
    if img.border < 2:
        raise ValueError("lowpass filter needs border >= 2")
    h, w = img.shape
    b = img.border
    integer = not _is_float(img.dtype)
    tmp = _lowpass_1d(img.data, 1, h, w, b, integer)
    tmp = tmp.to(img.dtype) if integer else tmp
    tmp_img = fill_border_mirror(
        Image2d(data=pad2d(tmp, b, b, b, b, "constant"), border=b))
    out = _lowpass_1d(tmp_img.data, 0, h, w, b, integer).to(img.dtype)
    return fill_border_mirror(from_array(out, border=b))


def subsample2(img: Image2d, out_shape: Tuple[int, int] | None = None,
               out_border: int = 0) -> Image2d:
    """Stride-2 decimation; samples past the edge read the border."""
    h, w = img.shape
    if out_shape is None:
        out_shape = (1 + h // 2, 1 + w // 2)
    oh, ow = out_shape
    b = img.border
    need = max(2 * (oh - 1) - (h - 1), 2 * (ow - 1) - (w - 1), 0)
    if b < need:
        raise ValueError(f"subsample2 reads {need} past edge; border={b}")
    data = img.data[b:b + 2 * oh:2, b:b + 2 * ow:2]
    return from_array(data, border=out_border,
                      border_mode="mirror" if out_border else "zero")


def subsample(img: Image2d, out_shape: Tuple[int, int], factor: float,
              out_border: int = 0) -> Image2d:
    """Fractional nearest subsample: out(r,c) = in(int(r*f), int(c*f))."""
    oh, ow = out_shape
    dev = img.device
    b = img.border
    rr = (torch.arange(oh, device=dev) * factor).to(torch.int32).clamp(
        max=img.shape[0] - 1 + b)
    cc = (torch.arange(ow, device=dev) * factor).to(torch.int32).clamp(
        max=img.shape[1] - 1 + b)
    data = img.data[(b + rr)[:, None].long(), (b + cc)[None, :].long()]
    return from_array(data, border=out_border,
                      border_mode="mirror" if out_border else "zero")


def antialias_subsample2(img: Image2d) -> Image2d:
    """Filter + decimate: the binomial blur (on a 2-px mirror border where
    the image has less), then stride-2 decimation into a mirror border of
    ``max(border, 1)``."""
    src = img if img.border >= 2 else from_array(
        img.interior, border=2, border_mode="mirror")
    lp = antialiasing_lowpass_filter(src)
    return subsample2(lp, out_border=max(img.border, 1))


def level_shapes(shape: Tuple[int, int], nlevels: int,
                 factor: float = 2.0) -> Tuple[Tuple[int, int], ...]:
    """Static level geometry chain."""
    shapes = [tuple(shape)]
    for _ in range(nlevels - 1):
        h, w = shapes[-1]
        shapes.append((1 + int(h / factor), 1 + int(w / factor)))
    return tuple(shapes)


@dataclasses.dataclass
class Pyramid:
    """Tuple-of-levels pyramid."""

    levels: Tuple[Image2d, ...]
    factor: float = 2.0

    def __getitem__(self, i: int) -> Image2d:
        return self.levels[i]

    def __len__(self) -> int:
        return len(self.levels)

    @property
    def size(self) -> int:
        return len(self.levels)


_DECIM_CACHE: Dict[Tuple[int, int], np.ndarray] = {}
_DECIM_DEVICE: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}


def _decim_matrix(n: int, on: int) -> np.ndarray:
    """(on, n) banded decimating-binomial matrix: row i holds the
    1-4-6-4-1/16 taps at source rows 2i-2..2i+2, mirror-reflected at the
    edges (symmetric boundary)."""
    key = (n, on)
    if key not in _DECIM_CACHE:
        a = np.zeros((on, n), np.float32)
        for i in range(on):
            for t, kv in enumerate(_BINOMIAL):
                src = 2 * i + t - 2
                if src < 0:
                    src = -src - 1
                if src >= n:
                    src = 2 * n - src - 1
                a[i, src] += kv / 16.0
        _DECIM_CACHE[key] = a
    return _DECIM_CACHE[key]


def _decim_tensor(n: int, on: int, device: torch.device) -> torch.Tensor:
    """``_decim_matrix`` on ``device``, copied there once (a per-frame copy
    from pageable host memory would stall the host)."""
    key = (n, on, torch.device(device))
    if key not in _DECIM_DEVICE:
        _DECIM_DEVICE[key] = torch.from_numpy(_decim_matrix(n, on)).to(device)
    return _DECIM_DEVICE[key]


def _binomial_decimate(interior: torch.Tensor, oh: int,
                       ow: int) -> torch.Tensor:
    """Fused filter+decimate for float levels: ``A @ x @ Bᵀ`` in float32,
    over the two trailing axes of an (..., H, W) level."""
    h, w = interior.shape[-2], interior.shape[-1]
    a = _decim_tensor(h, oh, interior.device)
    bm = _decim_tensor(w, ow, interior.device)
    t = a @ interior.to(torch.float32)
    return (t @ bm.T).to(interior.dtype)


def _plain_levels(interior: torch.Tensor,
                  shapes: Tuple[Tuple[int, int], ...],
                  border: int) -> Tuple[torch.Tensor, ...]:
    """The plain chain on an (..., H, W) interior: every level's bordered
    buffer, each padded ``border`` symmetric."""
    b = border
    levels = [pad_hw(interior, b, b, b, b, "symmetric")]
    cur = interior
    for oh, ow in shapes[1:]:
        cur = _binomial_decimate(cur, oh, ow)
        levels.append(pad_hw(cur, b, b, b, b, "symmetric"))
    return tuple(levels)


def pyramid_plain(interior: torch.Tensor,
                  shapes: Tuple[Tuple[int, int], ...],
                  border: int) -> Tuple[Image2d, ...]:
    """Plain version of K4: the float pyramid of ``interior`` at ``shapes``
    (level 0 first), each level padded ``border`` symmetric."""
    return tuple(Image2d(data=lvl, border=border)
                 for lvl in _plain_levels(interior, shapes, border))


_K4_LEVELS = 32       # pyramid_decim.cu's kMaxLevels: the levels of a launch


def _decimates(n: int, n_out: int) -> bool:
    """Whether K4 decimates ``n`` sources to ``n_out`` outputs: the last
    output's taps reach 2 n_out <= 2 n - 1, or a 2-px level kept at 2 px
    (its last tap wraps, as in ``_decim_matrix``), or a 1-px level kept at
    1 px (every tap on its one pixel)."""
    return 2 * n_out <= 2 * n - 1 or (n <= 2 and n_out == n)


# (shapes, border, first) -> (ctypes rows of (h, w, offset), [(offset,
# size)] of the written levels, buffer length): made once a geometry, since
# the host's time a call is what the per-frame path pays
_K4_LAYOUT: Dict[tuple, tuple] = {}


def _k4_layout(shapes, border: int, first: int):
    key = (shapes, border, first)
    if key not in _K4_LAYOUT:
        rows, spans, off = [], [], 0
        for lvl, (h, w) in enumerate(shapes):
            size = (h + 2 * border) * (w + 2 * border)
            rows += [h, w, off if lvl >= first else -1]
            if lvl >= first:
                spans.append((off, size))
                off += size
        _K4_LAYOUT[key] = ((ctypes.c_longlong * len(rows))(*rows), spans, off)
    return _K4_LAYOUT[key]


def _k4_streams(interior: torch.Tensor,
                shapes: Tuple[Tuple[int, int], ...], border: int, first: int,
                fuse: bool = True) -> Tuple[torch.Tensor, ...]:
    """One K4 launch for S float32 CUDA interiors (S, H, W), any stream and
    row stride: levels ``first`` .. ``len(shapes) - 1`` of every stream's
    pyramid, level l as an (S, h_l + 2b, w_l + 2b) view of one buffer.
    ``first`` 1 leaves level 0 unwritten. ``fuse`` False computes level 2
    after a grid barrier instead of from the frame (the same bits;
    ``call_times.py`` times the two). More than 32 levels are a chain of
    launches, each from the interior of the last one's final level (levels
    past 2 read the level before from the buffer in one launch as well, so
    the chain gives the same bits)."""
    for (h, w), (oh, ow) in zip(shapes, shapes[1:]):
        if min(h, w, oh, ow) < 1:
            raise ValueError(f"pyramid_decim: needs non-empty levels, got "
                             f"({h}, {w}) to ({oh}, {ow})")
        if not (_decimates(h, oh) and _decimates(w, ow)):
            raise ValueError(f"pyramid_decim: ({oh}, {ow}) is not a "
                             f"decimation of ({h}, {w})")
    if len(shapes) > _K4_LEVELS:
        head = _k4_streams(interior, shapes[:_K4_LEVELS], border, first, fuse)
        last = head[-1][:, border:head[-1].shape[1] - border,
                        border:head[-1].shape[2] - border]
        return head + _k4_streams(last, shapes[_K4_LEVELS - 1:], border, 1,
                                  fuse)
    if (interior.dim() != 3 or interior.dtype != torch.float32
            or interior.device.type != "cuda"):
        raise ValueError(f"pyramid_decim: needs float32 CUDA frames (S, H, "
                         f"W), got {tuple(interior.shape)} {interior.dtype} "
                         f"on {interior.device}")
    if interior.stride(2) != 1:
        interior = interior.contiguous()
    n_streams = interior.shape[0]
    rows, spans, total = _k4_layout(tuple(shapes), border, first)
    from ..kernels import _build
    lib = _build.load()
    out = torch.empty((n_streams, total), dtype=torch.float32,
                      device=interior.device)
    code = lib.vpp_pyramid(interior.data_ptr(), interior.stride(1),
                           interior.stride(0), rows, len(shapes), first,
                           border, int(fuse), n_streams, out.data_ptr(),
                           total, stream_handle(interior))
    LAUNCHES["pyramid_decim"] += 1
    _build.check(code, "pyramid_decim")
    return tuple(
        out[:, off:off + size].view(n_streams, h + 2 * border,
                                    w + 2 * border)
        for (off, size), (h, w) in zip(spans, shapes[first:]))


def _k4(interior: torch.Tensor, shapes: Tuple[Tuple[int, int], ...],
        border: int, first: int, fuse: bool = True) -> Tuple[Image2d, ...]:
    """``_k4_streams`` on one float32 CUDA interior (any row stride), each
    level a bordered image."""
    if interior.dim() != 2:
        raise ValueError(f"pyramid_decim: needs a 2-D level, got "
                         f"{tuple(interior.shape)}")
    return tuple(Image2d(data=lvl[0], border=border)
                 for lvl in _k4_streams(interior[None], shapes, border, first,
                                        fuse))


def decimate_level(level: Image2d, oh: int, ow: int, border: int
                   ) -> Image2d:
    """The next float pyramid level, (oh, ow) with a ``border`` symmetric
    pad: K4 on a CUDA level (one launch that writes this level alone,
    computed in float32 and cast to the level's dtype), the plain
    ``_binomial_decimate`` and a pad on a CPU one."""
    if level.data.device.type == "cpu":
        return Image2d(data=pad2d(_binomial_decimate(level.interior, oh, ow),
                                  border, border, border, border,
                                  "symmetric"), border=border)
    (out,) = _k4(level.interior.to(torch.float32), (level.shape, (oh, ow)),
                 border, first=1)
    return Image2d(data=out.data.to(level.dtype), border=border)


def pyramid(img: Image2d, nlevels: int, factor: float = 2.0,
            border: int = 3) -> Pyramid:
    """Build an ``nlevels`` pyramid from level-0 content; every level gets
    a ``max(border, 3)`` mirror border. A float32 CUDA image takes K4's one
    launch (from a raw frame, ``border=0``, as well as from a bordered
    one); other float types on the card pad level 0 and launch K4 once a
    level."""
    shapes = level_shapes(img.shape, nlevels, factor)
    b = max(border, 3)
    if (factor == 2.0 and _is_float(img.dtype)
            and img.interior.dim() == 2):
        if img.data.device.type == "cpu":
            levels = pyramid_plain(img.interior, shapes, b)
        elif img.dtype == torch.float32:
            levels = _k4(img.interior, shapes, b, first=0)
        else:
            levels = [Image2d(data=pad2d(img.interior, b, b, b, b,
                                         "symmetric"), border=b)]
            for i in range(1, nlevels):
                levels.append(decimate_level(levels[-1], *shapes[i], b))
        return Pyramid(levels=tuple(levels), factor=factor)
    lvl0 = from_array(img.interior, border=b, border_mode="mirror")
    levels = [lvl0]
    for i in range(1, nlevels):
        lp = antialiasing_lowpass_filter(levels[-1])
        if factor == 2.0:
            nxt = subsample2(lp, shapes[i], out_border=b)
        else:
            nxt = subsample(lp, shapes[i], factor, out_border=b)
        levels.append(fill_border_mirror(nxt))
    return Pyramid(levels=tuple(levels), factor=factor)


def pyramid_update(pyr: Pyramid, img: Image2d) -> Pyramid:
    """The pyramid of a new frame with ``pyr``'s geometry (levels, factor,
    border): one K4 launch on the card, like ``pyramid``."""
    return pyramid(img, len(pyr.levels), pyr.factor,
                   border=pyr.levels[0].border)


def pyramid_streams(frames: torch.Tensor, nlevels: int,
                    border: int = 3) -> Tuple[torch.Tensor, ...]:
    """The pyramids of S frames (S, H, W) at once: level l as one (S, h_l +
    2b, w_l + 2b) buffer with ``b = max(border, 3)``, each stream's slice
    what ``pyramid(Image2d(data=frames[s], border=0), nlevels,
    border=border)`` gives. Float32 frames on the card take one K4 launch
    for every stream; float frames on the CPU the plain chain with a
    leading S; other types ``pyramid`` stream by stream."""
    shapes = level_shapes(tuple(frames.shape[-2:]), nlevels)
    b = max(border, 3)
    if frames.dtype == torch.float32 and frames.device.type == "cuda":
        return _k4_streams(frames, shapes, b, first=0)
    if _is_float(frames.dtype) and frames.device.type == "cpu":
        return _plain_levels(frames, shapes, b)
    pyrs = [pyramid(Image2d(data=f, border=0), nlevels, border=border)
            for f in frames]
    if len(pyrs) == 1:
        return tuple(lvl.data[None] for lvl in pyrs[0].levels)
    return tuple(torch.stack([p[lvl].data for p in pyrs])
                 for lvl in range(nlevels))
