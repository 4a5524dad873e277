"""Pyramidal Lucas-Kanade sparse flow, batched over keypoints (port of
``vpp_tpu.algorithms.lk``).

* ``lk_match_batch``: per keypoint, the 2x2 gradient matrix G over a
  winsize² window of bilinearly sampled Scharr gradients, a min-eigenvalue
  gate, Newton iterations ``v += G⁻¹ b`` on the temporal difference in a
  search patch around the prediction, and a normalised-SAD residual. It is
  kernel K10 (``kernels/csrc/lk_level.cu``) asked for one level on CUDA
  tensors, and its plain version ``lk_match_batch_plain`` on CPU ones.
* ``pyrlk_match``: coarse to fine over the pyramid on a keypoint set; the
  translation doubles between levels, a level's flow is adopted only where
  its residual is below ``max_err``, ``dist`` is overwritten every level,
  and the final kill tests the finest level's residual (``<=``) and the
  image bounds.
* ``lucas_kanade``: the same with runtime options, building the pyramids
  itself (K4 for the two frames, the 2-channel gradient pyramid on the
  plain route); each level's flow is adopted.
* ``oriented_lk_match_batch``: LK with the window rotated into a match
  direction, plain PyTorch on ``core.interp.bilinear``.

On CUDA images the whole coarse-to-fine pass of ``pyrlk_match`` and
``lucas_kanade`` is one K10 launch (``lk_levels``: every level, the level
glue in the kernel); its plain version is ``lk_levels_plain``, the level
loop with its adopt rule (``_coarse_to_fine``) over ``lk_match_batch_plain``.

The windows are sampled inside integer patches as the JAX package's
``_sample_windows_local`` samples them: the integer shift clipped to
``[0, k - 2]`` and the fraction to ``[0, 1]``, so a sample that leaves the
search patch reads the patch's edge. The plain version takes the two
nonzero taps of the JAX select-over-shifts sum, ``0 + (1 - f) p0 + f p1``
(rows, then columns), each product and sum rounded on its own: the JAX
package's sample bits outside a compiled loop (its CPU compile of the
Newton loop contracts them into FMAs). The residual divides by winsize²
where the reference divides by 2·winsize², so thresholds are 2x the
reference's, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..core.image import Image2d, from_array
from ..core.interp import bilinear, extract_patches_at_tl
from ..core.keypoints import Keypoints, kp_move_all
from ..kernels import LAUNCHES, require_cuda, stream_handle
from .pyramid import Pyramid, pyramid
from .scharr import scharr

# np.float32(3.4e38) as a Python float (exact in float32)
_BIG = float(np.float32(3.4e38))
_MAX_WINSIZE = 15         # K10 keeps ws² <= 8 samples a lane
_MAX_LEVELS = 16          # lk_level.cu's kMaxLevels


def _window_offsets(winsize: int, device=None) -> torch.Tensor:
    """(ws², 2) float32 (dr, dc) offsets of a square window, row-major."""
    hws = winsize // 2
    o = torch.arange(-hws, hws + 1, dtype=torch.float32, device=device)
    dr, dc = torch.meshgrid(o, o, indexing="ij")
    return torch.stack([dr.reshape(-1), dc.reshape(-1)], dim=-1)


def _extract_patches_tl(data: torch.Tensor, centers_f: torch.Tensor,
                        size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, size, size) integer-aligned patches around float ``centers_f``
    (buffer coords; rounded half to even, as ``jnp.round``) and the
    top-left used, clamped into the buffer (K5 on a CUDA tensor)."""
    h, w = data.shape
    half = size // 2
    tl = torch.round(centers_f).to(torch.int32) - half
    tl = torch.stack([tl[:, 0].clamp(0, h - size),
                      tl[:, 1].clamp(0, w - size)], dim=-1)
    return extract_patches_at_tl(data, tl, size), tl


def _axis(s: torch.Tensor, k: int):
    """The sampler's integer shift (clipped to [0, k - 2]) and fraction
    (clipped to [0, 1]) for window starts ``s`` in patch coordinates."""
    i = torch.clamp(torch.floor(s), 0, k - 2 if k > 1 else 0)
    f = torch.clamp(s - i, 0.0, 1.0)
    return i.to(torch.int64), f


def _taps(x: torch.Tensor, i: torch.Tensor, f: torch.Tensor, ws: int,
          dim: int) -> torch.Tensor:
    """``0 + x[i + t] (1 - f) + x[i + 1 + t] f`` for t < ws along ``dim``
    (1: rows, 2: columns) of (N, ., .) ``x``; one tap where the patch
    holds a single shift."""
    idx = i[:, None] + torch.arange(ws, device=x.device)
    shape = [x.shape[0], 1, 1]
    shape[dim] = ws
    f = f.view(-1, 1, 1)

    def take(j):
        j = j.view(shape).expand(
            *(ws if d == dim else x.shape[d] for d in range(3)))
        return x.gather(dim, j)

    out = take(idx) * (1.0 - f) + 0.0
    if x.shape[dim] > ws:
        out = out + take(idx + 1) * f
    return out


def _sample_windows_local(patches: torch.Tensor, s_r: torch.Tensor,
                          s_c: torch.Tensor, ws: int) -> torch.Tensor:
    """(N, ws, ws) windows sampled bilinearly inside (N, P, P) patches at
    per-keypoint float start offsets (patch coords of the window's top-left
    sample): rows first, then columns, the two nonzero taps of the JAX
    package's select over the k = P - ws + 1 integer shifts."""
    k = patches.shape[1] - ws + 1
    isr, fr = _axis(s_r, k)
    isc, fc = _axis(s_c, k)
    rows = _taps(patches, isr, fr, ws, 1)
    return _taps(rows, isc, fc, ws, 2)


def _search_pad(B: Image2d, winsize: int) -> int:
    """Within-level travel budget, shrunk on tiny levels so that the search
    patch fits B's buffer."""
    hb, wb = B.data.shape[:2]
    return max(1, min(12, (min(hb, wb) - winsize - 2) // 2))


def _lane_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of (N, M) terms along M in K10's order: lane l (of 32) adds
    terms l, l + 32, ... to 0 in turn, then an xor butterfly over the lanes
    (strides 16, 8, 4, 2, 1). The padding is +0, which leaves a lane's sum
    as it is (a sum that starts at +0 is never -0)."""
    n, m = t.shape
    per = -(-m // 32)
    lanes = torch.nn.functional.pad(t, (0, per * 32 - m)).view(n, per, 32)
    v = lanes[:, 0] + 0.0
    for k in range(1, per):
        v = v + lanes[:, k]
    ar = torch.arange(32, device=t.device)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, ar ^ o]
    return v[:, 0]


def lk_match_batch_plain(A: Image2d, B: Image2d, Ag: Image2d,
                         p: torch.Tensor, tr_prediction: torch.Tensor, *,
                         winsize: int, min_ev: float, niterations: int,
                         convergence_delta: float, windows: bool = False):
    """Plain version of K10 (the JAX package's ``lk_match_batch``): (flow
    (N, 2), err (N,)), err 3.4e38 for rejected keypoints; with ``windows``,
    also (N, 4, ws²), the template, the row and column gradient windows and
    the search window at the final position, and (N,) int32, the Newton
    steps each keypoint took.

    It is K10's arithmetic, operation for operation: the ws²-term sums in
    the kernel's lane order (``_lane_sum``), every division by a tensor on
    the operands' device (CUDA divides by a Python scalar through its
    reciprocal). So on the same inputs the kernel gives its bits, on the
    card and on the CPU."""
    hws = winsize // 2
    n, nw = p.shape[0], winsize * winsize
    h, w = A.shape
    ba, bb, bg = A.border, B.border, Ag.border
    p = p.to(torch.float32)
    cnt = torch.full((), float(nw), dtype=torch.float32,
                     device=p.device)
    v0 = p + tr_prediction.to(torch.float32)
    pad = _search_pad(B, winsize)
    pt = winsize + 2
    pb = winsize + 2 * pad + 2
    a_data = A.data.to(torch.float32)
    g_data = Ag.data.to(torch.float32)

    ap, a_tl = _extract_patches_tl(a_data, p + ba, pt)
    gp_r, g_tl = _extract_patches_tl(g_data[..., 0].contiguous(), p + bg, pt)
    gp_c, _ = _extract_patches_tl(g_data[..., 1].contiguous(), p + bg, pt)
    s_r = (p[:, 0] + ba) - a_tl[:, 0].to(torch.float32) - hws
    s_c = (p[:, 1] + ba) - a_tl[:, 1].to(torch.float32) - hws
    as_ = _sample_windows_local(ap, s_r, s_c, winsize).reshape(n, nw)
    sg_r = (p[:, 0] + bg) - g_tl[:, 0].to(torch.float32) - hws
    sg_c = (p[:, 1] + bg) - g_tl[:, 1].to(torch.float32) - hws
    gr = _sample_windows_local(gp_r, sg_r, sg_c, winsize).reshape(n, nw)
    gc = _sample_windows_local(gp_c, sg_r, sg_c, winsize).reshape(n, nw)

    a11 = _lane_sum(gr * gr)
    a12 = _lane_sum(gr * gc)
    a22 = _lane_sum(gc * gc)
    tr_g = (a11 + a22) / cnt
    x, y = (a11 - a22) / cnt, a12 / cnt
    det_part = torch.sqrt(torch.clamp(x * x + 4 * (y * y), min=0.0))
    ok = 0.5 * (tr_g - det_part) >= min_ev
    det = a11 * a22 - a12 * a12
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det,
                          torch.zeros_like(det))
    i11 = a22 * inv_det
    i12 = -a12 * inv_det
    i22 = a11 * inv_det

    bp, b_tl = _extract_patches_tl(B.data.to(torch.float32), v0 + bb, pb)
    b_tl_f = b_tl.to(torch.float32)

    def window_at(v):
        sr = (v[:, 0] + bb) - b_tl_f[:, 0] - hws
        sc = (v[:, 1] + bb) - b_tl_f[:, 1] - hws
        return _sample_windows_local(bp, sr, sc, winsize).reshape(n, nw)

    v, active = v0, ok
    steps = torch.zeros((n,), dtype=torch.int32, device=p.device)
    for _ in range(niterations):
        steps = steps + active.to(torch.int32)
        dt = as_ - window_at(v)
        bk1 = _lane_sum(gr * dt)
        bk2 = _lane_sum(gc * dt)
        nk1 = i11 * bk1 + i12 * bk2
        nk2 = i12 * bk1 + i22 * bk2
        v = torch.where(active[:, None], v + torch.stack([nk1, nk2], -1), v)
        active = active & (torch.sqrt(nk1 * nk1 + nk2 * nk2)
                           >= convergence_delta)

    in_domain = ((v[:, 0] >= 0) & (v[:, 0] <= h - 1)
                 & (v[:, 1] >= 0) & (v[:, 1] <= w - 1))
    in_patch = ((v - v0).abs() <= pad).all(1)
    avg = _lane_sum(as_)[:, None] / cnt
    stddev = _lane_sum((as_ - avg).abs()) / cnt
    bs = window_at(v)
    err = _lane_sum((as_ - bs).abs()) / (cnt * torch.clamp(stddev,
                                                           min=1e-6))
    err = torch.where(ok & in_domain & in_patch, err,
                      torch.full_like(err, _BIG))
    if windows:
        return v - p, err, torch.stack([as_, gr, gc, bs], dim=1), steps
    return v - p, err


def _level_operand(img: Image2d, name: str, channels: int) -> torch.Tensor:
    data = img.data
    if data.dtype != torch.float32:
        data = data.to(torch.float32)
    if data.dim() != (2 if channels == 1 else 3) or (
            channels > 1 and data.shape[2] != channels):
        raise ValueError(f"lk_level: {name} must be (H, W)"
                         + ("" if channels == 1 else f" x {channels}")
                         + f", got {tuple(data.shape)}")
    return data.contiguous()


@lru_cache(maxsize=64)
def _sqrt_at_least(delta: float) -> float:
    """The least float32 x with a correctly rounded square root at or above
    float32(``delta``): ``sqrt(x) >= delta`` exactly where ``x >=`` it (the
    square root is monotone). K10 holds a step's squared norm against it;
    -inf for a delta at or below 0, NaN for a NaN delta."""
    d = np.float32(delta)
    if np.isnan(d):
        return float("nan")
    if d <= 0:
        return float("-inf")
    lo, hi = 0, 0x7F800000          # the bit patterns of +0 ... +inf
    while lo < hi:
        mid = (lo + hi) // 2
        if np.sqrt(np.array(mid, np.uint32).view(np.float32)) >= d:
            hi = mid
        else:
            lo = mid + 1
    return float(np.array(lo, np.uint32).view(np.float32))


def _level_row(A: Image2d, B: Image2d, Ag: Image2d, s: int, winsize: int):
    """A level's operands and its row of the C entry's level table: a, ha,
    wa, ba, b, hb, wb, bb, g, hg, wg, bg, h, w, pad, s."""
    a = _level_operand(A, "A", 1)
    b = _level_operand(B, "B", 1)
    g = _level_operand(Ag, "Ag", 2)
    pad = _search_pad(B, winsize)
    pt, pb = winsize + 2, winsize + 2 * pad + 2
    if (pt > min(a.shape[0], a.shape[1], g.shape[0], g.shape[1])
            or pb > min(b.shape[0], b.shape[1])):
        raise ValueError(f"lk_level: the {pt}x{pt} template or {pb}x{pb} "
                         "search patch does not fit its level buffer")
    h, w = A.shape
    row = [a.data_ptr(), a.shape[0], a.shape[1], A.border,
           b.data_ptr(), b.shape[0], b.shape[1], B.border,
           g.data_ptr(), g.shape[0], g.shape[1], Ag.border, h, w, pad, s]
    return (a, b, g), row


def lk_levels(levels, scales, p: torch.Tensor, tr0: torch.Tensor, *,
              winsize: int, min_ev: float, niterations: int,
              convergence_delta: float, adopt: str, factor: float,
              max_err: float = 0.0, windows: bool = False):
    """K10 on CUDA images: LK over ``levels`` ((A, B, Ag) a level, coarsest
    first; the level's keypoints are ``p / 2**scales[i]``) in one launch,
    for the N keypoints ``p`` (finest-level positions) from the prediction
    ``tr0``. At each level the prediction is multiplied by ``factor``, then
    the level's flow replaces it always (``adopt="always"``) or where its
    residual is below ``max_err`` (``adopt="below"``); ``dist`` is the
    level's residual. Returns (tr (N, 2), dist (N,)); with ``windows``
    also each level's flow (L, N, 2), err (L, N), windows (L, N, 4, ws²)
    and Newton steps (L, N) int32, as ``lk_match_batch_plain`` returns
    them."""
    if winsize < 1 or winsize > _MAX_WINSIZE:
        raise ValueError(f"lk_level: winsize {winsize} outside 1..15")
    if adopt not in ("always", "below"):
        raise ValueError(f"lk_level: adopt {adopt!r}")
    if not 1 <= len(levels) <= _MAX_LEVELS:
        raise ValueError(f"lk_level: {len(levels)} levels, 1..16 taken")
    ops, rows = [], []
    for (A, B, Ag), s in zip(levels, scales):
        o, row = _level_row(A, B, Ag, int(s), winsize)
        ops += o
        rows += row
    p = p.to(torch.float32).contiguous()
    tr0 = tr0.to(torch.float32).contiguous()
    require_cuda("lk_level", *ops, p, tr0,
                 dtypes=(torch.float32,) * (len(ops) + 2))
    n, nl, nw = p.shape[0], len(levels), winsize * winsize
    dev = p.device
    buf = torch.empty((3 * n,), dtype=torch.float32, device=dev)
    tr, dist = buf[:2 * n].view(n, 2), buf[2 * n:]
    per = None
    if windows:
        per = (torch.empty((nl, n, 2), dtype=torch.float32, device=dev),
               torch.empty((nl, n), dtype=torch.float32, device=dev),
               torch.empty((nl, n, 4, nw), dtype=torch.float32, device=dev),
               torch.empty((nl, n), dtype=torch.int32, device=dev))
    if n:
        from ..kernels import _build
        code = _build.load().vpp_lk(
            (ctypes.c_longlong * len(rows))(*rows), nl, p.data_ptr(),
            tr0.data_ptr(), n, winsize, float(min_ev), int(niterations),
            _sqrt_at_least(convergence_delta), int(adopt == "below"),
            float(max_err), float(factor), tr.data_ptr(), dist.data_ptr(),
            *((None,) * 4 if per is None else (t.data_ptr() for t in per)),
            stream_handle(p))
        LAUNCHES["lk_level"] += 1
        _build.check(code, "lk_level")
    return (tr, dist) + per if windows else (tr, dist)


def _coarse_to_fine(levels, scales, p: torch.Tensor, tr: torch.Tensor,
                    level_fn, *, adopt: str, factor: float,
                    max_err: float = 0.0, windows: bool = False, **kw):
    """The level loop of ``pyrlk_match`` and ``lucas_kanade`` over
    ``level_fn``: at each level the prediction times ``factor``, the
    level's flow adopted always or where its err is below ``max_err``,
    ``dist`` the level's err. With ``windows``, also each level's result
    stacked as ``lk_levels`` returns it."""
    dist = torch.zeros((p.shape[0],), dtype=torch.float32, device=p.device)
    per = []
    for (A, B, Ag), s in zip(levels, scales):
        tr = tr * factor
        res = level_fn(A, B, Ag, p / float(2 ** s), tr,
                       **(dict(windows=True) if windows else {}), **kw)
        flow, err = res[0], res[1]
        tr = (flow if adopt == "always"
              else torch.where((err < max_err)[:, None], flow, tr))
        dist = err
        per.append(res)
    if windows:
        return (tr, dist) + tuple(torch.stack([r[i] for r in per])
                                  for i in range(4))
    return tr, dist


def lk_levels_plain(levels, scales, p: torch.Tensor, tr0: torch.Tensor, *,
                    winsize: int, min_ev: float, niterations: int,
                    convergence_delta: float, adopt: str, factor: float,
                    max_err: float = 0.0, windows: bool = False):
    """Plain version of ``lk_levels``: the level loop over
    ``lk_match_batch_plain``, the same returns."""
    return _coarse_to_fine(
        levels, scales, p.to(torch.float32), tr0.to(torch.float32),
        lk_match_batch_plain, adopt=adopt, factor=factor, max_err=max_err,
        windows=windows, winsize=winsize, min_ev=min_ev,
        niterations=niterations, convergence_delta=convergence_delta)


def lk_level(A: Image2d, B: Image2d, Ag: Image2d, p: torch.Tensor,
             tr_prediction: torch.Tensor, *, winsize: int, min_ev: float,
             niterations: int, convergence_delta: float,
             windows: bool = False):
    """K10 asked for one level on CUDA images: one launch for the level's
    N keypoints. Same returns as ``lk_match_batch_plain``."""
    out = lk_levels([(A, B, Ag)], [0], p, tr_prediction, winsize=winsize,
                    min_ev=min_ev, niterations=niterations,
                    convergence_delta=convergence_delta, adopt="always",
                    factor=1.0, windows=windows)
    if windows:
        return out[0], out[1], out[4][0], out[5][0]
    return out


def _pyramid_lk(levels, scales, p: torch.Tensor, tr0: torch.Tensor, **kw):
    """The coarse-to-fine pass: one K10 launch on CUDA images, the level
    loop over ``lk_match_batch`` on CPU ones (or where there is no level)."""
    if not levels or levels[0][0].data.device.type == "cpu":
        return _coarse_to_fine(levels, scales, p, tr0, lk_match_batch, **kw)
    return lk_levels(levels, scales, p, tr0, **kw)


def lk_match_batch(A: Image2d, B: Image2d, Ag: Image2d, p: torch.Tensor,
                   tr_prediction: torch.Tensor, *, winsize: int,
                   min_ev: float, niterations: int,
                   convergence_delta: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched LK at one level. p, tr_prediction: (N, 2) float32 in
    interior coordinates of A/B. Returns (flow (N, 2), err (N,)); err is
    3.4e38 for rejected keypoints. K10 on CUDA images, one launch; the
    plain version on CPU ones."""
    kw = dict(winsize=winsize, min_ev=min_ev, niterations=niterations,
              convergence_delta=convergence_delta)
    if A.data.device.type == "cpu":
        return lk_match_batch_plain(A, B, Ag, p, tr_prediction, **kw)
    return lk_level(A, B, Ag, p, tr_prediction, **kw)


def oriented_lk_match_batch(A: Image2d, B: Image2d, Ag: Image2d,
                            p: torch.Tensor, tr_prediction: torch.Tensor, *,
                            match_direction1: torch.Tensor,
                            match_direction2: torch.Tensor,
                            winsize: int, min_ev: float,
                            niterations: int, convergence_delta: float,
                            max_step_norm: float = 2.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LK with the template window rotated into ``match_direction1`` and the
    search window into ``match_direction2`` ((N, 2) unit (row, col): the
    window's column axis; rows follow the perpendicular), steps clamped to
    ``max_step_norm``. G comes from the un-rotated window, as in the
    reference. Returns (flow (N, 2), err (N,)). Plain PyTorch."""
    offs = _window_offsets(winsize, p.device)
    n = p.shape[0]
    h, w = A.shape
    ba, bb, bg = A.border, B.border, Ag.border
    p = p.to(torch.float32)

    def rotate(dirs: torch.Tensor) -> torch.Tensor:
        mx = dirs.to(torch.float32)
        my = torch.stack([-mx[:, 1], mx[:, 0]], dim=-1)
        return (offs[None, :, 0, None] * my[:, None, :]
                + offs[None, :, 1, None] * mx[:, None, :])

    g = bilinear(Ag.data, p[:, None, :] + offs[None] + bg)
    gr0, gc0 = g[..., 0], g[..., 1]
    a11 = (gr0 * gr0).sum(1)
    a12 = (gr0 * gc0).sum(1)
    a22 = (gc0 * gc0).sum(1)
    cnt = float(offs.shape[0])
    tr_g = (a11 + a22) / cnt
    x, y = (a11 - a22) / cnt, a12 / cnt
    det_part = torch.sqrt(torch.clamp(x * x + 4 * (y * y), min=0.0))
    ok = 0.5 * (tr_g - det_part) >= min_ev
    det = a11 * a22 - a12 * a12
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det,
                          torch.zeros_like(det))
    i11 = a22 * inv_det
    i12 = -a12 * inv_det
    i22 = a11 * inv_det

    pts1 = p[:, None, :] + rotate(match_direction1)
    as_ = bilinear(A.data, pts1 + ba)
    g1 = bilinear(Ag.data, pts1 + bg)
    gr, gc = g1[..., 0], g1[..., 1]
    r2 = rotate(match_direction2)

    v0 = p + tr_prediction.to(torch.float32)
    v, active = v0, ok
    for _ in range(niterations):
        dt = as_ - bilinear(B.data, v[:, None, :] + r2 + bb)
        bk1 = (gr * dt).sum(1)
        bk2 = (gc * dt).sum(1)
        nk1 = i11 * bk1 + i12 * bk2
        nk2 = i12 * bk1 + i22 * bk2
        nrm = torch.sqrt(nk1 * nk1 + nk2 * nk2)
        scale = torch.where(nrm > max_step_norm,
                            max_step_norm / torch.clamp(nrm, min=1e-12),
                            torch.ones_like(nrm))
        step = torch.stack([nk1 * scale, nk2 * scale], dim=-1)
        v = torch.where(active[:, None], v + step, v)
        active = active & (nrm >= convergence_delta)

    in_domain = ((v[:, 0] >= 0) & (v[:, 0] <= h - 1)
                 & (v[:, 1] >= 0) & (v[:, 1] <= w - 1))
    avg = as_.sum(1, keepdim=True) / cnt
    stddev = (as_ - avg).abs().sum(1) / cnt
    bs = bilinear(B.data, v[:, None, :] + r2 + bb)
    err = (as_ - bs).abs().sum(1) / (cnt * torch.clamp(stddev, min=1e-6))
    err = torch.where(ok & in_domain, err, torch.full_like(err, _BIG))
    return v - p, err


def gradient_pyramid(pyr: Pyramid) -> Pyramid:
    """Scharr on level 0, then filtered and subsampled down: a 2-channel
    float pyramid (the general route of ``pyramid``, plain PyTorch)."""
    g0 = scharr(pyr[0])
    return pyramid(from_array(g0.interior, border=3, border_mode="mirror"),
                   nlevels=len(pyr), factor=pyr.factor)


def pyrlk_match(pyr_prev: Pyramid, pyr_grad: Pyramid, pyr_next: Pyramid,
                kps: Keypoints, *, winsize: int = 11, min_ev: float = 1e-4,
                max_err: float = 2.0, niterations: int = 21,
                convergence_delta: float = 0.1,
                min_scale: int = 0) -> Keypoints:
    """Coarse-to-fine LK over all keypoint slots: a slot whose final
    residual exceeds ``max_err`` (or that leaves the image) dies, the
    others move by the estimated flow. A level's flow is adopted only
    where its residual is below ``max_err``; ``dist`` is overwritten every
    level, so the kill tests the finest processed level's residual. On
    CUDA pyramids the whole pass is one K10 launch."""
    scales = list(range(len(pyr_prev) - 1, min_scale - 1, -1))
    dev = kps.position.device
    tr, dist = _pyramid_lk(
        [(pyr_prev[s], pyr_next[s], pyr_grad[s]) for s in scales], scales,
        kps.position, torch.zeros((kps.capacity, 2), dtype=torch.float32,
                                  device=dev),
        adopt="below", factor=pyr_prev.factor, max_err=max_err,
        winsize=winsize, min_ev=min_ev, niterations=niterations,
        convergence_delta=convergence_delta)
    h, w = pyr_prev[0].shape
    final = kps.position + tr
    ok = ((dist <= max_err) & (final[:, 0] >= 0) & (final[:, 0] <= h - 1)
          & (final[:, 1] >= 0) & (final[:, 1] <= w - 1))
    return kp_move_all(kps, final, ok)


def lucas_kanade(i1: Image2d, i2: Image2d, keypoints: torch.Tensor, *,
                 niterations: int = 21, winsize: int = 11, nscales: int = 3,
                 min_ev: float = 1e-4, convergence_delta: float = 0.1,
                 prediction: torch.Tensor | None = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Named-option LK: builds the three pyramids and returns (flow (N, 2),
    dist (N,)) for (N, 2) float keypoint positions. On the card: one K4
    launch a frame's pyramid and one K10 launch for every level."""
    border = max(3, winsize // 2)
    p_prev = pyramid(i1, nscales, border=border)
    p_next = pyramid(i2, nscales, border=border)
    p_grad = gradient_pyramid(p_prev)
    n = keypoints.shape[0]
    tr = (torch.zeros((n, 2), dtype=torch.float32, device=keypoints.device)
          if prediction is None
          else prediction.to(torch.float32) / float(2 ** nscales))
    scales = list(range(nscales - 1, -1, -1))
    return _pyramid_lk(
        [(p_prev[s], p_next[s], p_grad[s]) for s in scales], scales,
        keypoints.to(torch.float32), tr, adopt="always", factor=2.0,
        winsize=winsize, min_ev=min_ev, niterations=niterations,
        convergence_delta=convergence_delta)
