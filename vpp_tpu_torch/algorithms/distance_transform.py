"""Distance transforms: chamfer and Euclidean (port of
``vpp_tpu.algorithms.distance_transform``).

* ``chamfer_distance_transform`` with the reference's metric instances
  ``d4``, ``d8``, ``d3_4`` and ``d5_7_11``. ``method="doubling"`` (the
  default) takes ~log2(max(H, W)) rounds of full-image shift-and-min steps
  over the whole neighbourhood at strides 2^k; every value is a small
  integer in float32, so it equals the JAX package bit for bit.
  ``method="sweeps"`` keeps the reference-shaped recurrence: a forward and
  a backward raster sweep, row by row, each row's within-row recurrence
  ``out[i] = min(row[i], out[i-1] + w)`` as a log-step min-plus scan.
  Where a value is below ``_INF`` (a seed reaches it) it is exact; in a row
  no seed has reached yet the scan adds multiples of w to ``_INF`` = 1e9,
  which float32 rounds in an order-dependent way, so there the value is
  only some number >= 1e9, as in the JAX package's associative scan. Both
  are plain PyTorch.
* ``euclidean_distance_transform``: jump flooding, log2(max(H, W)) passes
  at strides N/2 ... 1 and one more at stride 1. A pass is the JAX
  package's 8 whole-image neighbour steps, each reading the planes the
  previous one left. Each pass is kernel K11 (``kernels/csrc/jfa.cu``, one
  cooperative launch a pass) on a CUDA mask and its plain version
  (``jfa_pass_plain``) on a CPU one. Distances are float32
  sums of two squared int32 differences below 2^24, exact, so the kernel,
  the plain version and the JAX package agree bit for bit, in the
  distances and in the displacement vectors.

A numpy mask goes to ``device`` (the card unless the caller asks for the
CPU); a tensor mask keeps its device.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..core.image import Image2d
from ..kernels import LAUNCHES, require_cuda, stream_handle

_INF = 1e9
_NONE = -(1 << 20)       # "no seed yet" coordinate

# forward half-neighbourhoods: (dr, dc, weight); backward = point-mirrored
NEIGHBORHOODS: Dict[str, Sequence[Tuple[int, int, float]]] = {
    "d4": ((-1, 0, 1.0), (0, -1, 1.0)),
    "d8": ((-1, -1, 1.0), (-1, 0, 1.0), (-1, 1, 1.0), (0, -1, 1.0)),
    "d3_4": ((-1, -1, 4.0), (-1, 0, 3.0), (-1, 1, 4.0), (0, -1, 3.0)),
    "d5_7_11": ((-2, -1, 11.0), (-2, 1, 11.0),
                (-1, -2, 11.0), (-1, -1, 7.0), (-1, 0, 5.0),
                (-1, 1, 7.0), (-1, 2, 11.0),
                (0, -1, 5.0)),
}


def _seed_mask(seeds, device) -> torch.Tensor:
    """The seeds as a bool tensor: an image's interior, a tensor on its own
    device, anything else on ``device``."""
    if isinstance(seeds, Image2d):
        seeds = seeds.interior
    if not isinstance(seeds, torch.Tensor):
        seeds = torch.from_numpy(np.asarray(seeds)).to(
            resolve_device(device))
    return seeds.to(torch.bool)


# -- chamfer -----------------------------------------------------------------

def _shift_row(row: torch.Tensor, dc: int) -> torch.Tensor:
    """Shift a (W,) row by dc, filling with ``_INF``."""
    if dc == 0:
        return row
    fill = torch.full((abs(dc),), _INF, dtype=row.dtype, device=row.device)
    if dc > 0:
        return torch.cat([fill, row[:-dc]])
    return torch.cat([row[-dc:], fill])


def _minplus_scan(row: torch.Tensor, w: float,
                  reverse: bool) -> torch.Tensor:
    """out[i] = min_{j<=i} row[j] + (i-j)*w (mirrored when reverse): the
    recurrence ``out[i] = min(row[i], out[i-1] + w)`` as a log-step
    (Hillis-Steele) scan over (value, length) segments."""
    if reverse:
        row = row.flip(0)
    val = row
    length = torch.ones_like(row)
    d = 1
    while d < row.shape[0]:
        av, an = val[:-d], length[:-d]
        bv, bn = val[d:], length[d:]
        val = torch.cat([val[:d], torch.minimum(bv, av + bn * w)])
        length = torch.cat([length[:d], an + bn])
        d *= 2
    return val.flip(0) if reverse else val


def _sweep(dist: torch.Tensor, nbh: Sequence[Tuple[int, int, float]],
           backward: bool) -> torch.Tensor:
    """One raster sweep of the incremental recurrence, row by row."""
    nrows_back = max(-dr for dr, _, _ in nbh)
    cross = [(dr, dc, w) for dr, dc, w in nbh if dr != 0]
    inrow = [w for dr, _, w in nbh if dr == 0]
    sgn = -1 if backward else 1
    h, w_ = dist.shape
    carry = [torch.full((w_,), _INF, dtype=dist.dtype, device=dist.device)
             for _ in range(nrows_back)]        # nearest previous row first
    out = [None] * h
    for r in (range(h - 1, -1, -1) if backward else range(h)):
        c = torch.clamp(dist[r], max=_INF)
        for dr, dc, w in cross:
            c = torch.minimum(c, _shift_row(carry[-dr - 1], sgn * dc) + w)
        for w in inrow:
            c = _minplus_scan(c, w, reverse=backward)
        carry = [c] + carry[:-1]
        out[r] = c
    return torch.stack(out)


def _shift2(a: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """2-D shift with ``_INF`` fill (reads outside the domain are no
    paths)."""
    h, w = a.shape
    out = torch.full_like(a, _INF)
    if abs(dr) >= h or abs(dc) >= w:
        return out
    out[max(dr, 0):h + min(dr, 0), max(dc, 0):w + min(dc, 0)] = \
        a[max(-dr, 0):h + min(-dr, 0), max(-dc, 0):w + min(-dc, 0)]
    return out


def chamfer_distance_transform(seeds, metric: str = "d3_4",
                               method: str = "doubling", *,
                               device="cuda") -> torch.Tensor:
    """Chamfer distance to the ``seeds`` mask (True/nonzero = distance 0)
    with the reference's metric instances. Returns float32 (H, W) weighted
    distances (divide by 3 for d3_4, by 5 for d5_7_11 for approximate
    Euclidean pixels)."""
    nbh = NEIGHBORHOODS[metric]
    mask = _seed_mask(seeds, device)
    dist = torch.where(mask, 0.0, _INF).to(torch.float32)
    if method == "sweeps":
        dist = _sweep(dist, nbh, backward=False)
        return _sweep(dist, nbh, backward=True)
    full = list(nbh) + [(-dr, -dc, w) for dr, dc, w in nbh]
    h, w_ = dist.shape
    k = 1
    while k * 2 < max(h, w_):
        k *= 2
    while k >= 1:
        for dr, dc, w in full:
            dist = torch.minimum(dist, _shift2(dist, k * dr, k * dc) + k * w)
        k //= 2
    return dist


# -- Euclidean: jump flooding (K11) --------------------------------------------

def _steps(h: int, w: int) -> Tuple[int, ...]:
    """The passes' strides: N/2 ... 1, then 1 again (JFA+1)."""
    step, out = 1, []
    while step * 2 < max(h, w):
        step *= 2
    while step >= 1:
        out.append(step)
        step //= 2
    return tuple(out) + (1,)


def _dist2(br: torch.Tensor, bc: torch.Tensor, rr: torch.Tensor,
           cc: torch.Tensor) -> torch.Tensor:
    d = ((br - rr).to(torch.float32) ** 2
         + (bc - cc).to(torch.float32) ** 2)
    return torch.where(br <= _NONE, _INF, d)


def _neighbours(step: int):
    """The 8 neighbour offsets in the JAX package's order."""
    return [(dr, dc) for dr in (-step, 0, step) for dc in (-step, 0, step)
            if (dr, dc) != (0, 0)]


def jfa_pass_plain(best_r: torch.Tensor, best_c: torch.Tensor,
                   step: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K11: one jump-flooding pass over (H, W) int32 seed
    coordinates, the JAX package's loop: for each of the 8 neighbour
    offsets at stride ``step`` in turn, the planes as the previous offset
    left them are rolled by it (``jnp.roll``'s direction: the neighbour
    (dr, dc) of (r, c) is (r - dr, c - dc); outside the domain it is no
    candidate), and every pixel takes the rolled coordinates where they
    are strictly closer."""
    h, w = best_r.shape
    dev = best_r.device
    rr = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    cc = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    d = _dist2(best_r, best_c, rr, cc)
    for dr, dc in _neighbours(step):
        nr = torch.roll(best_r, (dr, dc), (0, 1))
        nc = torch.roll(best_c, (dr, dc), (0, 1))
        row_ok = _row_ok(h, w, dr, dc, dev)
        nd = torch.where(row_ok, _dist2(nr, nc, rr, cc), _INF)
        take = nd < d
        best_r = torch.where(take, nr, best_r)
        best_c = torch.where(take, nc, best_c)
        d = torch.minimum(d, nd)
    return best_r, best_c


_ROW_OK: Dict[tuple, torch.Tensor] = {}


def _row_ok(h: int, w: int, dr: int, dc: int, dev) -> torch.Tensor:
    """(H, W) bool: the neighbour (r - dr, c - dc) lies in the domain. Made
    once a geometry and device: it is static."""
    key = (h, w, dr, dc, torch.device(dev))
    if key not in _ROW_OK:
        rows = torch.arange(h, device=dev) - dr
        cols = torch.arange(w, device=dev) - dc
        _ROW_OK[key] = (((rows >= 0) & (rows < h))[:, None]
                        & ((cols >= 0) & (cols < w))[None, :])
    return _ROW_OK[key]


def jfa_pass(best_r: torch.Tensor, best_c: torch.Tensor, step: int,
             out=None, scratch=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11: one jump-flooding pass in one cooperative launch (the 8
    neighbour steps, grid barriers between), into the ``out`` pair of
    planes through the ``scratch`` pair (each allocated when not given;
    neither may alias the input); a CPU tensor takes ``jfa_pass_plain``."""
    if best_r.device.type == "cpu":
        return jfa_pass_plain(best_r, best_c, step)
    h, w = best_r.shape
    if out is None:
        out = (torch.empty_like(best_r), torch.empty_like(best_c))
    if scratch is None:
        scratch = (torch.empty_like(best_r), torch.empty_like(best_c))
    best_r, best_c = best_r.contiguous(), best_c.contiguous()
    require_cuda("jfa", best_r, best_c, *scratch, *out,
                 dtypes=(torch.int32,) * 6)
    if h * w >= 2 ** 31:
        raise ValueError("jfa: more than 2^31 pixels")
    from ..kernels import _build
    code = _build.load().vpp_jfa_pass(
        best_r.data_ptr(), best_c.data_ptr(), h, w, step,
        scratch[0].data_ptr(), scratch[1].data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), stream_handle(best_r))
    LAUNCHES["jfa"] += 1
    _build.check(code, "jfa")
    return out


def _jump_flood(mask: torch.Tensor, pass_fn=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jump flooding from a bool mask: the passes through ``pass_fn``
    (``jfa_pass`` when None: on the card its output and scratch planes
    are allocated once and reused), then the squared distance and the
    vectors from the final coordinates."""
    h, w = mask.shape
    dev = mask.device
    rr = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    cc = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    none = torch.full((h, w), _NONE, dtype=torch.int32, device=dev)
    best_r = torch.where(mask, rr, none)
    best_c = torch.where(mask, cc, none)
    if pass_fn is None and dev.type == "cuda":
        planes = [torch.empty_like(best_r) for _ in range(4)]
        out, scratch = tuple(planes[:2]), tuple(planes[2:])
        for step in _steps(h, w):
            nxt = jfa_pass(best_r, best_c, step, out, scratch)
            out = (best_r, best_c)
            best_r, best_c = nxt
    else:
        for step in _steps(h, w):
            best_r, best_c = (pass_fn or jfa_pass_plain)(best_r, best_c,
                                                         step)
    vec = torch.stack([best_r - rr, best_c - cc], dim=-1)
    d = _dist2(best_r, best_c, rr, cc)
    return d, torch.where((best_r <= _NONE)[..., None], 0, vec)


def euclidean_distance_transform(seeds, *, device="cuda"
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared-Euclidean distance transform by jump flooding. Returns (dist
    (H, W) float32 squared distance, R (H, W, 2) int32 displacement vectors
    to the closest seed; 1e9 and 0 where there is no seed at all). One K11
    launch a pass on the card."""
    return _jump_flood(_seed_mask(seeds, device))


# named instances matching the reference
d4 = partial(chamfer_distance_transform, metric="d4")
d8 = partial(chamfer_distance_transform, metric="d8")
d3_4 = partial(chamfer_distance_transform, metric="d3_4")
d5_7_11 = partial(chamfer_distance_transform, metric="d5_7_11")
