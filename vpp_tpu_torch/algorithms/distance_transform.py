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
  previous one left. On a CUDA mask the whole transform is kernel K11
  (``kernels/csrc/jfa.cu``, one cooperative launch: each pass as
  tile-local replays in shared memory, a grid barrier between passes;
  ``jfa_pass`` is the same kernel asked for one pass); on a CPU mask the
  passes are its plain version (``jfa_pass_plain``). Distances are float32
  sums of two squared int32 differences, the same operations everywhere,
  so the kernel, the plain version and the JAX package agree bit for bit,
  in the distances and in the displacement vectors. The card refuses an
  image whose squared diagonal reaches 1e9, the JAX loop's distance for
  "no candidate": past it the loop takes neighbours wrapped around the
  image.

A numpy mask goes to ``device`` (the card unless the caller asks for the
CPU); a tensor mask keeps its device.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache, partial
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


# K11's tiles (kernels/csrc/jfa.cu): a tile is Lr row residues x Tr lattice
# rows by Lc column residues x Tc lattice columns; its region, with a halo
# of 3 lattice points a side, within the region and ring sizes of the
# kernel's shape (``_jfa_shape``).
_JFA_HALO = 3
_JFA_SHAPES: Dict[int, Tuple[int, int, int]] = {}


def _jfa_shape(device: torch.device) -> Tuple[int, int, int]:
    """K11's tile shape as the kernel reports it on ``device``: (region
    points a tile at most, with its ring at most, CTAs the card holds at
    once)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _JFA_SHAPES:
        from ..kernels import _build
        shape = (ctypes.c_int * 3)()
        with torch.cuda.device(index):
            _build.check(_build.load().vpp_jfa_shape(shape), "jfa shape")
        _JFA_SHAPES[index] = tuple(shape)
    return _JFA_SHAPES[index]


def _axis_tiles(n: int, s: int, l: int, t: int) -> Tuple[int, int, int]:
    """One axis of a pass's tiles: (tiles, region lattice points summed
    over them, the largest region), residue blocks of ``l`` by lattice
    blocks of ``t`` as jfa.cu's ``axis_region`` cuts them."""
    count = total = most = 0
    for r0 in range(0, min(s, n), l):
        e = -(-(n - r0) // s)
        for t0 in range(0, e, t):
            size = min(t0 + t + _JFA_HALO, e) - max(t0 - _JFA_HALO, 0)
            count += 1
            total += size
            most = max(most, size)
    return count, total, most


@lru_cache(maxsize=None)
def _jfa_plan(h: int, w: int, s: int, shape: Tuple[int, int, int]
              ) -> Tuple[int, int, int, int]:
    """K11's tile for the pass at stride ``s`` on an (h, w) image: (log2
    Lr, Tr, log2 Lc, Tc) within ``shape`` (``_jfa_shape``). A cost model
    picks it: the waves of tiles over the card's CTA slots, each the
    largest region's points (the 8 steps' work, halo included) plus a
    fixed cost a tile, the loads dearer where fewer than 8 column residues
    share a 32-byte sector."""
    region, padded, slots = shape
    er, ec = -(-h // s), -(-w // s)
    best = None
    for lg_lc in range(min(s, w, 64).bit_length()):
        lc = 1 << lg_lc
        load = 1.0 + 0.25 * 8 / min(lc, 8)
        for lg_lr in range(min(s, h, 64).bit_length()):
            lr = 1 << lg_lr
            for tr in sorted(set(range(1, min(er, 64) + 1)) | {er}):
                # the widest region that fits, with and without its ring
                rr = min(tr + 2 * _JFA_HALO, er)
                rc = min(region // (lr * lc * rr),
                         padded // (lr * lc * (rr + 2)) - 2)
                tc = ec if rc >= ec else rc - 2 * _JFA_HALO
                if tc < 1:
                    continue
                nr, sr, mr = _axis_tiles(h, s, lr, tr)
                nc, sc, mc = _axis_tiles(w, s, lc, tc)
                waves = -(-nr * nc // slots)
                cost = max(waves * (256 + mr * lr * mc * lc * load),
                           sr * lr * sc * lc * load / slots)
                if best is None or cost < best[0]:
                    best = (cost, (lg_lr, tr, lg_lc, tc))
    return best[1]


def _jfa_rows(h: int, w: int, steps: Sequence[int],
              shape: Tuple[int, int, int]):
    """K11's plan as the C entry takes it: (s, log2 Lr, Tr, log2 Lc, Tc) a
    pass. A stride at or beyond both sides leaves every pixel as it is, as
    does any stride there, so it is taken as max(h, w)."""
    rows = []
    for s in steps:
        s = min(s, max(h, w))
        rows += [s, *_jfa_plan(h, w, s, shape)]
    return rows


@lru_cache(maxsize=64)
def _jfa_plan_array(h: int, w: int, steps: Tuple[int, ...],
                    shape: Tuple[int, int, int]):
    rows = _jfa_rows(h, w, steps, shape)
    return (ctypes.c_int * len(rows))(*rows)


def _launch_k11(h: int, w: int, steps: Tuple[int, ...], src, out,
                scratch=(None, None), mask=None) -> None:
    """One K11 launch: the passes at ``steps`` from ``mask`` or the (r, c)
    planes ``src`` into ``out``: two int32 planes, or (dist, vec);
    ``scratch``: two (h, w, 2) float32 planes between passes."""
    if (h - 1) ** 2 + (w - 1) ** 2 >= _INF:
        # the JAX loop's "no candidate" distance is 1e9: past it, it takes
        # neighbours wrapped around the image
        raise ValueError(f"jfa: a {h}x{w} image; K11 takes images whose "
                         "squared diagonal is below 1e9")
    from ..kernels import _build

    def ptr(t):
        return None if t is None else t.data_ptr()

    planes = out if out[0].dtype == torch.int32 else (None, None)
    dist, vec = (None, None) if planes[0] is not None else out
    anchor = mask if mask is not None else src[0]
    code = _build.load().vpp_jfa(
        ptr(mask), ptr(src[0]), ptr(src[1]), h, w,
        _jfa_plan_array(h, w, steps, _jfa_shape(anchor.device)), len(steps),
        *map(ptr, scratch),
        ptr(planes[0]), ptr(planes[1]), ptr(dist), ptr(vec),
        stream_handle(anchor))
    LAUNCHES["jfa"] += 1
    _build.check(code, "jfa")


def jfa_pass(best_r: torch.Tensor, best_c: torch.Tensor, step: int,
             out=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11 asked for one jump-flooding pass: one launch, no grid barrier,
    into the ``out`` pair of planes (allocated when not given; it may not
    alias the input). The planes hold coordinates inside the image or the
    "none" marker, which the result holds in both planes. A CPU tensor
    takes ``jfa_pass_plain``."""
    if best_r.device.type == "cpu":
        return jfa_pass_plain(best_r, best_c, step)
    h, w = best_r.shape
    if out is None:
        out = (torch.empty_like(best_r), torch.empty_like(best_c))
    best_r, best_c = best_r.contiguous(), best_c.contiguous()
    require_cuda("jfa", best_r, best_c, *out, dtypes=(torch.int32,) * 4)
    _launch_k11(h, w, (int(step),), (best_r, best_c), out)
    return out


def jfa_transform(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11 on a CUDA bool mask: the whole transform in one cooperative
    launch (the seed init, every pass of ``_steps``, a grid barrier
    between passes, the distance and the vectors). Returns (dist, vec) as
    ``euclidean_distance_transform``."""
    mask = mask.contiguous()
    require_cuda("jfa", mask, dtypes=(torch.bool,))
    h, w = mask.shape
    steps = _steps(h, w)
    # vec and dist in one allocation (vec first: its int2 stores), the two
    # float2 scratch planes in another
    buf = torch.empty((3, h, w), dtype=torch.int32, device=mask.device)
    vec, dist = buf[:2].view(h, w, 2), buf[2].view(torch.float32)
    scratch = torch.empty((2, h, w, 2), dtype=torch.float32,
                          device=mask.device)
    _launch_k11(h, w, steps, (None, None), (dist, vec),
                scratch=tuple(scratch), mask=mask)
    return dist, vec


def _jump_flood(mask: torch.Tensor, pass_fn=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jump flooding from a bool mask: K11's one launch on a CUDA mask
    when ``pass_fn`` is None; else the passes through ``pass_fn``
    (``jfa_pass_plain`` when None), then the squared distance and the
    vectors from the final coordinates."""
    if pass_fn is None and mask.device.type == "cuda":
        return jfa_transform(mask)
    h, w = mask.shape
    dev = mask.device
    rr = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    cc = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    none = torch.full((h, w), _NONE, dtype=torch.int32, device=dev)
    best_r = torch.where(mask, rr, none)
    best_c = torch.where(mask, cc, none)
    for step in _steps(h, w):
        best_r, best_c = (pass_fn or jfa_pass_plain)(best_r, best_c, step)
    vec = torch.stack([best_r - rr, best_c - cc], dim=-1)
    d = _dist2(best_r, best_c, rr, cc)
    return d, torch.where((best_r <= _NONE)[..., None], 0, vec)


def euclidean_distance_transform(seeds, *, device="cuda"
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared-Euclidean distance transform by jump flooding. Returns (dist
    (H, W) float32 squared distance, R (H, W, 2) int32 displacement vectors
    to the closest seed; 1e9 and 0 where there is no seed at all). One K11
    launch a transform on the card."""
    return _jump_flood(_seed_mask(seeds, device))


# named instances matching the reference
d4 = partial(chamfer_distance_transform, metric="d4")
d8 = partial(chamfer_distance_transform, metric="d8")
d3_4 = partial(chamfer_distance_transform, metric="d3_4")
d5_7_11 = partial(chamfer_distance_transform, metric="d5_7_11")
