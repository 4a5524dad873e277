"""Semi-dense optical flow (port of ``vpp_tpu.algorithms.flow``).

Coarse-to-fine over ``nscales`` pyramid levels, with the flow living on a
patch grid (one cell per ``patchsize``² pixels). Each level matches every
cell against a dense (2R+1)² window of displacements around the upsampled
coarser prediction (``flow_match``), keeps the first minimum of the window
SADs in displacement-table order, rejects out-of-domain targets, and then
runs Jacobi propagation passes that adopt a neighbour's flow where the
cost volume scores it strictly better (``flow_propagate``).

Numerics follow the JAX package: the level buffers are rounded to bf16,
|diff| is rounded to bf16 after the subtraction, window sums accumulate in
float32. The level is kernel K1 (``kernels/csrc/flow_level.cu``):
``flow_match`` and ``flow_propagate`` launch it for CUDA tensors and run
their plain versions for CPU ones.

The epipolar-constrained branch (``epipolar_flow`` / ``epipolar_filter``
with a fundamental matrix) is not ported yet and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.image import Image2d, pad2d
from ..kernels import LAUNCHES, require_cuda, stream_handle
from .pyramid import Pyramid, level_shapes, pyramid

_INF = 1e30

_C8 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


@dataclasses.dataclass
class _Level:
    flow: torch.Tensor   # (gh, gw, 2) int32 — displacement per cell
    dist: torch.Tensor   # (gh, gw) float32
    mark: torch.Tensor   # (gh, gw) bool — cell holds >= 1 live keypoint


@dataclasses.dataclass(frozen=True)
class LevelGeometry:
    """Static shape of one level's match: buffer border ``b`` around an
    ``h`` x ``w`` domain, ``ws``² windows on a ``gh`` x ``gw`` grid of
    ``patch`` px cells, search radius ``R``, warp clip ``pred_bound``."""
    b: int
    h: int
    w: int
    ws: int
    patch: int
    gh: int
    gw: int
    R: int
    pred_bound: int


def _displacement_table(R: int) -> Tuple[np.ndarray, list]:
    """Displacements ordered smallest-magnitude-first, so that the argmin's
    first-minimum tie-break prefers staying."""
    ds = [(dr, dc) for dr in range(-R, R + 1) for dc in range(-R, R + 1)]
    ds.sort(key=lambda d: (max(abs(d[0]), abs(d[1])),
                           abs(d[0]) + abs(d[1]), d))
    return np.array(ds, np.int32), ds


def _flat_to_k(R: int) -> np.ndarray:
    """Row-major displacement id ((dr+R)*(2R+1)+(dc+R)) -> table index."""
    _, offsets = _displacement_table(R)
    dd = 2 * R + 1
    inv = np.zeros((dd * dd,), np.int32)
    for k, (dr, dc) in enumerate(offsets):
        inv[(dr + R) * dd + (dc + R)] = k
    return inv


_TABLES: Dict[Tuple[int, str, torch.device], torch.Tensor] = {}


def _table(R: int, which: str, device: torch.device) -> torch.Tensor:
    """Device-resident displacement tables, made once per device (so the
    per-frame path does no host-to-device copy)."""
    key = (R, which, torch.device(device))
    if key not in _TABLES:
        arr = (_displacement_table(R)[0] if which == "disp"
               else _flat_to_k(R))
        _TABLES[key] = torch.from_numpy(arr).to(device)
    return _TABLES[key]


# -- plain PyTorch version of K1 ------------------------------------------

def _cells_to_pixels(cell_vals: torch.Tensor, b: int, h: int, w: int,
                     patch: int, hb: int, wb: int) -> torch.Tensor:
    """Broadcast a (gh, gw) per-cell value to the (hb, wb) pixel buffer
    (patch-block repeat, crop to the domain, edge padding)."""
    px = cell_vals.repeat_interleave(patch, 0).repeat_interleave(patch, 1)
    px = px[:h, :w]
    ph, pw = px.shape
    return pad2d(px, b, hb - b - ph, b, wb - b - pw, "edge")


def _warp_by_cell_flow(a2: torch.Tensor, pred: torch.Tensor, b: int, h: int,
                       w: int, patch: int, max_shift: int) -> torch.Tensor:
    """Backward-warp the buffer by per-cell integer flow: per axis a select
    over rolled copies (even shifts in ±max_shift, wrapping like jnp.roll);
    the column pass reads the row-warped buffer."""
    s = pred.clamp(-max_shift, max_shift)
    hb, wb = a2.shape
    out = a2
    for axis in (0, 1):
        digit = _cells_to_pixels(s[..., axis], b, h, w, patch, hb, wb)
        sel = out
        for k in range(-max_shift, max_shift + 1, 2):
            if k == 0:
                continue
            sel = torch.where(digit == k, torch.roll(out, -k, dims=axis), sel)
        out = sel
    return out


def _cost_volume(a1: torch.Tensor, a2w: torch.Tensor, g: LevelGeometry,
                 offsets: list) -> torch.Tensor:
    """(D², gh, gw) SAD volume of bf16 |diffs| summed in float32; buffers
    are edge-padded where a displaced window would leave them."""
    off = g.ws // 2 - g.patch // 2
    r0 = g.b - off
    lr = (g.gh - 1) * g.patch + g.ws
    lc = (g.gw - 1) * g.patch + g.ws
    hb, wb = a1.shape
    pt = pl = max(0, g.R - r0)
    pbot = max(0, r0 + lr + g.R - hb)
    pright = max(0, r0 + lc + g.R - wb)
    if pt or pbot or pl or pright:
        a1 = pad2d(a1, pt, pbot, pl, pright, "edge")
        a2w = pad2d(a2w, pt, pbot, pl, pright, "edge")
    r0r, c0c = r0 + pt, r0 + pl
    base = a1[r0r:r0r + lr, c0c:c0c + lc]
    diff = torch.stack([
        (base - a2w[r0r + dr:r0r + dr + lr, c0c + dc:c0c + dc + lc]).abs()
        for dr, dc in offsets]).to(torch.float32)
    win = diff.unfold(1, g.ws, g.patch).unfold(2, g.ws, g.patch)
    return win.sum(dim=(-2, -1))


def _reject_out_of_domain(flow: torch.Tensor, dist: torch.Tensor,
                          pred: torch.Tensor, g: LevelGeometry):
    """Keep ``pred`` and an infinite distance where the matched window
    centre leaves the level domain."""
    dev = flow.device
    ctr_r = torch.arange(g.gh, device=dev)[:, None] * g.patch + g.patch // 2
    ctr_c = torch.arange(g.gw, device=dev)[None, :] * g.patch + g.patch // 2
    tgt_r = ctr_r + flow[..., 0]
    tgt_c = ctr_c + flow[..., 1]
    in_dom = ((tgt_r >= 0) & (tgt_r <= g.h - 1) &
              (tgt_c >= 0) & (tgt_c <= g.w - 1))
    flow = torch.where(in_dom[..., None], flow, pred)
    dist = torch.where(in_dom, dist, torch.full_like(dist, _INF))
    return flow, dist


def flow_match_plain(a1: torch.Tensor, a2: torch.Tensor, pred: torch.Tensor,
                     g: LevelGeometry
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the level launch of K1: warp, cost volume, ordered
    argmin, in-domain rejection. Returns (flow, dist, volume)."""
    _, offsets = _displacement_table(g.R)
    a1 = a1.to(torch.bfloat16)
    a2 = a2.to(torch.bfloat16)
    a2w = a2 if g.pred_bound == 0 else _warp_by_cell_flow(
        a2, pred, g.b, g.h, g.w, g.patch, g.pred_bound)
    vol = _cost_volume(a1, a2w, g, offsets)
    best = torch.argmin(vol, dim=0)                # first minimum
    dist = torch.gather(vol, 0, best[None]).squeeze(0)
    delta = _table(g.R, "disp", vol.device)[best]
    flow, dist = _reject_out_of_domain(pred + delta, dist, pred, g)
    return flow.to(torch.int32), dist, vol


def _volume_lookup(vol: torch.Tensor, q: torch.Tensor,
                   R: int) -> torch.Tensor:
    """Cost at per-cell displacement q ((gh, gw, 2), relative to the
    volume's centre); out-of-window q → +inf."""
    dd = 2 * R + 1
    inside = ((q[..., 0] >= -R) & (q[..., 0] <= R) &
              (q[..., 1] >= -R) & (q[..., 1] <= R))
    qflat = ((q[..., 0].clamp(-R, R) + R) * dd + (q[..., 1].clamp(-R, R) + R))
    k = _table(R, "flat_to_k", vol.device)[qflat.long()]
    val = torch.gather(vol, 0, k[None].long()).squeeze(0)
    return torch.where(inside, val, torch.full_like(val, _INF))


def flow_propagate_plain(flow: torch.Tensor, dist: torch.Tensor,
                         pred: torch.Tensor, vol: torch.Tensor,
                         R: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of one Jacobi propagation pass of K1: each cell scores
    its 8 neighbours' flows (``_C8`` order, strict <) against its volume
    and adopts the best one that differs by more than 2 px."""
    gh, gw = dist.shape
    dev = flow.device
    best_nf, best_nd = flow, dist
    for dr, dc in _C8:
        nf = torch.roll(flow, (-dr, -dc), dims=(0, 1))
        rr = torch.arange(gh, device=dev)[:, None] + dr
        cc = torch.arange(gw, device=dev)[None, :] + dc
        inside = (rr >= 0) & (rr < gh) & (cc >= 0) & (cc < gw)
        cand_d = _volume_lookup(vol, nf - pred, R)
        far = ((flow - nf) ** 2).sum(-1) > 4
        ok = inside & far & (cand_d < best_nd)
        best_nf = torch.where(ok[..., None], nf, best_nf)
        best_nd = torch.where(ok, cand_d, best_nd)
    return best_nf, best_nd


# -- K1 wrappers ------------------------------------------------------------

def flow_match(a1: torch.Tensor, a2: torch.Tensor, pred: torch.Tensor,
               g: LevelGeometry
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 level launch on CUDA tensors (the plain version on CPU ones).
    a1, a2: (hb, wb) float32 level buffers; pred: (gh, gw, 2) int32.
    Returns (flow (gh, gw, 2) int32, dist (gh, gw) f32, vol (D², gh, gw))."""
    if a1.device.type == "cpu":
        return flow_match_plain(a1, a2, pred, g)
    a1 = a1.to(torch.float32).contiguous()
    a2 = a2.to(torch.float32).contiguous()
    pred = pred.to(torch.int32).contiguous()
    require_cuda("flow_match", a1, a2, pred,
                 dtypes=(torch.float32, torch.float32, torch.int32))
    if a1.shape != a2.shape or tuple(pred.shape) != (g.gh, g.gw, 2):
        raise ValueError(f"flow_match: shapes {a1.shape}, {a2.shape}, "
                         f"{pred.shape} do not fit {g}")
    d2 = (2 * g.R + 1) ** 2
    if d2 > 1024:
        raise ValueError(f"flow_match: radius {g.R} exceeds the kernel's "
                         "1024 displacements")
    from ..kernels import _build
    lib = _build.load()
    dev = a1.device
    disp = _table(g.R, "disp", dev)
    flow = torch.empty((g.gh, g.gw, 2), dtype=torch.int32, device=dev)
    dist = torch.empty((g.gh, g.gw), dtype=torch.float32, device=dev)
    vol = torch.empty((d2, g.gh, g.gw), dtype=torch.float32, device=dev)
    hb, wb = a1.shape
    code = lib.vpp_flow_level(
        a1.data_ptr(), a2.data_ptr(), pred.data_ptr(), disp.data_ptr(), d2,
        hb, wb, g.b, g.h, g.w, g.ws, g.patch, g.gh, g.gw, g.pred_bound,
        flow.data_ptr(), dist.data_ptr(), vol.data_ptr(), stream_handle(a1))
    LAUNCHES["flow_level"] += 1
    _build.check(code, "flow_match")
    return flow, dist, vol


def flow_propagate(flow: torch.Tensor, dist: torch.Tensor,
                   pred: torch.Tensor, vol: torch.Tensor,
                   R: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K1 propagation pass on CUDA tensors (plain version on CPU ones);
    reads ``flow``/``dist`` and writes fresh buffers (Jacobi)."""
    if flow.device.type == "cpu":
        return flow_propagate_plain(flow, dist, pred, vol, R)
    require_cuda("flow_propagate", flow, dist, pred, vol,
                 dtypes=(torch.int32, torch.float32, torch.int32,
                         torch.float32))
    gh, gw = dist.shape
    if (tuple(flow.shape) != (gh, gw, 2) or pred.shape != flow.shape
            or tuple(vol.shape) != ((2 * R + 1) ** 2, gh, gw)):
        raise ValueError("flow_propagate: inconsistent shapes")
    from ..kernels import _build
    lib = _build.load()
    flat_to_k = _table(R, "flat_to_k", flow.device)
    flow_out = torch.empty_like(flow)
    dist_out = torch.empty_like(dist)
    code = lib.vpp_flow_propagate(
        flow.data_ptr(), dist.data_ptr(), pred.data_ptr(), vol.data_ptr(),
        flat_to_k.data_ptr(), gh, gw, R, flow_out.data_ptr(),
        dist_out.data_ptr(), stream_handle(flow))
    LAUNCHES["flow_level"] += 1
    _build.check(code, "flow_propagate")
    return flow_out, dist_out


def flow_level(a1: torch.Tensor, a2: torch.Tensor, pred: torch.Tensor,
               g: LevelGeometry, prop_iters: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level (``_flow_level_xla``): match, then ``prop_iters`` Jacobi
    passes. Returns (flow (gh, gw, 2) int32, dist (gh, gw) f32)."""
    flow, dist, vol = flow_match(a1, a2, pred, g)
    for _ in range(prop_iters):
        flow, dist = flow_propagate(flow, dist, pred, vol, g.R)
    return flow, dist


def _level_radii(nscales: int, R_top: int, refine: int) -> list:
    """The top level searches ±R_top; finer levels refine by ±refine."""
    return [refine if s < nscales - 1 else R_top for s in range(nscales)]


def _level_bounds(nscales: int, radii: list) -> list:
    """Per-level total-flow envelope |flow_s| (clips the warp)."""
    bounds = [0] * nscales
    bounds[nscales - 1] = radii[nscales - 1]
    for s in range(nscales - 2, -1, -1):
        bounds[s] = 2 * bounds[s + 1] + radii[s]
    return bounds


def semi_dense_optical_flow(
        positions: torch.Tensor, valid: torch.Tensor,
        i1: Image2d, i2: Image2d, *,
        winsize: int = 7, nscales: int = 4, min_scale: int = 0,
        propagation: int = 2, patchsize: int = 5,
        search_niters: int = 5,
        fundamental_matrix: Optional[torch.Tensor] = None,
        epipolar_flow: bool = False, epipolar_steps: int = 8,
        epipolar_filter: Optional[float] = None,
        pyr1: Optional[Pyramid] = None, pyr2: Optional[Pyramid] = None,
        refine_radius: Optional[int] = 1,
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Track (K, 2) float keypoint ``positions`` from i1 to i2.

    Returns (match_positions (K, 2) float32, distance (K,) float32,
    matched (K,) bool); options and defaults are the JAX package's.
    ``pyr1``/``pyr2`` reuse prebuilt pyramids."""
    if fundamental_matrix is not None and (epipolar_flow
                                           or epipolar_filter is not None):
        raise NotImplementedError(
            "vpp_tpu_torch: the epipolar flow branch is not ported yet")
    h0, w0 = i1.shape
    border = max(3, winsize)
    if pyr1 is None:
        pyr1 = pyramid(i1, nscales, border=border)
    if pyr2 is None:
        pyr2 = pyramid(i2, nscales, border=border)
    grid_shapes = level_shapes((max(h0 // patchsize, 1),
                                max(w0 // patchsize, 1)), nscales)
    levels: List[Optional[_Level]] = [None] * nscales
    b = pyr1[0].border
    R_top = max(1, search_niters)
    radii = _level_radii(nscales, R_top,
                         R_top if refine_radius is None
                         else max(1, min(refine_radius, R_top)))
    bounds = _level_bounds(nscales, radii)
    dev = positions.device

    for s in range(nscales - 1, min_scale - 1, -1):
        a1 = pyr1[s].data.to(torch.float32)
        a2 = pyr2[s].data.to(torch.float32)
        h, w = pyr1[s].shape
        gh, gw = grid_shapes[s]

        # occupancy mark: only the readout level's is consumed
        if s == min_scale:
            pos_s = torch.floor(positions / float(2 ** s)).to(torch.int32)
            cr = (pos_s[:, 0].clamp(0, h - 1) // patchsize).clamp(0, gh - 1)
            cc = (pos_s[:, 1].clamp(0, w - 1) // patchsize).clamp(0, gw - 1)
            cell_flat = torch.where(valid, cr * gw + cc,
                                    torch.full_like(cr, gh * gw))
            occ = torch.zeros((gh * gw + 1,), dtype=torch.bool, device=dev)
            # slot gh*gw takes the dropped entries; index_fill_ keeps the
            # fill value off the host (an indexed assignment would copy it)
            occ.index_fill_(0, cell_flat.long(), True)
            mark = occ[:gh * gw].view(gh, gw)
        else:
            mark = torch.zeros((gh, gw), dtype=torch.bool, device=dev)

        # multiscale prediction: upsampled coarse flow x2
        if s < nscales - 1 and levels[s + 1] is not None:
            cgh, cgw = grid_shapes[s + 1]
            ir = (torch.arange(gh, device=dev) // 2).clamp(0, cgh - 1)
            ic = (torch.arange(gw, device=dev) // 2).clamp(0, cgw - 1)
            pred = 2 * levels[s + 1].flow[ir[:, None], ic[None, :]]
        else:
            pred = torch.zeros((gh, gw, 2), dtype=torch.int32, device=dev)

        g = LevelGeometry(b=b, h=h, w=w, ws=winsize, patch=patchsize,
                          gh=gh, gw=gw, R=radii[s],
                          pred_bound=0 if s == nscales - 1
                          else 2 * bounds[s + 1])
        flow, dist = flow_level(a1, a2, pred, g, propagation)
        levels[s] = _Level(flow=flow, dist=dist, mark=mark)

    # final per-keypoint readout
    lvl = levels[min_scale]
    gh, gw = grid_shapes[min_scale]
    cell_div = patchsize * (2 ** min_scale)
    c = torch.floor(positions / cell_div).to(torch.int32)
    c0 = c[:, 0].clamp(0, gh - 1).long()
    c1 = c[:, 1].clamp(0, gw - 1).long()
    matched = valid & lvl.mark[c0, c1]
    f = (lvl.flow[c0, c1] * (2 ** min_scale)).to(torch.float32)
    return positions + f, lvl.dist[c0, c1], matched


def dense_optical_flow(i1: Image2d, i2: Image2d, *, winsize: int = 7,
                       nscales: int = 4, patchsize: int = 5,
                       propagation: int = 2, search_niters: int = 5
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-grid flow field: (flow (gh, gw, 2) float32 pixel displacements
    at patch-grid resolution, distance (gh, gw))."""
    h, w = i1.shape
    dev = i1.device
    gh, gw = max(h // patchsize, 1), max(w // patchsize, 1)
    rr = (torch.arange(gh, device=dev) * patchsize
          + patchsize // 2).to(torch.float32)
    cc = (torch.arange(gw, device=dev) * patchsize
          + patchsize // 2).to(torch.float32)
    pos = torch.stack(torch.meshgrid(rr, cc, indexing="ij"),
                      dim=-1).reshape(-1, 2)
    valid = torch.ones((pos.shape[0],), dtype=torch.bool, device=dev)
    match, dist, _ = semi_dense_optical_flow(
        pos, valid, i1, i2, winsize=winsize, nscales=nscales,
        patchsize=patchsize, propagation=propagation,
        search_niters=search_niters)
    return (match - pos).reshape(gh, gw, 2), dist.reshape(gh, gw)
