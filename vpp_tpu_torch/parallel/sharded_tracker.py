"""Column-sharded tracker front end (port of
``vpp_tpu.parallel.sharded_tracker``).

The frame's columns shard over a mesh axis; every rank runs the whole
tracker pipeline (pyramids, FAST, semi-dense flow, lifecycle) for the
columns it owns, reading a column halo exchanged once a frame with its ring
neighbours. The keypoint state is replicated and combined with
owner-exclusive all-reduces: each keypoint's cell has one owner, so the sum
is a select. Every rank calls these functions with the global frames and the
replicated state (``parallel/mesh.py``'s convention) and takes its own
columns.

Exactness, as in the JAX package: away from the right image margin the
sharded flow equals ``semi_dense_optical_flow`` bit for bit, since the halo
makes every owned cell's cost volume, ordered argmin and propagation see the
data the global computation sees. The two deviations are the JAX module's:
the global grid chain's ``1 + g//2`` overhang column at the right edge is
not reproduced, and the warp's roll-wrap junk wraps over the local slice
instead of the whole image (it only feeds rejected cells).

Kernels: the pyramids of both frames' halo-extended slices are one K4
launch (two streams); each level is K1 with the slice's column origin
(``LevelGeometry.col0``, ``w_total``), two launches; the cull and the
detection's score image are K2 on the extended slice. The per-block argmax
of the owned columns, the candidate all-gather and the global top-K are
plain PyTorch (a few thousand candidates). A CPU frame takes every kernel's
plain version.

Requirements: W divisible by the axis size; the shard width divisible by
``patch * 2^(nscales-1)`` and by ``keypoint_spacing``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from ..algorithms import flow as F
from ..algorithms.fast import _block_argmax, cull_scores, score_image
from ..algorithms.pyramid import _k4_streams, _plain_levels, level_shapes
from ..algorithms.video_extruder import (VideoExtruderState,
                                         _merge_collided, _occupancy_mask,
                                         _with_trajectories)
from ..core.keypoints import kp_add, kp_kill_where, kp_move_all
from .mesh import (Mesh, all_gather_stack, all_reduce_sum, exchange_cols,
                   shard_image_cols)


def flow_halo(winsize: int, nscales: int, patchsize: int,
              propagation: int, search_niters: int,
              conservative: bool = False) -> int:
    """Static column halo (px, level 0) that makes every owned cell's
    flow computation exact: covers the worst-case sample reach
    (multiscale prediction + search window) plus the propagation travel
    and a safety margin, rounded up to the alignment unit
    ``patch * 2^(nscales-1)`` (which also keeps pyramid decimation and
    patch grids aligned across shard origins). Sized for the full-radius
    envelope (refine_radius <= search_niters only shrinks the reach).

    Propagation travel: each Jacobi sweep at level s moves influence one
    cell = ``patchsize * 2^s`` level-0 px, so the WORST-CASE total over
    all levels is ``propagation * patchsize * (2^nscales - 1)``
    (``conservative=True`` sizes for it). The default uses one finest-
    level cell of travel instead: an adoption chain only propagates
    while each hop strictly improves the SAD of a window already inside
    the halo, and the bit-exact equivalence tests pin the default as
    sufficient for the shipped configs (nscales <= 3, propagation <= 2).
    For deeper pyramids or more sweeps, pass ``conservative=True``."""
    R = max(1, search_niters)
    unit = patchsize * 2 ** (nscales - 1)
    prop_px = propagation * patchsize
    if conservative:
        prop_px *= 2 ** nscales - 1
    need = R * (2 ** nscales - 1) + winsize + prop_px + 8
    return unit * -(-need // unit)


def needs_conservative_halo(nscales: int, propagation: int) -> bool:
    """True outside the empirically-pinned default-halo envelope
    (``flow_halo`` docstring): the bit-exactness suite validates the
    one-finest-cell propagation-travel sizing only for nscales <= 3,
    propagation <= 2. ``_flow_locals`` auto-switches to the conservative
    (worst-case-travel) halo beyond it, so no caller can silently lose
    exactness by picking a deeper pyramid or more sweeps."""
    return nscales > 3 or propagation > 2


def _halo_exchange_open(local: torch.Tensor, halo: int, mesh: Mesh,
                        axis: str, fill_left: torch.Tensor,
                        fill_right: torch.Tensor) -> torch.Tensor:
    """``halo`` columns from each ring neighbour on both sides of (..., H,
    wl) slices; the outermost ranks take ``fill_*`` instead (open
    boundary), and send nothing past the edge."""
    from_left, from_right = exchange_cols(local[..., -halo:],
                                          local[..., :halo], mesh, axis,
                                          wrap=False)
    return torch.cat([fill_left if from_left is None else from_left, local,
                      fill_right if from_right is None else from_right],
                     dim=-1)


def _edge_fill(local: torch.Tensor, halo: int, border: int,
               left: bool) -> torch.Tensor:
    """What the global computation holds beyond the image edge: ``border``
    mirrored columns, then edge replication (the global buffer is
    mirror-padded by ``border`` and the cost volume edge-pads past that)."""
    if left:
        mir = local[..., :border].flip(-1)             # cols -border..-1
        edge = mir[..., :1].expand(mir.shape[:-1] + (halo - border,))
        return torch.cat([edge, mir], dim=-1)
    mir = local[..., -border:].flip(-1)
    edge = mir[..., -1:].expand(mir.shape[:-1] + (halo - border,))
    return torch.cat([mir, edge], dim=-1)


def _ext_pyramid(ext: torch.Tensor, border: int,
                 shapes: Tuple[Tuple[int, int], ...]
                 ) -> Tuple[torch.Tensor, ...]:
    """Pyramids of halo-extended slices (S, H, we) at ``shapes``: rows
    follow the global level chain (they are unsharded, the ``1+h//2``
    overhang row included), columns halve exactly (the slice is interior
    data). Each level one (S, h + 2b, w + 2b) buffer, padded symmetric:
    one K4 launch for a float32 CUDA slice, the plain chain otherwise."""
    if ext.device.type == "cuda":
        return _k4_streams(ext, shapes, border, first=0)
    return _plain_levels(ext, shapes, border)


@dataclasses.dataclass(frozen=True)
class _FlowGeom:
    """What one rank's sharded flow derives from (mesh, shape, config):
    the slice and halo, each level's geometry (the slice's column origin
    in it), and the extended slice's level and grid shapes."""
    h0: int
    w0: int
    wl: int
    halo: int
    border: int
    g0: int
    levels: Tuple[F.LevelGeometry, ...]
    ext_shapes: Tuple[Tuple[int, int], ...]
    grid0: Tuple[int, int]
    propagation: int

    def as_dict(self) -> dict:
        return dict(h0=self.h0, w0=self.w0, wl=self.wl, halo=self.halo,
                    border=self.border)


@functools.lru_cache(maxsize=32)
def _flow_geometry(n: int, rank: int, shape: Tuple[int, int],
                   winsize: int, nscales: int, propagation: int,
                   patchsize: int, search_niters: int,
                   refine_radius) -> _FlowGeom:
    """The geometry of rank ``rank`` of ``n`` along the column axis."""
    h0, w0 = shape
    wl = w0 // n
    border = max(3, winsize)
    halo = flow_halo(winsize, nscales, patchsize, propagation,
                     search_niters,
                     conservative=needs_conservative_halo(nscales,
                                                          propagation))
    unit = patchsize * 2 ** (nscales - 1)
    if w0 % n or wl % unit:
        raise ValueError(f"shard width {w0}/{n} must be a whole number "
                         f"divisible by {unit}")
    R_top = max(1, search_niters)
    radii = F._level_radii(nscales, R_top,
                           R_top if refine_radius is None
                           else max(1, min(refine_radius, R_top)))
    bounds = F._level_bounds(nscales, radii)
    lvl_shapes = level_shapes((h0, w0), nscales)
    grid_shapes = level_shapes((max(h0 // patchsize, 1),
                                max(w0 // patchsize, 1)), nscales)
    g0 = rank * wl
    levels, ext_shapes = [], []
    for s in range(nscales):
        we_s = (wl + 2 * halo) // 2 ** s
        ext_shapes.append((lvl_shapes[s][0], we_s))
        levels.append(F.LevelGeometry(
            b=border, h=lvl_shapes[s][0], w=we_s, ws=winsize,
            patch=patchsize, gh=grid_shapes[s][0], gw=we_s // patchsize,
            R=radii[s],
            pred_bound=0 if s == nscales - 1 else 2 * bounds[s + 1],
            col0=(g0 - halo) // 2 ** s, w_total=lvl_shapes[s][1]))
    return _FlowGeom(h0=h0, w0=w0, wl=wl, halo=halo, border=border, g0=g0,
                     levels=tuple(levels), ext_shapes=tuple(ext_shapes),
                     grid0=grid_shapes[0], propagation=propagation)


def _flow_locals(mesh: Mesh, axis: str, shape: Tuple[int, int],
                 winsize: int, nscales: int, propagation: int,
                 patchsize: int, search_niters: int, refine_radius):
    """The per-rank flow body shared by the sharded flow and the sharded
    update. Returns (local_flow, geom) where ``local_flow(f1l, f2l, pos,
    val) -> (match, dist, matched, ext2)`` takes this rank's column slices
    of both frames, (match, dist, matched) replicated after one
    all-reduce and ``ext2`` the rank's halo-extended frame-2 level 0 (a
    bordered buffer) for the later local stages; ``geom`` is the dict of
    derived geometry constants. The geometry is cached per (axis size,
    rank, shape, config): a frame adds no host work for it."""
    geo = _flow_geometry(mesh.size(axis), mesh.get_local_rank(axis),
                         tuple(shape), winsize, nscales, propagation,
                         patchsize, search_niters, refine_radius)
    return functools.partial(_local_flow, mesh, axis, geo), geo.as_dict()


def _extend(frames: torch.Tensor, geo: _FlowGeom, mesh: Mesh,
            axis: str) -> torch.Tensor:
    """Halo-extended slices of (S, H, wl) frame slices: the one-hop ring
    exchange when the halo fits in a neighbour's shard, else an all-gather
    of every slice and a cut (narrow shards)."""
    halo, border, wl = geo.halo, geo.border, geo.wl
    if halo <= wl:
        return _halo_exchange_open(
            frames, halo, mesh, axis, _edge_fill(frames, halo, border, True),
            _edge_fill(frames, halo, border, False))
    parts = all_gather_stack(frames, mesh, axis)      # (n, S, H, wl)
    glob = torch.cat(tuple(parts), dim=-1)
    padded = torch.cat([_edge_fill(glob, halo, border, True), glob,
                        _edge_fill(glob, halo, border, False)], dim=-1)
    return padded[..., geo.g0:geo.g0 + wl + 2 * halo]


def _local_flow(mesh: Mesh, axis: str, geo: _FlowGeom, f1l: torch.Tensor,
                f2l: torch.Tensor, pos: torch.Tensor, val: torch.Tensor):
    ext = _extend(torch.stack([f1l, f2l]).to(torch.float32), geo, mesh,
                  axis)
    pyr = _ext_pyramid(ext, geo.border, geo.ext_shapes)
    dev = pos.device
    flow = None
    for s in range(len(geo.levels) - 1, -1, -1):
        g = geo.levels[s]
        if flow is None:
            pred = torch.zeros((g.gh, g.gw, 2), dtype=torch.int32,
                               device=dev)
        else:
            cgh = geo.levels[s + 1].gh
            ir = (torch.arange(g.gh, device=dev) // 2).clamp(0, cgh - 1)
            ic = torch.arange(g.gw, device=dev) // 2       # exact halving
            pred = 2 * flow[ir[:, None], ic[None, :]]
        flow, dist = F.flow_level(pyr[s][0], pyr[s][1], pred, g,
                                  geo.propagation)

    # readout of the keypoints whose cell this rank owns (the single-device
    # readout's cell arithmetic)
    patch = geo.levels[0].patch
    gh0, gw0 = geo.grid0
    gwl = geo.wl // patch
    c = torch.floor(pos / patch).to(torch.int32)
    cr = c[:, 0].clamp(0, gh0 - 1)
    cell_c = c[:, 1].clamp(0, gw0 - 1)
    lo = geo.g0 // patch
    own = (cell_c >= lo) & (cell_c < lo + gwl)
    cc = (cell_c - (geo.g0 - geo.halo) // patch).clamp(0, flow.shape[1] - 1)
    cr, cc = cr.long(), cc.long()
    match_pos = pos + flow[cr, cc].to(torch.float32)
    zero = torch.zeros_like(match_pos[:, 0])
    # one owner per keypoint: the sum is a select, one all-reduce for all
    packed = torch.stack([torch.where(own, match_pos[:, 0], zero),
                          torch.where(own, match_pos[:, 1], zero),
                          torch.where(own, dist[cr, cc], zero),
                          (val & own).to(torch.float32)], dim=-1)
    packed = all_reduce_sum(packed, mesh, axis)
    return packed[:, :2], packed[:, 2], packed[:, 3] > 0, pyr[0][1]


def sharded_semi_dense_flow(
        mesh: Mesh, positions: torch.Tensor, valid: torch.Tensor,
        frame1: torch.Tensor, frame2: torch.Tensor, *,
        winsize: int = 7, nscales: int = 4, propagation: int = 2,
        patchsize: int = 5, search_niters: int = 5, axis: str = "sp",
        refine_radius: int = 1,
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Column-sharded ``semi_dense_optical_flow``.

    ``frame1``/``frame2``: (H, W) global grayscale frames and ``positions``
    (K, 2) global float keypoints, the same on every rank. Returns the
    single-device API's (match_positions, distance, matched) on every
    rank."""
    local_flow, _ = _flow_locals(mesh, axis, tuple(frame1.shape), winsize,
                                 nscales, propagation, patchsize,
                                 search_niters, refine_radius)
    m, d, ok, _ = local_flow(shard_image_cols(mesh, frame1, axis),
                             shard_image_cols(mesh, frame2, axis),
                             positions, valid)
    return m, d, ok


def sharded_video_extruder_update(mesh: Mesh, state: VideoExtruderState,
                                  frame1: torch.Tensor,
                                  frame2: torch.Tensor, cfg,
                                  axis: str = "sp") -> VideoExtruderState:
    """Column-sharded ``video_extruder_update``, the whole tracker step:
    per-rank semi-dense flow (halo-exact), per-rank FAST cull and blockwise
    detection on the owned columns, and the replicated keypoint lifecycle.

    ``frame1``/``frame2`` are (H, W) global frames and ``state`` the
    replicated tracker state, the same on every rank. Image-reading stages
    run on the rank's extended slice and combine with owner-exclusive
    all-reduces (the flow, the cull scores) or an all-gather of the
    per-block detection winners (one (score, row, col) triple a
    ``keypoint_spacing`` block); the lifecycle (move, merge, spawn,
    trajectories) is a function of the replicated state and runs the same
    on every rank. Away from the right image margin the result equals the
    single-device ``video_extruder_update`` bit for bit (the caveats of
    ``sharded_semi_dense_flow``)."""
    h0, w0 = frame2.shape
    bs = cfg.keypoint_spacing
    geo = _flow_geometry(mesh.size(axis), mesh.get_local_rank(axis),
                         (h0, w0), cfg.winsize, cfg.nscales, cfg.propagation,
                         cfg.patchsize, 5, 1)
    g0, wl, halo = geo.g0, geo.wl, geo.halo
    if wl % bs:
        raise ValueError(f"shard width {wl} must be divisible by "
                         f"keypoint_spacing {bs}")
    local_flow = functools.partial(_local_flow, mesh, axis, geo)
    kps = state.keypoints
    frame_id = state.frame_id + 1
    dev = kps.position.device

    # 1. track (the flow replicated after its all-reduce)
    m, _, ok, ext2 = local_flow(shard_image_cols(mesh, frame1, axis),
                                shard_image_cols(mesh, frame2, axis),
                                kps.position, kps.alive)
    in_dom = ((m[:, 0] >= 0) & (m[:, 0] <= h0 - 1) &
              (m[:, 1] >= 0) & (m[:, 1] <= w0 - 1))
    kps = kp_move_all(kps, m, ok & in_dom)

    # 2. merge collided particles (replicated)
    kps = _merge_collided(kps, (h0, w0), bs)

    # 3. cull: K2 scores each slot on its owner's extended slice at the
    # rounded, clamped position (integer-valued, so K2's own rounding keeps
    # it), then the owner-exclusive all-reduce
    p = torch.round(kps.position).to(torch.int32)
    pr, pc = p[:, 0].clamp(0, h0 - 1), p[:, 1].clamp(0, w0 - 1)
    own = (pc >= g0) & (pc < g0 + wl)
    local_pos = torch.stack([pr, pc - (g0 - halo)], dim=-1).to(torch.float32)
    sc = cull_scores(ext2, geo.border, local_pos, cfg.detector_th)
    sc = all_reduce_sum(torch.where(own, sc, torch.zeros_like(sc)), mesh,
                        axis)
    kps = kp_kill_where(kps, kps.alive & (sc < 3))

    # 4. periodic detection: per-rank block winners on the owned columns
    # (the halo gives FAST its 3 px of context), an all-gather of the
    # small candidate lists, then the single-device top-K on every rank
    if frame_id % cfg.detector_period == 0:
        mask = _occupancy_mask(kps, (h0, w0), bs)
        mask_ext = torch.zeros((h0, wl + 2 * halo), dtype=mask.dtype,
                               device=dev)
        mask_ext[:, halo:halo + wl] = mask[:, g0:g0 + wl]
        simg = score_image(ext2, geo.border, cfg.detector_th, mask_ext)
        a = simg[1:-1, 1 + halo:1 + halo + wl]
        idx, vmax, nbr, nbc = _block_argmax(a, bs)
        rows = torch.arange(nbr, device=dev)[:, None] * bs + idx // bs
        cols = torch.arange(nbc, device=dev)[None, :] * bs + idx % bs + g0
        cand = torch.stack([vmax.clamp(min=0), rows.to(torch.int32),
                            cols.to(torch.int32)], dim=-1)
        # (n, nbr, nbc, 3) in block-row-major global order
        cand = all_gather_stack(cand, mesh, axis).transpose(0, 1).reshape(
            -1, 3)
        nb = cand.shape[0]
        ar = torch.arange(nb, dtype=torch.int32, device=dev)
        score = cand[:, 0]
        # distinct keys in lax.top_k's order: equal scores block-row-major,
        # the empty blocks after them in ascending order
        key = torch.where(score > 0, score * nb + (nb - 1 - ar), -1 - ar)
        kk = min(cfg.detect_k, nb)
        topv, topi = torch.topk(key, kk, sorted=True)
        validk = topv >= 0
        posk = cand[topi, 1:].to(torch.float32)
        if kk < cfg.detect_k:
            pad = cfg.detect_k - kk
            posk = torch.cat([posk, posk.new_zeros((pad, 2))])
            validk = torch.cat([validk, validk.new_zeros((pad,))])
        kps = kp_add(kps, posk, validk)

    # 5. trajectories (replicated)
    return _with_trajectories(state, kps, frame_id, cfg)
