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
float32. The level is kernel K1 (``kernels/csrc/flow_level.cu``), two
launches per level on the card: the cost volume, then the argmin, the
rejection and every propagation pass. ``flow_level``, ``flow_match`` and
``flow_propagate`` launch it for CUDA tensors and run their plain
versions for CPU ones.

Streams: every level function also takes S levels at once, buffers
(S, hb, wb) with predictions (S, gh, gw, 2), in the same two launches
(the stream in the grid), and the plain versions carry the same leading
S. ``semi_dense_streams`` is the tracker's flow for S streams.

With a fundamental matrix F, ``epipolar_flow=True`` replaces the cost
volume at every level by a bounded SAD search along each occupied cell's
epipolar line (``_epipolar_search``: one representative keypoint a cell,
the lowest valid slot, 2·``epipolar_steps`` + 1 candidates 1.5 px apart
through the epipole), and ``epipolar_filter`` kills matches farther than
that many pixels from the source point's epipolar line (alone, it keeps
the cost-volume route, K1). This branch is plain PyTorch with no kernel of
its own; the epipole (the least eigenvector of F Fᵀ, ``torch.linalg.eigh``)
is the one step that may read the host, once a call. It has no streams
form, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import device_constant
from ..core.image import Image2d, pad_hw
from ..kernels import LAUNCHES, require_cuda, stream_handle
from .pyramid import Pyramid, level_shapes, pyramid

_INF = 1e30

_C8 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def _gather_patches(data: torch.Tensor, centers: torch.Tensor,
                    ws: int) -> torch.Tensor:
    """(N, ws, ws) windows around int (N, 2) centres (buffer coords),
    reads clamped to the buffer."""
    h, w = data.shape
    half = ws // 2
    o = torch.arange(-half, ws - half, device=data.device)
    rr = (centers[:, 0, None, None].long() + o[None, :, None]).clamp(0, h - 1)
    cc = (centers[:, 1, None, None].long() + o[None, None, :]).clamp(0, w - 1)
    return data[rr, cc]


def _sad(patches1: torch.Tensor, patches2: torch.Tensor) -> torch.Tensor:
    """(N,) sums of absolute differences."""
    return (patches1 - patches2).abs().sum(dim=(1, 2))


@dataclasses.dataclass(frozen=True)
class LevelGeometry:
    """Static shape of one level's match: buffer border ``b`` around an
    ``h`` x ``w`` domain, ``ws``² windows on a ``gh`` x ``gw`` grid of
    ``patch`` px cells, search radius ``R``, warp clip ``pred_bound``.

    ``col0``/``w_total``: where the buffers hold a column slice of a wider
    level (the sharded tracker), local column c is column ``col0 + c`` of
    a ``w_total``-wide level, and the in-domain rejection tests the wide
    level's columns. The defaults (0, ``None`` meaning ``w``) are the
    unsliced level."""
    b: int
    h: int
    w: int
    ws: int
    patch: int
    gh: int
    gw: int
    R: int
    pred_bound: int
    col0: int = 0
    w_total: Optional[int] = None

    @property
    def domain(self) -> Tuple[int, int, int, int, int]:
        """(h, w, patch, col0, w_total): the rejection's operands."""
        return (self.h, self.w, self.patch, self.col0,
                self.w if self.w_total is None else self.w_total)


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
# On S levels: buffers (S, hb, wb), per-cell values (S, gh, gw[, 2]), the
# volume (S, D², gh, gw).

def _cells_to_pixels(cell_vals: torch.Tensor, b: int, h: int, w: int,
                     patch: int, hb: int, wb: int) -> torch.Tensor:
    """Broadcast (S, gh, gw) per-cell values to (S, hb, wb) pixel buffers
    (patch-block repeat, crop to the domain, edge padding)."""
    px = cell_vals.repeat_interleave(patch, -2).repeat_interleave(patch, -1)
    px = px[..., :h, :w]
    ph, pw = px.shape[-2], px.shape[-1]
    return pad_hw(px, b, hb - b - ph, b, wb - b - pw, "edge")


def _warp_by_cell_flow(a2: torch.Tensor, pred: torch.Tensor, b: int, h: int,
                       w: int, patch: int, max_shift: int) -> torch.Tensor:
    """Backward-warp the buffers by per-cell integer flow: per axis a select
    over rolled copies (even shifts in ±max_shift, wrapping like jnp.roll);
    the column pass reads the row-warped buffer."""
    s = pred.clamp(-max_shift, max_shift)
    hb, wb = a2.shape[-2], a2.shape[-1]
    out = a2
    for axis in (0, 1):
        digit = _cells_to_pixels(s[..., axis], b, h, w, patch, hb, wb)
        sel = out
        for k in range(-max_shift, max_shift + 1, 2):
            if k == 0:
                continue
            sel = torch.where(digit == k, torch.roll(out, -k, dims=axis - 2),
                              sel)
        out = sel
    return out


def _cost_volume(a1: torch.Tensor, a2w: torch.Tensor, g: LevelGeometry,
                 offsets: list) -> torch.Tensor:
    """(S, D², gh, gw) SAD volumes of bf16 |diffs| summed in float32;
    buffers are edge-padded where a displaced window would leave them."""
    off = g.ws // 2 - g.patch // 2
    r0 = g.b - off
    lr = (g.gh - 1) * g.patch + g.ws
    lc = (g.gw - 1) * g.patch + g.ws
    hb, wb = a1.shape[-2], a1.shape[-1]
    pt = pl = max(0, g.R - r0)
    pbot = max(0, r0 + lr + g.R - hb)
    pright = max(0, r0 + lc + g.R - wb)
    if pt or pbot or pl or pright:
        a1 = pad_hw(a1, pt, pbot, pl, pright, "edge")
        a2w = pad_hw(a2w, pt, pbot, pl, pright, "edge")
    r0r, c0c = r0 + pt, r0 + pl
    base = a1[..., r0r:r0r + lr, c0c:c0c + lc]
    diff = torch.stack([
        (base - a2w[..., r0r + dr:r0r + dr + lr, c0c + dc:c0c + dc + lc]).abs()
        for dr, dc in offsets], dim=-3).to(torch.float32)
    win = diff.unfold(-2, g.ws, g.patch).unfold(-2, g.ws, g.patch)
    return win.sum(dim=(-2, -1))


def _reject_out_of_domain(flow: torch.Tensor, dist: torch.Tensor,
                          pred: torch.Tensor, g: LevelGeometry):
    """Keep ``pred`` and an infinite distance where the matched window
    centre leaves the level domain (the wide level's columns for a column
    slice, ``LevelGeometry.col0``/``w_total``)."""
    dev = flow.device
    h, _, patch, col0, w_total = g.domain
    ctr_r = torch.arange(g.gh, device=dev)[:, None] * patch + patch // 2
    ctr_c = (torch.arange(g.gw, device=dev)[None, :] * patch + patch // 2
             + col0)
    tgt_r = ctr_r + flow[..., 0]
    tgt_c = ctr_c + flow[..., 1]
    in_dom = ((tgt_r >= 0) & (tgt_r <= h - 1) &
              (tgt_c >= 0) & (tgt_c <= w_total - 1))
    flow = torch.where(in_dom[..., None], flow, pred)
    dist = torch.where(in_dom, dist, torch.full_like(dist, _INF))
    return flow, dist


def _lift(*ts: Optional[torch.Tensor]):
    """(one level given, the operands with a leading S): one level's
    (hb, wb) buffers, (gh, gw[, 2]) cell values and (D², gh, gw) volume
    gain S = 1; the first operand decides (2-D: one level)."""
    one = ts[0].dim() == 2
    if one:
        ts = tuple(None if t is None else t[None] for t in ts)
    return one, ts


def _unlift(one: bool, *ts: torch.Tensor):
    return tuple(t[0] for t in ts) if one else ts


def _match_plain(a1: torch.Tensor, a2: torch.Tensor, pred: torch.Tensor,
                 g: LevelGeometry):
    _, offsets = _displacement_table(g.R)
    a1 = a1.to(torch.bfloat16)
    a2 = a2.to(torch.bfloat16)
    a2w = a2 if g.pred_bound == 0 else _warp_by_cell_flow(
        a2, pred, g.b, g.h, g.w, g.patch, g.pred_bound)
    vol = _cost_volume(a1, a2w, g, offsets)
    best = torch.argmin(vol, dim=-3)               # first minimum
    dist = torch.gather(vol, -3, best[..., None, :, :]).squeeze(-3)
    delta = _table(g.R, "disp", vol.device)[best]
    flow, dist = _reject_out_of_domain(pred + delta, dist, pred, g)
    return flow.to(torch.int32), dist, vol


def flow_match_plain(a1: torch.Tensor, a2: torch.Tensor, pred: torch.Tensor,
                     g: LevelGeometry
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K1 up to the propagation: warp, cost volume,
    ordered argmin, in-domain rejection. Returns (flow, dist, volume), with
    a leading S where the buffers are (S, hb, wb)."""
    one, (a1, a2, pred) = _lift(a1, a2, pred)
    return _unlift(one, *_match_plain(a1, a2, pred, g))


def _volume_lookup(vol: torch.Tensor, q: torch.Tensor,
                   R: int) -> torch.Tensor:
    """Cost at per-cell displacement q ((S, gh, gw, 2), relative to the
    volume's centre); out-of-window q → +inf."""
    dd = 2 * R + 1
    inside = ((q[..., 0] >= -R) & (q[..., 0] <= R) &
              (q[..., 1] >= -R) & (q[..., 1] <= R))
    qflat = ((q[..., 0].clamp(-R, R) + R) * dd + (q[..., 1].clamp(-R, R) + R))
    k = _table(R, "flat_to_k", vol.device)[qflat.long()]
    val = torch.gather(vol, -3, k[..., None, :, :].long()).squeeze(-3)
    return torch.where(inside, val, torch.full_like(val, _INF))


def _propagate_plain(flow, dist, pred, vol, R):
    gh, gw = dist.shape[-2], dist.shape[-1]
    dev = flow.device
    best_nf, best_nd = flow, dist
    for dr, dc in _C8:
        nf = torch.roll(flow, (-dr, -dc), dims=(-3, -2))
        rr = torch.arange(gh, device=dev)[:, None] + dr
        cc = torch.arange(gw, device=dev)[None, :] + dc
        inside = (rr >= 0) & (rr < gh) & (cc >= 0) & (cc < gw)
        cand_d = _volume_lookup(vol, nf - pred, R)
        far = ((flow - nf) ** 2).sum(-1) > 4
        ok = inside & far & (cand_d < best_nd)
        best_nf = torch.where(ok[..., None], nf, best_nf)
        best_nd = torch.where(ok, cand_d, best_nd)
    return best_nf, best_nd


def flow_propagate_plain(flow: torch.Tensor, dist: torch.Tensor,
                         pred: torch.Tensor, vol: torch.Tensor,
                         R: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of one Jacobi propagation pass of K1: each cell scores
    its 8 neighbours' flows (``_C8`` order, strict <) against its volume
    and adopts the best one that differs by more than 2 px."""
    one, (dist, flow, pred, vol) = _lift(dist, flow, pred, vol)
    return _unlift(one, *_propagate_plain(flow, dist, pred, vol, R))


# -- K1 wrappers ------------------------------------------------------------

_SMEM_MAX = 232448    # shared memory one block may use on Hopper (227 KB)
# (tile, threads) of launch A's instantiations in flow_level.cu, largest
# tile first; the last only where no larger one fits
_VOLUME_SHAPES = ((8, 256), (4, 128), (2, 64))
_GLOBAL_SHAPE = (4, 256)   # launch A's global route: flow_volume_global_kernel
_SELECT_TILE = 8      # cells per tile side of launch B
_BATCH = 8            # flow_level.cu: kBatch, displacements per batch of A


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """How K1's two launches cut one level (``flow_level.cu``). Launch A
    (cost volume and each chunk's first minimum): ``a_tile`` x ``a_tile``
    cells, ``a_threads`` threads and ``chunk`` displacements per block,
    ``batch`` of them in shared memory at once, on an (x tiles, y tiles,
    chunks) grid; ``a_route`` "shared" stages the block's regions in
    shared memory, "global" reads them in device memory (no shared memory,
    ``batch`` 1). Launch B (argmin over the chunks, rejection, ``iters``
    passes): ``b_tile`` x ``b_tile`` cells per block with a halo of its
    passes, the flat_to_k table in shared memory (``b_table`` "shared") or
    in device memory ("global"); past the passes whose halo fits a block, a
    chain of launches (``_select_links``), ``b_smem`` and ``b_table`` the
    first one's. ``*_smem`` are dynamic shared-memory bytes."""
    a_tile: int
    a_threads: int
    chunk: int
    batch: int
    a_grid: Tuple[int, int, int]
    a_smem: int
    iters: int
    b_tile: int
    b_grid: Tuple[int, int]
    b_smem: int
    a_route: str = "shared"
    b_table: str = "shared"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _volume_smem(g: LevelGeometry, tile: int, threads: int, chunk: int,
                 batch: int) -> int:
    """Launch A's shared memory: the a1 window region and the warped a2
    region with its R halo (float), the column sums of a batch (float), the
    slots' minima and argmins, the chunk's offsets, a batch of bf16
    |diffs|."""
    span = (tile - 1) * g.patch + g.ws          # window region side, px
    return (4 * (span * span + (span + 2 * g.R) ** 2 + batch * tile * span
                 + chunk + 2 * threads) + 2 * batch * span * span)


def _select_smem(tile: int, iters: int, R: int, table: bool = True) -> int:
    """Launch B's shared memory: flow and dist twice, the prediction, on
    the tile and its halo; with ``table``, the (2R+1)² flat_to_k table."""
    return (tile + 2 * iters) ** 2 * 32 + (table * (2 * R + 1) ** 2 * 4)


def _select_plan(tile: int, iters: int, R: int) -> Tuple[int, str]:
    """One launch B's (shared-memory bytes, table route) at ``iters``
    passes: the flat_to_k table in shared memory where it fits beside the
    tile, else in device memory."""
    smem = _select_smem(tile, iters, R)
    if smem <= _SMEM_MAX:
        return smem, "shared"
    return _select_smem(tile, iters, R, table=False), "global"


@functools.lru_cache(maxsize=None)
def _select_links(tile: int, iters: int) -> Tuple[int, ...]:
    """Launch B's passes a launch: ``iters`` in one launch where the tile
    and its halo of ``iters`` cells fit a block's shared memory (at the
    8-cell tile up to 38 passes), else a chain of launches of as many
    passes as fit, the last of what is left. The first launch takes the
    argmin and the rejection, each later one reads the last one's flow and
    dist in device memory. The passes are Jacobi passes over the whole
    level and each launch's are exact on its tiles, so the chain gives one
    launch's bits."""
    most = 0
    while _select_smem(tile, most + 1, 0, table=False) <= _SMEM_MAX:
        most += 1
    if iters <= most:
        return (iters,)
    return (most,) * (iters // most) + ((iters % most,) if iters % most
                                        else ())


def _chunk(d2: int, tiles: int, sms: int, streams: int) -> int:
    """Displacements a block: the table split into enough chunks that the
    blocks of ``streams`` levels' ``tiles`` tiles fill ``sms`` SMs."""
    return _cdiv(d2, min(d2, _cdiv(sms, max(1, streams * tiles))))


def _fit_volume(g: LevelGeometry, prop_iters: int, sms: int, tile: int,
                threads: int, streams: int = 1) -> Optional[K1Plan]:
    """The plan at one tile shape, its chunk in the fewest even batches
    (of at most 8 displacements) that fit in a block's shared memory; None
    if a batch of one does not fit. ``streams`` levels share the card, so
    the tiles that fill it are counted over all of them."""
    d2 = (2 * g.R + 1) ** 2
    tiles = _cdiv(g.gw, tile), _cdiv(g.gh, tile)
    chunk = _chunk(d2, tiles[0] * tiles[1], sms, streams)
    b_smem, b_table = _select_plan(
        _SELECT_TILE, _select_links(_SELECT_TILE, prop_iters)[0], g.R)
    for nbatch in range(_cdiv(chunk, _BATCH), chunk + 1):
        batch = _cdiv(chunk, nbatch)
        a_smem = _volume_smem(g, tile, threads, chunk, batch)
        if a_smem <= _SMEM_MAX:
            return K1Plan(a_tile=tile, a_threads=threads, chunk=chunk,
                          batch=batch, a_grid=(*tiles, _cdiv(d2, chunk)),
                          a_smem=a_smem, iters=prop_iters,
                          b_tile=_SELECT_TILE,
                          b_grid=(_cdiv(g.gw, _SELECT_TILE),
                                  _cdiv(g.gh, _SELECT_TILE)),
                          b_smem=b_smem, b_table=b_table)
    return None


def _global_volume(g: LevelGeometry, prop_iters: int, sms: int,
                   streams: int = 1) -> K1Plan:
    """Launch A's global route: ``_GLOBAL_SHAPE``'s tiles, the chunk as
    ``_fit_volume`` cuts it, no shared memory."""
    tile, threads = _GLOBAL_SHAPE
    d2 = (2 * g.R + 1) ** 2
    tiles = _cdiv(g.gw, tile), _cdiv(g.gh, tile)
    chunk = _chunk(d2, tiles[0] * tiles[1], sms, streams)
    b_smem, b_table = _select_plan(
        _SELECT_TILE, _select_links(_SELECT_TILE, prop_iters)[0], g.R)
    return K1Plan(a_tile=tile, a_threads=threads, chunk=chunk, batch=1,
                  a_grid=(*tiles, _cdiv(d2, chunk)), a_smem=0,
                  iters=prop_iters, b_tile=_SELECT_TILE,
                  b_grid=(_cdiv(g.gw, _SELECT_TILE),
                          _cdiv(g.gh, _SELECT_TILE)),
                  b_smem=b_smem, a_route="global", b_table=b_table)


@functools.lru_cache(maxsize=None)
def _k1_plan(g: LevelGeometry, prop_iters: int, sms: int,
             shapes: Tuple[Tuple[int, int], ...] = _VOLUME_SHAPES,
             streams: int = 1) -> K1Plan:
    """Tile plan of one level (of ``streams`` levels launched together) on
    a card with ``sms`` SMs. Launch A takes the first of ``shapes``
    (largest tile first) whose tiles alone, over every stream, fill the
    SMs, else the last that fits: where tiles are too few, smaller ones
    split the displacement table into fewer chunks, and every chunk loads
    its tile again (``k1_tiles.py`` times the shapes). The smallest of
    ``_VOLUME_SHAPES`` is taken only where no larger shape fits, so the
    plans of the levels that the two larger shapes take do not change.
    Where no shape fits at a batch of one displacement, launch A takes its
    global route (``_global_volume``), and where launch B's flat_to_k
    table does not fit beside its tile, the table stays in device memory;
    past the passes whose halo fits, launch B is a chain
    (``_select_links``). No plan changes a bit: every window sums in one
    order, and the argmin combines the chunks' minima as (cost, k)."""
    plan = None
    for tile, threads in shapes:
        if plan is not None and (tile, threads) == _VOLUME_SHAPES[-1]:
            break
        fit = _fit_volume(g, prop_iters, sms, tile, threads, streams)
        if fit is not None:
            plan = fit
            if streams * fit.a_grid[0] * fit.a_grid[1] >= sms:
                break
    if plan is None:
        plan = _global_volume(g, prop_iters, sms, streams)
    _check_plan("flow_level", plan.a_smem, plan.b_smem)
    return plan


def _check_plan(name: str, *smem: int) -> None:
    """Raise where a launch would need more shared memory than a block may
    use. Every plan fits by construction (launch A's global route uses
    none, launch B chains its passes), so no displacement or pass count is
    refused: this guards the planner."""
    if max(smem) > _SMEM_MAX:
        raise ValueError(f"{name}: {max(smem)} bytes of shared memory exceed "
                         f"the {_SMEM_MAX} a block may use")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_volume(a1: torch.Tensor, a2: torch.Tensor, pred: torch.Tensor,
                   g: LevelGeometry, plan: K1Plan):
    """Launch A on one level (hb, wb) or S levels (S, hb, wb): the (D²,
    gh, gw) cost volume, and each chunk's first minimum per cell as (cost,
    k) of shape (chunks, gh, gw), each with the levels' leading S."""
    from ..kernels import _build
    lib = _build.load()
    dev = a1.device
    lead, (hb, wb) = a1.shape[:-2], a1.shape[-2:]
    d2 = (2 * g.R + 1) ** 2
    disp = _table(g.R, "disp", dev)
    vol = torch.empty(lead + (d2, g.gh, g.gw), dtype=torch.float32,
                      device=dev)
    part = (torch.empty(lead + (plan.a_grid[2], g.gh, g.gw),
                        dtype=torch.float32, device=dev),
            torch.empty(lead + (plan.a_grid[2], g.gh, g.gw),
                        dtype=torch.int32, device=dev))
    code = lib.vpp_flow_volume(
        a1.data_ptr(), a2.data_ptr(), pred.data_ptr(), disp.data_ptr(), d2,
        hb, wb, g.b, g.h, g.w, g.ws, g.patch, g.gh, g.gw, g.R, g.pred_bound,
        plan.a_tile, plan.a_threads, plan.chunk, plan.batch, plan.a_smem,
        lead.numel(), vol.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
        stream_handle(a1))
    LAUNCHES["flow_level"] += 1
    _build.check(code, "flow level, volume launch")
    return vol, part


def _launch_select(vol: torch.Tensor, pred: torch.Tensor, R: int,
                   iters: int, tile: int, part=None,
                   flow_in: Optional[torch.Tensor] = None,
                   dist_in: Optional[torch.Tensor] = None,
                   domain: Tuple[int, ...] = (0, 0, 1)
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch B on one level or S levels (the volume's leading S),
    ``tile`` x ``tile`` cell tiles: ``iters`` passes from
    ``flow_in``/``dist_in``, or from the argmin over launch A's chunk
    minima ``part`` and the rejection against ``domain`` = (h, w, patch)
    or (h, w, patch, col0, w_total) (``LevelGeometry.domain``; a 3-tuple
    is the unsliced level, col0 0 and w_total w). The flat_to_k table is
    staged in shared memory where it fits beside the tile
    (``_select_plan``), else read in device memory. Past the passes whose
    halo fits a block, a chain of launches (``_select_links``), each from
    the last one's flow and dist."""
    from ..kernels import _build
    h, _, patch, col0, w_total = (*domain, 0, domain[1])[:5]
    lib = _build.load()
    dev = vol.device
    lead, (d2, gh, gw) = vol.shape[:-3], vol.shape[-3:]
    for passes in _select_links(tile, iters):
        smem, table = _select_plan(tile, passes, R)
        _check_plan("flow_level, select launch", smem)
        flow = torch.empty(lead + (gh, gw, 2), dtype=torch.int32, device=dev)
        dist = torch.empty(lead + (gh, gw), dtype=torch.float32, device=dev)
        code = lib.vpp_flow_select(
            vol.data_ptr(), None if part is None else part[0].data_ptr(),
            None if part is None else part[1].data_ptr(),
            0 if part is None else part[0].shape[-3], pred.data_ptr(),
            _table(R, "disp", dev).data_ptr(),
            _table(R, "flat_to_k", dev).data_ptr(),
            None if flow_in is None else flow_in.data_ptr(),
            None if dist_in is None else dist_in.data_ptr(), d2, R, gh, gw,
            h, patch, col0, w_total, tile, passes, int(table == "shared"),
            smem, lead.numel(), flow.data_ptr(), dist.data_ptr(),
            stream_handle(vol))
        LAUNCHES["flow_level"] += 1
        _build.check(code, "flow level, select launch")
        part, flow_in, dist_in = None, flow, dist
    return flow, dist


def _level_operands(a1: torch.Tensor, a2: torch.Tensor, pred: torch.Tensor,
                    g: LevelGeometry, prop_iters: int):
    """Checked CUDA operands of one level (hb, wb) or of S levels (S, hb,
    wb), and their plan."""
    a1 = a1.to(torch.float32).contiguous()
    a2 = a2.to(torch.float32).contiguous()
    pred = pred.to(torch.int32).contiguous()
    require_cuda("flow_level", a1, a2, pred,
                 dtypes=(torch.float32, torch.float32, torch.int32))
    if (a1.dim() not in (2, 3) or a1.shape != a2.shape
            or tuple(pred.shape) != a1.shape[:-2] + (g.gh, g.gw, 2)):
        raise ValueError(f"flow_level: shapes {a1.shape}, {a2.shape}, "
                         f"{pred.shape} do not fit {g}")
    if prop_iters < 0:
        raise ValueError("flow_level: prop_iters must be >= 0")
    plan = _k1_plan(g, prop_iters, _sm_count(a1.device), _VOLUME_SHAPES,
                    a1.shape[:-2].numel())
    return a1, a2, pred, plan


def flow_match(a1: torch.Tensor, a2: torch.Tensor, pred: torch.Tensor,
               g: LevelGeometry
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 without propagation on CUDA tensors (the plain version on CPU
    ones): the volume launch, then the select launch with no pass.
    a1, a2: (hb, wb) float32 level buffers; pred: (gh, gw, 2) int32; or
    S of each with a leading S. Returns (flow (gh, gw, 2) int32, dist
    (gh, gw) f32, vol (D², gh, gw)), with the same leading S."""
    if a1.device.type == "cpu":
        return flow_match_plain(a1, a2, pred, g)
    a1, a2, pred, plan = _level_operands(a1, a2, pred, g, 0)
    vol, part = _launch_volume(a1, a2, pred, g, plan)
    flow, dist = _launch_select(vol, pred, g.R, 0, plan.b_tile, part,
                                domain=g.domain)
    return flow, dist, vol


def flow_propagate(flow: torch.Tensor, dist: torch.Tensor,
                   pred: torch.Tensor, vol: torch.Tensor, R: int,
                   iters: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` K1 Jacobi passes in one launch on CUDA tensors (the plain
    version, pass by pass, on CPU ones); reads ``flow``/``dist`` and writes
    fresh buffers. Takes one level or S of them (a leading S)."""
    if flow.device.type == "cpu":
        for _ in range(iters):
            flow, dist = flow_propagate_plain(flow, dist, pred, vol, R)
        return flow, dist
    require_cuda("flow_propagate", flow, dist, pred, vol,
                 dtypes=(torch.int32, torch.float32, torch.int32,
                         torch.float32))
    lead, (gh, gw) = dist.shape[:-2], dist.shape[-2:]
    d2 = (2 * R + 1) ** 2
    if (tuple(flow.shape) != lead + (gh, gw, 2) or pred.shape != flow.shape
            or tuple(vol.shape) != lead + (d2, gh, gw) or len(lead) > 1):
        raise ValueError("flow_propagate: inconsistent shapes")
    if iters < 0:
        raise ValueError("flow_propagate: iters must be >= 0")
    return _launch_select(vol, pred, R, iters, _SELECT_TILE, flow_in=flow,
                          dist_in=dist)


def flow_level(a1: torch.Tensor, a2: torch.Tensor, pred: torch.Tensor,
               g: LevelGeometry, prop_iters: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level (``_flow_level_xla``): match, then ``prop_iters`` Jacobi
    passes; on CUDA tensors two launches of K1 (the volume, then argmin,
    rejection and every pass), for one level or for S of them (a leading
    S on every operand). Returns (flow (gh, gw, 2) int32, dist (gh, gw)
    f32), with the same leading S."""
    if a1.device.type == "cpu":
        one, (a1, a2, pred) = _lift(a1, a2, pred)
        flow, dist, vol = _match_plain(a1, a2, pred, g)
        for _ in range(prop_iters):
            flow, dist = _propagate_plain(flow, dist, pred, vol, g.R)
        return _unlift(one, flow, dist)
    a1, a2, pred, plan = _level_operands(a1, a2, pred, g, prop_iters)
    vol, part = _launch_volume(a1, a2, pred, g, plan)
    return _launch_select(vol, pred, g.R, prop_iters, plan.b_tile, part,
                          domain=g.domain)


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


def _epipolar_search(a2: torch.Tensor, p_int: torch.Tensor,
                     patches1: torch.Tensor, pred_pos: torch.Tensor,
                     epipole: torch.Tensor, F: torch.Tensor, ws: int,
                     nsteps: int, h: int, w: int, b: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bounded line search along each point's epipolar line: candidates at
    ``epipole + (d0 + 1.5 j) v`` for j in [-nsteps, nsteps], v the line's
    unit direction and d0 the prediction's offset along it; the first
    strictly smallest SAD wins. Returns (best buffer position (N, 2)
    int32, its SAD (N,), 1e30 where no candidate lies in the image)."""
    pf = p_int.to(torch.float32)
    n = pf.shape[0]
    hom = torch.cat([pf, pf.new_ones((n, 1))], dim=1)
    line = hom @ F.T                                  # (N, 3)
    flat = line[:, 1].abs() < 1e-12
    v = torch.stack([torch.ones_like(line[:, 0]),
                     -line[:, 0] / torch.where(flat,
                                               torch.ones_like(line[:, 1]),
                                               line[:, 1])], dim=1)
    v = torch.where(flat[:, None], torch.stack(
        [torch.zeros_like(line[:, 0]), torch.ones_like(line[:, 0])], dim=1),
        v)
    v = v / torch.sqrt((v * v).sum(dim=1, keepdim=True))
    d0 = ((pred_pos.to(torch.float32) - epipole[None]) * v).sum(dim=1)

    best_d = torch.full((n,), _INF, dtype=torch.float32, device=pf.device)
    best_m = pred_pos + b
    for j in range(-nsteps, nsteps + 1):
        pos = epipole[None] + (d0 + 1.5 * j)[:, None] * v
        pos_i = torch.round(pos).to(torch.int32)
        ok = ((pos_i[:, 0] >= 0) & (pos_i[:, 0] <= h - 1)
              & (pos_i[:, 1] >= 0) & (pos_i[:, 1] <= w - 1))
        d = _sad(patches1, _gather_patches(a2, pos_i + b, ws))
        d = torch.where(ok, d, torch.full_like(d, _INF))
        better = d < best_d
        best_m = torch.where(better[:, None], pos_i + b, best_m)
        best_d = torch.where(better, d, best_d)
    return best_m, best_d


def _epipole_and_scales(F0: torch.Tensor, nscales: int):
    """The epipole (e[:2] / e[2], e the least eigenvector of F Fᵀ; e[2]
    below 1e-12 left undivided; float32) and each level's F: the next
    coarser level's times [[2, 2, 1], [2, 2, 1], [1, 1, 0.5]]. F Fᵀ and e
    are taken in float64: the float32 null vector of F Fᵀ is only as good
    as its eigenvalue gap."""
    F64 = F0.double()
    _, vecs = torch.linalg.eigh(F64 @ F64.T)
    e = vecs[:, 0]
    epipole = (e[:2] / torch.where(e[2].abs() < 1e-12, torch.ones_like(e[2]),
                                   e[2])).float()
    down = device_constant((2.0, 2.0, 1.0, 2.0, 2.0, 1.0, 1.0, 1.0, 0.5),
                           torch.float32, F0.device).view(3, 3)
    fs = [F0] * nscales
    for s in range(nscales - 2, -1, -1):
        fs[s] = fs[s + 1] * down
    return epipole, fs


def _epipolar_levels(positions: torch.Tensor, valid: torch.Tensor,
                     pyr1: Pyramid, pyr2: Pyramid, epipole0: torch.Tensor,
                     fs, *, winsize: int, nscales: int, min_scale: int,
                     patchsize: int, steps: int, grid_shapes
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every level by the epipolar search, coarse to fine, from the epipole
    and the levels' F (``_epipole_and_scales``); no host read. Returns the
    readout level's (flow (gh, gw, 2) int32, dist (gh, gw), mark (gh, gw))."""
    k = positions.shape[0]
    dev = positions.device
    b = pyr1[0].border
    slot_ids = torch.arange(k, dtype=torch.int64, device=dev)
    flow = None
    for s in range(nscales - 1, min_scale - 1, -1):
        a1 = pyr1[s].data.to(torch.float32)
        a2 = pyr2[s].data.to(torch.float32)
        h, w = pyr1[s].shape
        gh, gw = grid_shapes[s]
        scale_div = float(2 ** s)
        pos_s = torch.floor(positions / scale_div).to(torch.int32)
        pos_s = torch.stack([pos_s[:, 0].clamp(0, h - 1),
                             pos_s[:, 1].clamp(0, w - 1)], dim=1)
        cr = (pos_s[:, 0] // patchsize).clamp(0, gh - 1)
        cc = (pos_s[:, 1] // patchsize).clamp(0, gw - 1)
        slot = torch.where(valid, cr * gw + cc,
                           torch.full_like(cr, gh * gw)).long()
        # each cell's representative: its lowest valid slot (k if none);
        # the spare entry gh*gw takes the invalid slots
        rep = torch.full((gh * gw + 1,), k, dtype=torch.int64,
                         device=dev).scatter_reduce(
            0, slot, slot_ids, "amin", include_self=True)[:gh * gw]
        mark = rep < k
        p = pos_s[torch.where(mark, rep, torch.zeros_like(rep))]
        if flow is not None:
            cgh, cgw = grid_shapes[s + 1]
            ir = (torch.arange(gh, device=dev) // 2).clamp(0, cgh - 1)
            ic = (torch.arange(gw, device=dev) // 2).clamp(0, cgw - 1)
            pred = 2 * flow[ir[:, None], ic[None, :]]
        else:
            pred = torch.zeros((gh, gw, 2), dtype=torch.int32, device=dev)
        patches1 = _gather_patches(a1, p + b, winsize)
        match, dist = _epipolar_search(
            a2, p, patches1, p + pred.reshape(-1, 2), epipole0 / scale_div,
            fs[s], winsize, steps, h, w, b)
        flow = torch.where(mark[:, None], match - b - p,
                           torch.zeros_like(p)).reshape(gh, gw, 2)
        dist = torch.where(mark, dist, torch.full_like(dist, _INF))
    return flow, dist.reshape(gh, gw), mark.reshape(gh, gw)


def _epipolar_residual_ok(positions: torch.Tensor, match_pos: torch.Tensor,
                          F0: torch.Tensor, th: float) -> torch.Tensor:
    """|match · line(p)| / ||line[:2]|| <= th, line(p) = F (r, c, 1)."""
    hom = torch.cat([positions, positions.new_ones(positions.shape[:-1]
                                                   + (1,))], dim=-1)
    line = hom @ F0.T
    nrm = torch.sqrt((line[..., :2] * line[..., :2]).sum(-1))
    res = ((line[..., :2] * match_pos).sum(-1) + line[..., 2]).abs() \
        / nrm.clamp(min=1e-12)
    return res <= th


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
    ``pyr1``/``pyr2`` reuse prebuilt pyramids. Without a fundamental
    matrix it is one stream of ``semi_dense_streams``; with one,
    ``epipolar_flow`` and ``epipolar_filter`` work as the module says."""
    border = max(3, winsize)
    if pyr1 is None:
        pyr1 = pyramid(i1, nscales, border=border)
    if pyr2 is None:
        pyr2 = pyramid(i2, nscales, border=border)
    F0 = None
    if fundamental_matrix is not None:
        F0 = torch.as_tensor(fundamental_matrix, dtype=torch.float32,
                             device=positions.device)
    if F0 is not None and epipolar_flow:
        h0, w0 = i1.shape
        grid_shapes = level_shapes((max(h0 // patchsize, 1),
                                    max(w0 // patchsize, 1)), nscales)
        epipole0, fs = _epipole_and_scales(F0, nscales)
        flow, dist, mark = _epipolar_levels(
            positions, valid, pyr1, pyr2, epipole0, fs, winsize=winsize,
            nscales=nscales, min_scale=min_scale, patchsize=patchsize,
            steps=epipolar_steps, grid_shapes=grid_shapes)
        gh, gw = grid_shapes[min_scale]
        c = torch.floor(positions / (patchsize * 2 ** min_scale)).to(
            torch.int64)
        cr, cc = c[:, 0].clamp(0, gh - 1), c[:, 1].clamp(0, gw - 1)
        matched = valid & mark[cr, cc]
        match_pos = positions + (flow[cr, cc] * 2 ** min_scale).to(
            torch.float32)
        distance = dist[cr, cc]
    else:
        match_pos, distance, matched = (t[0] for t in semi_dense_streams(
            positions[None], valid[None],
            tuple(lvl.data[None] for lvl in pyr1.levels),
            tuple(lvl.data[None] for lvl in pyr2.levels), pyr1[0].border,
            winsize=winsize, nscales=nscales, min_scale=min_scale,
            propagation=propagation, patchsize=patchsize,
            search_niters=search_niters, refine_radius=refine_radius))
    if F0 is not None and epipolar_filter is not None:
        matched = matched & _epipolar_residual_ok(positions, match_pos, F0,
                                                  epipolar_filter)
    return match_pos, distance, matched


def semi_dense_streams(
        positions: torch.Tensor, valid: torch.Tensor,
        levels1: Tuple[torch.Tensor, ...], levels2: Tuple[torch.Tensor, ...],
        border: int, *, winsize: int = 7, nscales: int = 4,
        min_scale: int = 0, propagation: int = 2, patchsize: int = 5,
        search_niters: int = 5, refine_radius: Optional[int] = 1,
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``semi_dense_optical_flow`` of S streams at once: (S, K, 2)
    positions and (S, K) valid, each pyramid level one (S, hb, wb) buffer
    with ``border`` (``pyramid_streams``); two K1 launches a level for every
    stream. Returns (S, K, 2), (S, K), (S, K)."""
    n_streams = positions.shape[0]
    shapes = [(lvl.shape[-2] - 2 * border, lvl.shape[-1] - 2 * border)
              for lvl in levels1]
    h0, w0 = shapes[0]
    grid_shapes = level_shapes((max(h0 // patchsize, 1),
                                max(w0 // patchsize, 1)), nscales)
    flows: List[Optional[torch.Tensor]] = [None] * nscales
    b = border
    R_top = max(1, search_niters)
    radii = _level_radii(nscales, R_top,
                         R_top if refine_radius is None
                         else max(1, min(refine_radius, R_top)))
    bounds = _level_bounds(nscales, radii)
    dev = positions.device

    for s in range(nscales - 1, min_scale - 1, -1):
        a1 = levels1[s].to(torch.float32)
        a2 = levels2[s].to(torch.float32)
        h, w = shapes[s]
        gh, gw = grid_shapes[s]

        # multiscale prediction: upsampled coarse flow x2
        if s < nscales - 1 and flows[s + 1] is not None:
            cgh, cgw = grid_shapes[s + 1]
            ir = (torch.arange(gh, device=dev) // 2).clamp(0, cgh - 1)
            ic = (torch.arange(gw, device=dev) // 2).clamp(0, cgw - 1)
            pred = 2 * flows[s + 1][:, ir[:, None], ic[None, :]]
        else:
            pred = torch.zeros((n_streams, gh, gw, 2), dtype=torch.int32,
                               device=dev)

        g = LevelGeometry(b=b, h=h, w=w, ws=winsize, patch=patchsize,
                          gh=gh, gw=gw, R=radii[s],
                          pred_bound=0 if s == nscales - 1
                          else 2 * bounds[s + 1])
        flows[s], dist = flow_level(a1, a2, pred, g, propagation)

    # occupancy mark of the readout level: a cell holds >= 1 live keypoint
    h, w = shapes[min_scale]
    gh, gw = grid_shapes[min_scale]
    pos_s = torch.floor(positions / float(2 ** min_scale)).to(torch.int32)
    cr = (pos_s[..., 0].clamp(0, h - 1) // patchsize).clamp(0, gh - 1)
    cc = (pos_s[..., 1].clamp(0, w - 1) // patchsize).clamp(0, gw - 1)
    cell_flat = torch.where(valid, cr * gw + cc, torch.full_like(cr, gh * gw))
    occ = torch.zeros((n_streams, gh * gw + 1), dtype=torch.bool, device=dev)
    # slot gh*gw takes the dropped entries; a scalar scatter keeps the fill
    # value off the host (an indexed assignment would copy it)
    occ.scatter_(1, cell_flat.long(), True)
    mark = occ[:, :gh * gw]

    # final per-keypoint readout
    cell_div = patchsize * (2 ** min_scale)
    c = torch.floor(positions / cell_div).to(torch.int32)
    cell = (c[..., 0].clamp(0, gh - 1) * gw
            + c[..., 1].clamp(0, gw - 1)).long()
    matched = valid & mark.gather(1, cell)
    flow = flows[min_scale].flatten(1, 2).gather(
        1, cell[..., None].expand(cell.shape + (2,)))
    f = (flow * (2 ** min_scale)).to(torch.float32)
    return positions + f, dist.flatten(1).gather(1, cell), matched


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
