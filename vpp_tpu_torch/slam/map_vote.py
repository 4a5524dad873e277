"""The map-vote PnP (kernel K8): ``_map_vote_pnp``
(``vpp_tpu/slam/pipeline.py:325-444``) after the detection patches, for B
match sets that share one frame's detections.

Per match set (``base`` (B, A), a usable-entry mask over the map ``X``
(A, 3), ``desc`` (A, P²)):

1. ``rounds`` translation-consensus vote rounds. Each projects every entry
   under the current pose, takes its C = 4 nearest valid detections among
   Q (repeated argmin and mask over the (A, Q) squared distances, lowest
   index first on ties, a NaN distance first as ``torch.argmin`` and
   ``jnp.argmin`` take it; a row with fewer valid detections repeats an
   index at ``_HUGE``). Each pair within ``r_wide`` of a usable entry in
   front of the camera votes for the camera-translation correction
   ``((cand - pred) * z) / f`` in an ``NB`` x ``NB`` histogram over
   +-``bmax`` (JAX's 33 bins a side); the 3x3-smoothed histogram's first
   peak shifts the pose (no shift when no pair votes).
2. The pick: each entry's pair nearest the last peak (``j1``, ``uv1``),
   an inlier where it is within two bins of it.
3. The appearance gate: the min over the 9 ±1-px shifted detection
   patches of the sum of |patch - desc| below ``2 gate`` times the
   entry's energy max(sum |desc|, 1).
4. Two Huber Gauss-Newton PnP solves on the same pairs (``ba.pnp_gn``,
   Huber ``huber`` then ``huber / 2``), the mean reprojection error and
   the number of distinct inlier detections.

``map_vote_pnp`` on CUDA tensors is K8 (``kernels/csrc/map_vote.cu``): one
thread-block-cluster launch for every match set, bit-equal to
``_map_vote_pnp_plain`` up to the PnP (the shifts, ``j1``, ``uv1`` and
``inl``) and within rounding of it after, at any Q: the detections are
staged in each CTA's shared memory where they fit and read in device
memory where they do not (``k8_route``), with the same bits. A CPU tensor
takes the plain version. The plain version projects elementwise in one
fixed order and sums the gate's columns in index order, so that the card
can repeat its bits.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .._device import device_constant
from ..core.keypoints import drop_scatter
from ..kernels import LAUNCHES, require_cuda, stream_handle
from .ba import pinhole, pnp_gn

_HUGE = 1e30
C = 4                 # candidates per map entry
NB = 33               # histogram bins a side (the kernel's kNb)
SHIFTS = 9            # the gate's ±1-px shifted detection patches
CLUSTER = 16          # CTAs a match set (the kernel's kCluster)


def staged_bytes(q: int) -> int:
    """The staged route's dynamic shared memory at ``q`` detections
    (map_vote.cu:dyn_bytes): float (row, col), the inlier bit set, the
    valid bytes."""
    return q * 8 + (q + 31) // 32 * 4 + q


def k8_route(q: int, smem: int) -> str:
    """K8's route at ``q`` detections with ``smem`` bytes of dynamic shared
    memory a CTA (``smem_bytes``; on the H100 ~208 KB, so Q up to ~22,800
    stages): "shared" where the detections fit, else "device"."""
    return "shared" if staged_bytes(q) <= smem else "device"


_SMEM = {}


def smem_bytes(device: torch.device) -> int:
    """The dynamic shared memory a CTA of K8 may take on ``device``."""
    if device not in _SMEM:
        from ..kernels import _build
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(_build.load().vpp_map_vote_smem(ctypes.byref(out)),
                         "map_vote shared memory")
        _SMEM[device] = out.value
    return _SMEM[device]


class MapVotePnp(NamedTuple):
    """K8's result for B match sets."""
    T: torch.Tensor      # (B, 4, 4) the pose after both PnP solves
    err: torch.Tensor    # (B,) mean reprojection error of the inliers
    n: torch.Tensor      # (B,) int32 distinct inlier detections
    txy: torch.Tensor    # (B, rounds, 2) each round's shift (tx0, ty0)
    j1: torch.Tensor     # (B, A) int32 each entry's picked detection
    uv1: torch.Tensor    # (B, A, 2) its (row, col)
    inl: torch.Tensor    # (B, A) bool the PnP's pairs


def vote_step(bmax: float) -> float:
    """The histogram's bin width over +-``bmax``, a Python float as JAX's
    ``step``."""
    return 2.0 * bmax / (NB - 1)


def _f32(x: float) -> float:
    """A Python float rounded once to float32 (JAX's weak typing)."""
    return float(torch.tensor(x, dtype=torch.float32))


def _vote_steps(bmax: float) -> Tuple[float, float]:
    """(bmax, step) as the float32 values both frameworks compute with."""
    return _f32(bmax), _f32(vote_step(bmax))


def _project_rows(T: torch.Tensor, X: torch.Tensor, intr: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ba.project`` with the camera coordinates written out elementwise
    in one fixed order, each ((T[i,0] X0 + T[i,1] X1) + T[i,2] X2) +
    T[i,3]: (pred (A, 2) = (row, col), camera depth z (A,))."""
    xc = [((T[i, 0] * X[:, 0] + T[i, 1] * X[:, 1]) + T[i, 2] * X[:, 2])
          + T[i, 3] for i in range(3)]
    return pinhole(torch.stack(xc, dim=-1), intr), xc[2]


def _index_order_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the last dimension, left to right in index order."""
    acc = t[..., 0]
    for k in range(1, t.shape[-1]):
        acc = acc + t[..., k]
    return acc


def _vote_round_plain(pred: torch.Tensor, z: torch.Tensor,
                      posf: torch.Tensor, valid: torch.Tensor,
                      base: torch.Tensor, intr: torch.Tensor, r_wide: float,
                      bmax: float):
    """One vote round from after the projection (``vote_round`` of the JAX
    body). Returns (txy (2,), js (A, C) int32, ds (A, C), cand_uv
    (A, C, 2), dd (A, C)): the round's shift (tx0, ty0) on the device,
    each entry's candidates and their squared distances, and each pair's
    squared distance to the peak (``_HUGE`` for pairs that did not vote).
    Every division is by a device tensor, so the card divides exactly (a
    Python-float divisor would be a multiplication by its reciprocal)."""
    dev = pred.device
    a_n = pred.shape[0]
    nb = NB
    bmax_f, step_f = _vote_steps(bmax)
    step_t = device_constant((step_f,), torch.float32, dev)
    fx, fy = intr[0], intr[1]
    dr = pred[:, None, 0] - posf[None, :, 0]
    dc = pred[:, None, 1] - posf[None, :, 1]
    d2 = dr * dr + dc * dc
    huge = torch.full_like(d2, _HUGE)
    d2c = torch.where(valid[None], d2, huge)
    js, dss = [], []
    for _ in range(C):
        j = torch.argmin(d2c, dim=1, keepdim=True)
        dss.append(d2c.gather(1, j))
        js.append(j)
        d2c = d2c.scatter(1, j, huge[:, :1])
    js = torch.cat(js, dim=1)
    ds = torch.cat(dss, dim=1)
    cand_uv = posf[js]                                       # (A, C, 2)
    txc = (cand_uv[..., 1] - pred[:, None, 1]) * z[:, None] / fx
    tyc = (cand_uv[..., 0] - pred[:, None, 0]) * z[:, None] / fy
    m = base[:, None] & (ds <= r_wide ** 2) & (z[:, None] > 0.1)
    bx = torch.round((txc + bmax_f) / step_t).to(torch.int32)
    by = torch.round((tyc + bmax_f) / step_t).to(torch.int32)
    bx, by = bx.clamp(0, nb - 1), by.clamp(0, nb - 1)
    nbin = nb * nb
    idx = torch.where(m, by * nb + bx, torch.full_like(bx, nbin))
    votes = torch.zeros((nbin + 1,), dtype=torch.float32, device=dev)
    votes.index_put_((idx.reshape(-1).long(),),
                     torch.ones((a_n * C,), dtype=torch.float32, device=dev),
                     accumulate=True)
    vp = torch.nn.functional.pad(votes[:nbin].view(nb, nb), (1, 1, 1, 1))
    sm = sum(vp[i:i + nb, k:k + nb] for i in range(3) for k in range(3))
    flat = sm.reshape(-1)
    pk = torch.argmax(flat, keepdim=True)
    any_votes = flat.gather(0, pk) > 0
    pxy = torch.cat([pk % nb, pk // nb]).to(torch.float32)
    txy = torch.where(any_votes, pxy * step_f - bmax_f,
                      torch.zeros_like(pxy))
    ex, ey = txc - txy[0], tyc - txy[1]
    dd = torch.where(m, ex * ex + ey * ey, torch.full_like(ex, _HUGE))
    return txy, js.to(torch.int32), ds, cand_uv, dd


def _vote_pick_plain(X, base, posf, valid, T_prior, intr, r_wide, bmax,
                     rounds):
    """The vote rounds and the pair pick of one match set: (T after the
    shifts, txy (rounds, 2), j1, uv1, inl before the appearance gate)."""
    T = T_prior
    shifts = []
    for _ in range(rounds):
        pred, z = _project_rows(T, X, intr)
        txy, js, _, cand_uv, dd = _vote_round_plain(
            pred, z, posf, valid, base, intr, r_wide, bmax)
        shifts.append(txy)
        T = T.clone()
        T[:2, 3] += txy
    cb = torch.argmin(dd, dim=1, keepdim=True)
    db = dd.gather(1, cb)[:, 0]
    uv1 = cand_uv.gather(1, cb[:, :, None].expand(-1, 1, 2))[:, 0]
    j1 = js.gather(1, cb)[:, 0]
    inl = base & (db <= (2.0 * vote_step(bmax)) ** 2)
    return T, torch.stack(shifts), j1, uv1, inl


def _one_set_plain(X, desc, base, posf, valid, det_patches, T_prior, intr,
                   r_wide, bmax, gate, rounds, pnp_iters, huber):
    """``_map_vote_pnp`` for one match set: (T, err, n, txy (rounds, 2),
    j1, uv1, inl)."""
    T, txy, j1, uv1, inl = _vote_pick_plain(X, base, posf, valid, T_prior,
                                            intr, r_wide, bmax, rounds)
    # the appearance gate on the chosen pairs, at twice the claim-time
    # threshold (see the JAX module)
    best = _index_order_sum(
        (det_patches[:, j1.long()] - desc).abs()).amin(0)
    energy = _index_order_sum(desc.abs()).clamp(min=1.0)
    inl = inl & (best < 2.0 * gate * energy)
    T1, _ = pnp_gn(T, X, uv1, inl, intr, iters=pnp_iters, huber=huber)
    T1, err = pnp_gn(T1, X, uv1, inl, intr, iters=pnp_iters,
                     huber=huber / 2)
    seen = drop_scatter(torch.zeros((posf.shape[0],), dtype=torch.bool,
                                    device=X.device), j1,
                        torch.ones_like(inl), inl)
    return T1, err, seen.sum().to(torch.int32), txy, j1, uv1, inl


def _map_vote_pnp_plain(X, desc, base, pos, valid, det_patches, T_prior,
                        intr, *, r_wide: float, bmax: float, gate: float,
                        rounds: int = 2, pnp_iters: int = 6,
                        huber: float = 4.0) -> MapVotePnp:
    """Plain version of K8: the JAX body for each match set in turn."""
    posf = pos.to(torch.float32)
    sets = [_one_set_plain(X, desc, base[i], posf, valid, det_patches,
                           T_prior, intr, r_wide, bmax, gate, rounds,
                           pnp_iters, huber)
            for i in range(base.shape[0])]
    return MapVotePnp(*(torch.stack(v) for v in zip(*sets)))


def _outputs(b_n: int, a_n: int, rounds: int, dev: torch.device):
    """K8's outputs (a ``MapVotePnp``) and its scratch (pair codes (B, A,
    C) int32, pair votes (B, A, C, 2)) as views of one allocation (one
    ``torch.empty``: its host cost is most of a small kernel's)."""
    ba = b_n * a_n
    sizes = (16 * b_n, b_n, b_n, 2 * rounds * b_n, ba, 2 * ba, -(-ba // 4),
             C * ba, 2 * C * ba)
    out = torch.empty((sum(sizes),), dtype=torch.float32, device=dev)
    parts, o = [], 0
    for s in sizes:
        parts.append(out[o:o + s])
        o += s
    T, err, n, txy, j1, uv1, inl, code, pair_t = parts
    i32 = torch.int32
    res = MapVotePnp(
        T.view(b_n, 4, 4), err, n.view(i32), txy.view(b_n, rounds, 2),
        j1.view(i32).view(b_n, a_n), uv1.view(b_n, a_n, 2),
        inl.view(torch.uint8)[:ba].view(torch.bool).view(b_n, a_n))
    return res, (code.view(i32), pair_t)


def map_vote_pnp(X: torch.Tensor, desc: torch.Tensor, base: torch.Tensor,
                 pos: torch.Tensor, valid: torch.Tensor,
                 det_patches: torch.Tensor, T_prior: torch.Tensor,
                 intr: torch.Tensor, *, r_wide: float, bmax: float,
                 gate: float, rounds: int = 2, pnp_iters: int = 6,
                 huber: float = 4.0, smem: Optional[int] = None
                 ) -> MapVotePnp:
    """K8: the map-vote PnP of B match sets, one launch on CUDA tensors;
    the plain version on CPU tensors. ``X`` (A, 3), ``desc`` (A, P²),
    ``base`` (B, A) bool, ``pos`` (Q, 2) int32 detections (row, col),
    ``valid`` (Q,) bool, ``det_patches`` (9, Q, P²) (``_det_shift_patches``),
    ``T_prior`` (4, 4), ``intr`` (4,). Needs A, Q, B >= 1 and rounds >= 1.
    ``smem`` below the card's (``smem_bytes``) picks the route
    (``k8_route``) for that many bytes instead: the same bits on the device
    route at small Q."""
    a_n, q_n = X.shape[0], pos.shape[0]
    b_n, p2 = base.shape[0], desc.shape[-1]
    if (X.shape != (a_n, 3) or desc.shape != (a_n, p2)
            or base.shape != (b_n, a_n) or pos.shape != (q_n, 2)
            or valid.shape != (q_n,) or det_patches.shape != (SHIFTS, q_n, p2)
            or T_prior.shape != (4, 4) or intr.shape != (4,)
            or min(a_n, q_n, b_n, p2, rounds) < 1 or pnp_iters < 0):
        raise ValueError(
            "map_vote_pnp: needs X (A, 3), desc (A, P²), base (B, A), pos "
            "(Q, 2), valid (Q,), det_patches (9, Q, P²), T_prior (4, 4) and "
            "intr (4,) with A, Q, B, P², rounds >= 1 and pnp_iters >= 0; got "
            + ", ".join(str(tuple(t.shape)) for t in (
                X, desc, base, pos, valid, det_patches, T_prior, intr))
            + f", rounds {rounds}, pnp_iters {pnp_iters}")
    kw = dict(r_wide=r_wide, bmax=bmax, gate=gate, rounds=rounds,
              pnp_iters=pnp_iters, huber=huber)
    if X.device.type == "cpu":
        return _map_vote_pnp_plain(X, desc, base, pos, valid, det_patches,
                                   T_prior, intr, **kw)
    f32 = torch.float32
    ops = (X.contiguous(), desc.contiguous(), base.contiguous(),
           pos.contiguous(), valid.contiguous(), det_patches.contiguous(),
           T_prior.contiguous(), intr.contiguous())
    require_cuda("map_vote_pnp", *ops, dtypes=(
        f32, f32, torch.bool, torch.int32, torch.bool, f32, f32, f32))
    from ..kernels import _build
    bmax_f, step_f = _vote_steps(bmax)
    res, (code, pair_t) = _outputs(b_n, a_n, rounds, X.device)
    card = smem_bytes(X.device)
    staged = k8_route(q_n, card if smem is None else min(smem, card)) \
        == "shared"
    bits = None if staged else torch.empty(
        (b_n, CLUSTER, (q_n + 31) // 32), dtype=torch.int32, device=X.device)
    rc = _build.load().vpp_map_vote_pnp(
        *(t.data_ptr() for t in ops), a_n, q_n, b_n, p2, rounds, pnp_iters,
        float(r_wide) ** 2, bmax_f, step_f, (2.0 * vote_step(bmax)) ** 2,
        2.0 * gate, huber, huber / 2, *(t.data_ptr() for t in res),
        code.data_ptr(), pair_t.data_ptr(),
        None if bits is None else bits.data_ptr(), int(staged),
        stream_handle(X))
    LAUNCHES["map_vote"] += 1
    _build.check(rc, "map_vote_pnp")
    return res
