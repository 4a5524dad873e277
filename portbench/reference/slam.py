"""Plain SLAM step of S streams: the tracker (pyramid, semi-dense flow,
keypoint lifecycle, FAST cull and detection) and the keyframe back end
(observations, Gauss-Newton PnP, two-view triangulation, the window's
bundle adjustment, pruning, the trajectory history), without recovery.

A frozen copy of the plain PyTorch versions in ``vpp_tpu_torch``
(``algorithms/pyramid.py``, ``flow.py``, ``fast.py``,
``video_extruder.py``, ``core/keypoints.py``, ``core/interp.py``,
``algorithms/geometry.py``, ``slam/pipeline.py:_keyframe_step``) with the
same arithmetic: flow levels rounded to bf16 with float32 window sums,
FAST on int32 pixel differences, float32 geometry. The window's bundle
adjustment is ``reference/ba.py`` in float64 on the ring layout. It
imports nothing of the program: the state it starts from is a plain dict
of tensors (``State``), read from the program's state by field name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import ba as ref_ba
from portbench.reference.precision import EXACT, TF32, Arith

_BINOMIAL = (1.0, 4.0, 6.0, 4.0, 1.0)
_INF = 1e30
_C8 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))
CIRCLE = [(-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3),
          (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3), (0, -3),
          (-1, -3), (-2, -2)]


@dataclasses.dataclass(frozen=True)
class Config:
    """The settings the step reads (``configs/slam_vga.json``)."""
    intrinsics: Tuple[float, float, float, float]
    keyframe_period: int
    ring: int
    ba_iters: int
    ba_huber: float
    ba_lam0: float
    prune_reproj: float
    min_parallax: float
    max_reproj: float
    pnp_iters: int
    history: int
    desc_patch: int
    detector_th: int
    keypoint_spacing: int
    detector_period: int
    max_trajectory_length: int
    nscales: int
    winsize: int
    propagation: int
    patchsize: int
    capacity: int
    detect_k: int

    @property
    def border(self) -> int:
        return max(3, self.winsize)


# -- pads, pyramid ----------------------------------------------------------

def pad_index(n: int, before: int, after: int, mode: str, device):
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    m = torch.remainder(i, 2 * n)
    return torch.where(m >= n, 2 * n - 1 - m, m)


def pad_hw(a, top, bottom, left, right, mode, value=0):
    h, w = a.shape[-2], a.shape[-1]
    if mode == "constant":
        out = torch.full(a.shape[:-2] + (h + top + bottom, w + left + right),
                         value, dtype=a.dtype, device=a.device)
        out[..., top:top + h, left:left + w] = a
        return out
    return a.index_select(-2, pad_index(h, top, bottom, mode, a.device)) \
        .index_select(-1, pad_index(w, left, right, mode, a.device))


def level_shapes(shape, nlevels: int):
    out = [tuple(shape)]
    for _ in range(nlevels - 1):
        h, w = out[-1]
        out.append((1 + int(h / 2.0), 1 + int(w / 2.0)))
    return tuple(out)


def decim_matrix(n: int, on: int) -> np.ndarray:
    a = np.zeros((on, n), np.float32)
    for i in range(on):
        for t, kv in enumerate(_BINOMIAL):
            src = 2 * i + t - 2
            if src < 0:
                src = -src - 1
            if src >= n:
                src = 2 * n - src - 1
            a[i, src] += kv / 16.0
    return a


def pyramid(frames: torch.Tensor, nlevels: int, b: int,
            ar: Arith = EXACT) -> List[torch.Tensor]:
    """(S, h + 2b, w + 2b) float32 level buffers of (S, H, W) frames."""
    shapes = level_shapes(tuple(frames.shape[-2:]), nlevels)
    cur = frames.to(torch.float32)
    levels = [pad_hw(cur, b, b, b, b, "symmetric")]
    for oh, ow in shapes[1:]:
        a = torch.from_numpy(decim_matrix(cur.shape[-2], oh)).to(cur.device)
        bm = torch.from_numpy(decim_matrix(cur.shape[-1], ow)).to(cur.device)
        cur = ar.mm(ar.mm(a, cur), bm.T)
        levels.append(pad_hw(cur, b, b, b, b, "symmetric"))
    return levels


# -- semi-dense flow ----------------------------------------------------------

def displacement_table(R: int):
    ds = [(dr, dc) for dr in range(-R, R + 1) for dc in range(-R, R + 1)]
    ds.sort(key=lambda d: (max(abs(d[0]), abs(d[1])),
                           abs(d[0]) + abs(d[1]), d))
    return np.array(ds, np.int32), ds


def flat_to_k(R: int) -> np.ndarray:
    _, offsets = displacement_table(R)
    dd = 2 * R + 1
    inv = np.zeros((dd * dd,), np.int32)
    for k, (dr, dc) in enumerate(offsets):
        inv[(dr + R) * dd + (dc + R)] = k
    return inv


@dataclasses.dataclass(frozen=True)
class Level:
    b: int
    h: int
    w: int
    ws: int
    patch: int
    gh: int
    gw: int
    R: int
    pred_bound: int


def cells_to_pixels(v, b, h, w, patch, hb, wb):
    px = v.repeat_interleave(patch, -2).repeat_interleave(patch, -1)
    px = px[..., :h, :w]
    return pad_hw(px, b, hb - b - px.shape[-2], b, wb - b - px.shape[-1],
                  "edge")


def warp(a2, pred, g: Level):
    s = pred.clamp(-g.pred_bound, g.pred_bound)
    hb, wb = a2.shape[-2], a2.shape[-1]
    out = a2
    for axis in (0, 1):
        digit = cells_to_pixels(s[..., axis], g.b, g.h, g.w, g.patch, hb, wb)
        sel = out
        for k in range(-g.pred_bound, g.pred_bound + 1, 2):
            if k:
                sel = torch.where(digit == k,
                                  torch.roll(out, -k, dims=axis - 2), sel)
        out = sel
    return out


def cost_volume(a1, a2w, g: Level, offsets):
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
    rr, cc = r0 + pt, r0 + pl
    base = a1[..., rr:rr + lr, cc:cc + lc]
    diff = torch.stack([
        (base - a2w[..., rr + dr:rr + dr + lr, cc + dc:cc + dc + lc]).abs()
        for dr, dc in offsets], dim=-3).to(torch.float32)
    win = diff.unfold(-2, g.ws, g.patch).unfold(-2, g.ws, g.patch)
    return win.sum(dim=(-2, -1))


def flow_level(a1, a2, pred, g: Level, props: int):
    dev = a1.device
    table, offsets = displacement_table(g.R)
    a1 = a1.to(torch.bfloat16)
    a2 = a2.to(torch.bfloat16)
    a2w = a2 if g.pred_bound == 0 else warp(a2, pred, g)
    vol = cost_volume(a1, a2w, g, offsets)
    best = torch.argmin(vol, dim=-3)
    dist = torch.gather(vol, -3, best[..., None, :, :]).squeeze(-3)
    flow = pred + torch.from_numpy(table).to(dev)[best]
    ctr_r = torch.arange(g.gh, device=dev)[:, None] * g.patch + g.patch // 2
    ctr_c = torch.arange(g.gw, device=dev)[None, :] * g.patch + g.patch // 2
    tr, tc = ctr_r + flow[..., 0], ctr_c + flow[..., 1]
    ok = (tr >= 0) & (tr <= g.h - 1) & (tc >= 0) & (tc <= g.w - 1)
    flow = torch.where(ok[..., None], flow, pred).to(torch.int32)
    dist = torch.where(ok, dist, torch.full_like(dist, _INF))
    f2k = torch.from_numpy(flat_to_k(g.R)).to(dev)
    dd = 2 * g.R + 1
    for _ in range(props):
        best_f, best_d = flow, dist
        for dr, dc in _C8:
            nf = torch.roll(flow, (-dr, -dc), dims=(-3, -2))
            rr = torch.arange(g.gh, device=dev)[:, None] + dr
            cc = torch.arange(g.gw, device=dev)[None, :] + dc
            inside = (rr >= 0) & (rr < g.gh) & (cc >= 0) & (cc < g.gw)
            q = nf - pred
            qin = ((q[..., 0] >= -g.R) & (q[..., 0] <= g.R)
                   & (q[..., 1] >= -g.R) & (q[..., 1] <= g.R))
            qf = ((q[..., 0].clamp(-g.R, g.R) + g.R) * dd
                  + (q[..., 1].clamp(-g.R, g.R) + g.R))
            k = f2k[qf.long()]
            cand = torch.gather(vol, -3, k[..., None, :, :].long()).squeeze(-3)
            cand = torch.where(qin, cand, torch.full_like(cand, _INF))
            far = ((flow - nf) ** 2).sum(-1) > 4
            take = inside & far & (cand < best_d)
            best_f = torch.where(take[..., None], nf, best_f)
            best_d = torch.where(take, cand, best_d)
        flow, dist = best_f, best_d
    return flow, dist


def semi_dense(positions, valid, levels1, levels2, b: int, cfg: Config,
               search_niters: int = 5, refine: int = 1):
    """Matched positions (S, K, 2) and matched (S, K) of the tracker's
    flow (``semi_dense_streams`` at min_scale 0)."""
    n = cfg.nscales
    s_count = positions.shape[0]
    shapes = [(l.shape[-2] - 2 * b, l.shape[-1] - 2 * b) for l in levels1]
    h0, w0 = shapes[0]
    grids = level_shapes((max(h0 // cfg.patchsize, 1),
                          max(w0 // cfg.patchsize, 1)), n)
    r_top = max(1, search_niters)
    radii = [max(1, min(refine, r_top)) if s < n - 1 else r_top
             for s in range(n)]
    bounds = [0] * n
    bounds[n - 1] = radii[n - 1]
    for s in range(n - 2, -1, -1):
        bounds[s] = 2 * bounds[s + 1] + radii[s]
    dev = positions.device
    flows = [None] * n
    for s in range(n - 1, -1, -1):
        gh, gw = grids[s]
        if s < n - 1:
            cgh, cgw = grids[s + 1]
            ir = (torch.arange(gh, device=dev) // 2).clamp(0, cgh - 1)
            ic = (torch.arange(gw, device=dev) // 2).clamp(0, cgw - 1)
            pred = 2 * flows[s + 1][:, ir[:, None], ic[None, :]]
        else:
            pred = torch.zeros((s_count, gh, gw, 2), dtype=torch.int32,
                               device=dev)
        g = Level(b=b, h=shapes[s][0], w=shapes[s][1], ws=cfg.winsize,
                  patch=cfg.patchsize, gh=gh, gw=gw, R=radii[s],
                  pred_bound=0 if s == n - 1 else 2 * bounds[s + 1])
        flows[s], _ = flow_level(levels1[s].float(), levels2[s].float(),
                                 pred, g, cfg.propagation)
    h, w = shapes[0]
    gh, gw = grids[0]
    pos_s = torch.floor(positions).to(torch.int32)
    cr = (pos_s[..., 0].clamp(0, h - 1) // cfg.patchsize).clamp(0, gh - 1)
    cc = (pos_s[..., 1].clamp(0, w - 1) // cfg.patchsize).clamp(0, gw - 1)
    flat = torch.where(valid, cr * gw + cc, torch.full_like(cr, gh * gw))
    occ = torch.zeros((s_count, gh * gw + 1), dtype=torch.bool, device=dev)
    occ.scatter_(1, flat.long(), True)
    c = torch.floor(positions / cfg.patchsize).to(torch.int32)
    cell = (c[..., 0].clamp(0, gh - 1) * gw + c[..., 1].clamp(0, gw - 1)) \
        .long()
    matched = valid & occ[:, :gh * gw].gather(1, cell)
    f = flows[0].flatten(1, 2).gather(1, cell[..., None].expand(
        cell.shape + (2,))).to(torch.float32)
    return positions + f, matched


# -- FAST -----------------------------------------------------------------------

def fast_raw(data, b: int, th: int):
    h, w = data.shape[-2] - 2 * b, data.shape[-1] - 2 * b

    def view(dr, dc):
        return data[..., b + dr:b + dr + h, b + dc:b + dc + w].to(torch.int32)
    v = view(0, 0)
    d = torch.stack([view(dr, dc) - v for dr, dc in CIRCLE], dim=0)
    zero = torch.zeros_like(d)
    score = torch.maximum(torch.where(d > th, d, zero).sum(0,
                                                           dtype=torch.int32),
                          torch.where(d < -th, -d, zero).sum(
                              0, dtype=torch.int32))
    weights = torch.tensor([1 << k for k in range(16)], dtype=torch.int64,
                           device=data.device).view((16,) + (1,) * (d.dim()
                                                                     - 1))

    def nine(flags):
        code = (flags.to(torch.int64) * weights).sum(0)
        c2 = code | (code << 16)
        r2 = c2 & (c2 << 1)
        r4 = r2 & (r2 << 2)
        r8 = r4 & (r4 << 4)
        return ((r8 & (c2 << 8)) & 0xFFFF0000) != 0
    return score, nine(d > th) | nine(d < -th)


def block_topk(a, bs: int, k: int):
    """Per-block first maximum of (S, h, w) int scores, then the top k
    block winners (positions (S, k, 2) int32, valid (S, k))."""
    a = a.to(torch.int32)
    h, w = a.shape[-2], a.shape[-1]
    nbr, nbc = -(-h // bs), -(-w // bs)
    p = pad_hw(a, 0, nbr * bs - h, 0, nbc * bs - w, "constant", -1)
    lead = a.shape[:-2]
    flat = p.reshape(lead + (nbr, bs, nbc, bs)).transpose(-3, -2).reshape(
        lead + (nbr, nbc, bs * bs))
    idx, vmax = flat.argmax(-1), flat.amax(-1)
    dev = a.device
    pos_r = torch.arange(nbr, device=dev)[:, None] * bs + idx // bs
    pos_c = torch.arange(nbc, device=dev)[None, :] * bs + idx % bs
    score = vmax.clamp(min=0).flatten(-2)
    cand = torch.stack([pos_r, pos_c], -1).flatten(-3, -2)
    nb = score.shape[-1]
    ar = torch.arange(nb, dtype=torch.int32, device=dev)
    key = torch.where(score > 0, score * nb + (nb - 1 - ar), -1 - ar)
    kk = min(k, nb)
    topv, topi = torch.topk(key, kk, dim=-1, sorted=True)
    pos = cand.gather(-2, topi[..., None].expand(topi.shape + (2,)))
    valid = topv >= 0
    if kk < k:
        pos = torch.cat([pos, torch.zeros(lead + (k - kk, 2), dtype=pos.dtype,
                                          device=dev)], -2)
        valid = torch.cat([valid, torch.zeros(lead + (k - kk,),
                                              dtype=torch.bool, device=dev)],
                          -1)
    return pos.to(torch.int32), valid


# -- state -------------------------------------------------------------------------

TRACKER = ("position", "velocity", "age", "traj", "traj_len")
BACK = ("kf_pose", "kf_valid", "obs_uv", "obs_valid", "lm_X", "lm_valid",
        "lm_desc", "desc_ctr", "age_at_kf", "hist_pose", "hist_frame")


@dataclasses.dataclass
class State:
    """S streams' state: tensors by field name, and the frame and keyframe
    counters (host ints shared by the streams)."""
    t: Dict[str, torch.Tensor]
    frame_id: int
    n_keyframes: int


def from_program(st) -> State:
    """A ``State`` from the program's ``SlamState`` (field names)."""
    kp = st.tracker.keypoints
    t = {"position": kp.position, "velocity": kp.velocity, "age": kp.age,
         "traj": st.tracker.traj, "traj_len": st.tracker.traj_len}
    t.update({f: getattr(st, f) for f in BACK})
    return State(t={k: v.clone() for k, v in t.items()},
                 frame_id=st.tracker.frame_id, n_keyframes=st.n_keyframes)


def init(cfg: Config, boot: torch.Tensor) -> State:
    """The empty state of S streams, keyframes 0 and 1 at ``boot`` (S, 2,
    4, 4)."""
    s, dev = boot.shape[0], boot.device
    k, r, hcap = cfg.capacity, cfg.ring, cfg.history
    f32 = torch.float32
    eye = torch.eye(4, dtype=f32, device=dev)
    kf_pose = eye.expand(s, r, 4, 4).clone()
    kf_pose[:, :2] = boot.to(f32)
    z = dict(dtype=f32, device=dev)
    t = {"position": torch.zeros((s, k, 2), **z),
         "velocity": torch.zeros((s, k, 2), **z),
         "age": torch.zeros((s, k), dtype=torch.int32, device=dev),
         "traj": torch.zeros((s, k, cfg.max_trajectory_length + 1, 2), **z),
         "traj_len": torch.zeros((s, k), dtype=torch.int32, device=dev),
         "kf_pose": kf_pose,
         "kf_valid": torch.zeros((s, r), dtype=torch.bool, device=dev),
         "obs_uv": torch.zeros((s, k, r, 2), **z),
         "obs_valid": torch.zeros((s, k, r), dtype=torch.bool, device=dev),
         "lm_X": torch.zeros((s, k, 3), **z),
         "lm_valid": torch.zeros((s, k), dtype=torch.bool, device=dev),
         "lm_desc": torch.zeros((s, k, cfg.desc_patch ** 2), **z),
         "desc_ctr": torch.zeros((s, k, 2), **z),
         "age_at_kf": torch.zeros((s, k), dtype=torch.int32, device=dev),
         "hist_pose": eye.expand(s, hcap, 4, 4).clone(),
         "hist_frame": torch.full((s, hcap), -1, dtype=torch.int32,
                                  device=dev)}
    return State(t=t, frame_id=-1, n_keyframes=0)


def drop_scatter(out, index, src, keep, dim: int):
    n = out.shape[dim]
    buf = torch.cat([out, out.narrow(dim, 0, 1)], dim=dim)
    idx = torch.where(keep, index, torch.full_like(index, n)).long()
    idx = idx.view(idx.shape + (1,) * (src.dim() - idx.dim())).expand_as(src)
    buf.scatter_(dim, idx, src.to(buf.dtype))
    return buf.narrow(dim, 0, n)


# -- the tracker step --------------------------------------------------------------

def tracker_step(st: State, frame2, b: int, levels1, levels2,
                 cfg: Config) -> None:
    """One tracker step of S streams, in place on ``st``."""
    t = st.t
    frame_id = st.frame_id + 1
    h, w = frame2.shape[-2] - 2 * b, frame2.shape[-1] - 2 * b
    pos, age = t["position"], t["age"]
    alive = age > 0
    mpos, matched = semi_dense(pos, alive, levels1, levels2, b, cfg)
    in_dom = ((mpos[..., 0] >= 0) & (mpos[..., 0] <= h - 1)
              & (mpos[..., 1] >= 0) & (mpos[..., 1] <= w - 1))
    ok = matched & in_dom & alive
    new_pos = torch.where(ok[..., None], mpos, pos)
    vel = torch.where(ok[..., None], new_pos - pos, t["velocity"])
    age = torch.where(ok, age + 1, torch.where(alive, torch.zeros_like(age),
                                               age))
    pos = new_pos

    # merge: the oldest particle of each spacing cell survives
    sp = cfg.keypoint_spacing
    gh, gw = max(h // sp, 1), max(w // sp, 1)
    r = (pos[..., 0] / sp).to(torch.int32).clamp(0, gh - 1)
    c = (pos[..., 1] / sp).to(torch.int32).clamp(0, gw - 1)
    alive = age > 0
    a0 = torch.where(alive, age, torch.zeros_like(age))
    cell = (r * gw + c).long()
    cmax = torch.zeros(a0.shape[:-1] + (gh * gw,), dtype=torch.int32,
                       device=a0.device)
    cmax.scatter_reduce_(-1, cell, a0, "amax", include_self=True)
    age = torch.where(alive & (a0 < cmax.gather(-1, cell)),
                      torch.zeros_like(age), age)

    # cull: FAST score at the rounded, clamped position below 3
    score, flag = fast_raw(frame2, b, cfg.detector_th)
    p = torch.round(pos).to(torch.int32)
    flat = (p[..., 0].clamp(0, h - 1) * w + p[..., 1].clamp(0, w - 1)).long()
    sc = score.flatten(-2).gather(-1, flat)
    age = torch.where((age > 0) & (sc < 3), torch.zeros_like(age), age)

    if frame_id % cfg.detector_period == 0:
        alive = age > 0
        ogh, ogw = -(-h // sp), -(-w // sp)
        r = (pos[..., 0] / sp).to(torch.int32).clamp(0, ogh - 1)
        c = (pos[..., 1] / sp).to(torch.int32).clamp(0, ogw - 1)
        occ = torch.zeros(r.shape[:-1] + (ogh * ogw,), dtype=torch.int32,
                          device=r.device)
        occ.scatter_reduce_(-1, (r * ogw + c).long(), alive.to(torch.int32),
                            "amax", include_self=True)
        occ_p = torch.nn.functional.pad(occ.view(r.shape[:-1] + (ogh, ogw)),
                                        (1, 1, 1, 1))
        dil = torch.zeros(r.shape[:-1] + (ogh, ogw), dtype=torch.bool,
                          device=r.device)
        for dr in (0, 1, 2):
            for dc in (0, 1, 2):
                dil = dil | (occ_p[..., dr:dr + ogh, dc:dc + ogw] != 0)
        mask = (~dil).repeat_interleave(sp, -2).repeat_interleave(sp, -1)
        mask = mask[..., :h, :w]
        img = torch.where(flag & mask,
                          torch.div(score, 16, rounding_mode="floor"),
                          torch.zeros_like(score)).clamp(0, 255)
        dpos, dvalid = block_topk(img, sp, cfg.detect_k)
        # spawn into dead slots in slot order
        n = dpos.shape[-2]
        dead = age <= 0
        dead_rank = torch.cumsum(dead.to(torch.int32), -1,
                                 dtype=torch.int32) - 1
        cand_rank = torch.cumsum(dvalid.to(torch.int32), -1,
                                 dtype=torch.int32) - 1
        n_valid = dvalid.sum(-1, keepdim=True, dtype=torch.int32)
        by_rank = drop_scatter(
            torch.zeros_like(cand_rank), cand_rank,
            torch.arange(n, dtype=torch.int32,
                         device=dpos.device).expand_as(cand_rank),
            dvalid, dim=cand_rank.dim() - 1)
        take = dead & (dead_rank < n_valid)
        src = by_rank.gather(-1, dead_rank.clamp(0, n - 1).long()).long()
        newp = dpos.to(torch.float32).gather(
            -2, src[..., None].expand(src.shape + (2,)))
        pos = torch.where(take[..., None], newp, pos)
        vel = torch.where(take[..., None], torch.zeros_like(vel), vel)
        age = torch.where(take, torch.ones_like(age), age)

    alive = age > 0
    shifted = torch.cat([pos[..., None, :], t["traj"][..., :-1, :]], dim=-2)
    t["traj"] = torch.where(alive[..., None, None], shifted, t["traj"])
    t["traj_len"] = torch.where(
        alive, torch.where(age == 1, torch.ones_like(t["traj_len"]),
                           (t["traj_len"] + 1).clamp(
                               max=cfg.max_trajectory_length)),
        torch.zeros_like(t["traj_len"]))
    t["position"], t["velocity"], t["age"] = pos, vel, age
    st.frame_id = frame_id


# -- the keyframe --------------------------------------------------------------------

def inv3(A):
    """The scaled closed-form Cholesky inverse of SPD 3x3 blocks
    (``slam/ba.py:_inv3``)."""
    dg = torch.stack([A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]], -1)
    s = torch.rsqrt(dg.abs().clamp(min=1e-30))
    A = A * s[..., :, None] * s[..., None, :]
    a11, a21, a31 = A[..., 0, 0], A[..., 1, 0], A[..., 2, 0]
    a22, a32, a33 = A[..., 1, 1], A[..., 2, 1], A[..., 2, 2]
    tiny = 1e-30
    l11 = torch.sqrt(a11.clamp(min=tiny))
    il11 = 1.0 / l11
    l21 = a21 * il11
    l31 = a31 * il11
    l22 = torch.sqrt((a22 - l21 * l21).clamp(min=tiny))
    il22 = 1.0 / l22
    l32 = (a32 - l31 * l21) * il22
    l33 = torch.sqrt((a33 - l31 * l31 - l32 * l32).clamp(min=tiny))
    il33 = 1.0 / l33
    m11, m22, m33 = il11, il22, il33
    m21 = -l21 * il11 * il22
    m31 = (l21 * l32 - l31 * l22) * il11 * il22 * il33
    m32 = -l32 * il22 * il33
    i11 = m11 * m11 + m21 * m21 + m31 * m31
    i12 = m21 * m22 + m31 * m32
    i13 = m31 * m33
    i22 = m22 * m22 + m32 * m32
    i23 = m32 * m33
    i33 = m33 * m33
    inv = torch.stack([torch.stack([i11, i12, i13], -1),
                       torch.stack([i12, i22, i23], -1),
                       torch.stack([i13, i23, i33], -1)], -2)
    return inv * s[..., :, None] * s[..., None, :]


def pnp_gn(T0, X, uv, valid, intr, iters: int, huber: float, lam=1e-4,
           ar: Arith = EXACT):
    """S single-pose Gauss-Newton PnP solves (``slam/ba.py:pnp_gn``)."""
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    T = T0
    for _ in range(iters):
        pred, J, _ = ref_ba.jacobians(T[..., None, :, :], X, intr, ar)
        r = pred - uv
        nrm = torch.linalg.norm(r, dim=-1)
        w = torch.where(nrm <= huber, torch.ones_like(nrm),
                        huber / nrm.clamp(min=1e-12))
        w = torch.where(valid, w, torch.zeros_like(w))
        Jw = J * w[..., None, None]
        H = ar.einsum("...nri,...nrj->...ij", Jw, J) + lam * eye6
        b = -ar.einsum("...nri,...nr->...i", Jw, r)
        L, info = torch.linalg.cholesky_ex(ar.r(H))
        L = ar.r(L)
        y = torch.linalg.solve_triangular(L, ar.r(b)[..., None], upper=False)
        x = torch.linalg.solve_triangular(L.mT, ar.r(y), upper=True)[..., 0]
        x = torch.where((info != 0)[..., None], torch.full_like(x, float("nan")),
                        x)
        T = ar.mm(ref_ba.se3_exp(x, ar), T)
    return T


def projection_matrix(T, intr, ar: Arith = EXACT):
    z = torch.zeros_like(intr[0])
    one = torch.ones_like(intr[0])
    K = torch.stack([intr[0], z, intr[2], z, intr[1], intr[3], z, z,
                     one]).view(3, 3)
    return ar.mm(K, T[..., :3, :])


def triangulate(P1, P2, x1, x2, ar: Arith = EXACT):
    lead = x1.shape[:-1]
    P1 = P1.expand(lead + (3, 4))
    P2 = P2.expand(lead + (3, 4))
    rows = torch.stack([
        x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :]], dim=-2)
    A, b = rows[..., :3], -rows[..., 3]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    AtA = ar.einsum("...ei,...ej->...ij", A, A) + 1e-9 * eye
    Atb = ar.einsum("...ei,...e->...i", A, b)
    return ar.einsum("...ij,...j->...i", inv3(AtA), Atb)


def patches(frame, ctr, size: int):
    """(S, N, size, size) integer-aligned patches around (S, N, 2)
    centres, clamped into the (S, H, W) buffers."""
    h, w = frame.shape[-2], frame.shape[-1]
    tl = ctr.to(torch.int64) - size // 2
    tl = torch.stack([tl[..., 0].clamp(0, h - size),
                      tl[..., 1].clamp(0, w - size)], -1)
    ar = torch.arange(size, device=frame.device)
    rows = (tl[..., 0, None] + ar)[..., :, None]
    cols = (tl[..., 1, None] + ar)[..., None, :]
    si = torch.arange(frame.shape[0], device=frame.device).view(-1, 1, 1, 1)
    return frame[si, rows, cols]


def keyframe_step(st: State, frame, b: int, cfg: Config,
                  control: bool = False) -> None:
    """The keyframe of S streams (recovery off), in place on ``st``; with
    ``control`` every float32 product rounds its operands to TF32 and the
    window's bundle adjustment runs in float32."""
    ar = TF32 if control else EXACT
    t = st.t
    dev = frame.device
    intr = torch.tensor(cfg.intrinsics, dtype=torch.float32, device=dev)
    pos, age = t["position"], t["age"]
    alive = age > 0
    s_n, n, r = t["obs_valid"].shape
    kf = st.n_keyframes
    col = kf % r
    si = torch.arange(s_n, device=dev)
    if kf == 0:
        continuous = torch.zeros_like(alive)
    else:
        continuous = (alive & (t["age_at_kf"] > 0)
                      & (age == t["age_at_kf"] + cfg.keyframe_period))
    obs_valid = t["obs_valid"] & continuous[..., None]
    lm_valid = t["lm_valid"] & continuous
    prev_col = (kf - 1) % r if kf >= 1 else 0
    obs_pos = torch.where(continuous[..., None], pos, torch.round(pos))

    T_prior = t["kf_pose"][:, prev_col]
    tracked = lm_valid & alive
    T_pnp = pnp_gn(T_prior, t["lm_X"], obs_pos, tracked, intr,
                   cfg.pnp_iters, cfg.ba_huber, ar=ar)
    T_new = t["kf_pose"][:, col] if kf < 2 else T_pnp
    kf_pose = t["kf_pose"].clone()
    kf_pose[:, col] = T_new
    kf_valid = t["kf_valid"].clone()
    kf_valid[:, col] = True
    obs_valid[:, :, col] = alive
    obs_uv = t["obs_uv"].clone()
    obs_uv[:, :, col] = obs_pos

    ctr = torch.round(pos).to(torch.int32) + b
    desc = patches(frame, ctr, cfg.desc_patch).reshape(s_n, n, -1).to(
        torch.float32)
    lm_desc = torch.where(alive[..., None], desc, t["lm_desc"])
    desc_ctr = torch.where(alive[..., None], torch.round(pos), t["desc_ctr"])

    kf_ids = kf - torch.arange(r - 1, -1, -1, device=dev)
    cols = torch.remainder(kf_ids, r)
    valid_cols = (kf_ids >= 0) & kf_valid[:, cols]
    obs_at = obs_valid[:, :, cols] & valid_cols[:, None]
    first_ord = torch.argmax(obs_at.to(torch.int32), dim=-1)
    has_two = ((obs_at.sum(-1) >= 2)
               & obs_at.gather(-1, first_ord[..., None])[..., 0])
    first_col = cols[first_ord]
    uv0 = obs_uv.gather(2, first_col[..., None, None].expand(
        s_n, n, 1, 2))[:, :, 0]
    uv1 = obs_pos
    T0 = kf_pose[si[:, None], first_col]
    R_rel = ar.einsum("sij,snkj->snik", T_new[:, :3, :3], T0[..., :3, :3])
    ray = torch.stack([(uv0[..., 1] - intr[2]) / intr[0],
                       (uv0[..., 0] - intr[3]) / intr[1],
                       torch.ones_like(uv0[..., 0])], dim=-1)
    rot = ar.einsum("snij,snj->sni", R_rel, ray)
    zr = torch.where(rot[..., 2].abs() < 1e-6,
                     torch.full_like(rot[..., 2], 1e-6), rot[..., 2])
    uv_rot = torch.stack([intr[1] * rot[..., 1] / zr + intr[3],
                          intr[0] * rot[..., 0] / zr + intr[2]], dim=-1)
    parallax = torch.linalg.norm(uv1 - uv_rot, dim=-1)
    want = (alive & has_two & ~lm_valid & (parallax >= cfg.min_parallax)
            & (first_col != col))
    P1 = projection_matrix(T0, intr, ar)
    P2 = projection_matrix(T_new, intr, ar)[:, None]
    X = triangulate(P1, P2, uv0.flip(-1), uv1.flip(-1), ar)
    z1 = (T0[..., 2, :3] * X).sum(-1) + T0[..., 2, 3]
    z2 = ar.mm(X, T_new[:, 2, :3, None])[..., 0] + T_new[:, None, 2, 3]
    re0 = torch.linalg.norm(ref_ba.project(T0, X, intr, ar) - uv0, dim=-1)
    re1 = torch.linalg.norm(ref_ba.project(T_new[:, None], X, intr, ar)
                            - uv1, dim=-1)
    good = (want & (z1 > 0.05) & (z2 > 0.05) & (re0 < cfg.max_reproj)
            & (re1 < cfg.max_reproj))
    lm_X = torch.where(good[..., None], X, t["lm_X"])
    lm_valid = lm_valid | good

    ir = torch.arange(r, device=dev)
    first2 = torch.argsort(torch.where(valid_cols, ir, torch.full_like(ir, r)),
                           dim=-1, stable=True)[:, :2]
    fixed = torch.zeros((s_n, r), dtype=torch.bool, device=dev)
    fixed.scatter_(1, cols[first2], True)
    fixed = fixed & kf_valid
    ba_valid = obs_valid & lm_valid[..., None] & kf_valid[:, None]
    prob = {"poses": kf_pose, "landmarks": lm_X,
            "obs_pose": ir.to(torch.int32).expand(s_n, n, r),
            "obs_uv": obs_uv, "obs_valid": ba_valid, "fixed": fixed,
            "intrinsics": intr}
    sp, sl, _ = ref_ba.lm(prob, cfg.ba_iters, cfg.ba_huber, cfg.ba_lam0,
                          ring=True, arith="tf32" if control else "float64")
    enough = ba_valid.sum((-2, -1)) >= 12
    kf_pose = torch.where(enough[:, None, None, None], sp.float(), kf_pose)
    lm_X = torch.where(enough[:, None, None], sl.float(), lm_X)
    res = ref_ba.project(kf_pose[:, None], lm_X[:, :, None], intr, ar) \
        - obs_uv
    res = torch.where(ba_valid[..., None], res, torch.zeros_like(res))
    bad = (torch.linalg.norm(res, dim=-1) > cfg.prune_reproj) & ba_valid
    obs_valid = torch.where(enough[:, None, None], obs_valid & ~bad,
                            obs_valid)

    hcap = t["hist_pose"].shape[1]
    hist_frame = t["hist_frame"].clone()
    in_ring = valid_cols & (kf_ids >= 0) & (kf_ids < hcap)
    hist_pose = drop_scatter(t["hist_pose"], kf_ids.expand(s_n, r),
                             kf_pose[:, cols], in_ring, dim=1)
    if kf < hcap:
        hist_frame[:, kf] = st.frame_id
        hist_pose[:, kf] = kf_pose[:, col]
    t.update(kf_pose=kf_pose, kf_valid=kf_valid, obs_uv=obs_uv,
             obs_valid=obs_valid, lm_X=lm_X, lm_valid=lm_valid,
             lm_desc=lm_desc, desc_ctr=desc_ctr, age_at_kf=age.clone(),
             hist_pose=hist_pose, hist_frame=hist_frame)
    st.n_keyframes = kf + 1


def run(st: State, frames, first: int, last: int, cfg: Config,
        control: bool = False) -> State:
    """Steps ``first`` .. ``last - 1`` of (S, T, H, W) clips from ``st``
    (the state after step ``first - 1``), in place; step i tracks frame i
    - 1 (frame 0 against itself) to frame i and runs the keyframe when the
    frame index is a multiple of the period. ``control`` rounds every
    float32 product's operands to TF32 and runs the window's bundle
    adjustment in float32: the nearest precision below the
    configuration's."""
    ar = TF32 if control else EXACT
    b = cfg.border
    lv1 = pyramid(frames[:, max(first - 1, 0)], cfg.nscales, b, ar)
    for i in range(first, last):
        lv2 = pyramid(frames[:, i], cfg.nscales, b, ar)
        tracker_step(st, lv2[0], b, lv1, lv2, cfg)
        if st.frame_id % cfg.keyframe_period == 0:
            keyframe_step(st, lv2[0], b, cfg, control)
        lv1 = lv2
    return st
