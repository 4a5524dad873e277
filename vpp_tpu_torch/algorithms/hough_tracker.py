"""Temporal tracking of Hough-space line peaks (port of
``vpp_tpu.algorithms.hough_tracker``).

Per frame: the dense Hough transform (kernel K7 on the card), the
``m_first_lines`` peaks with exclusion radii, a track ↔ peak cost of
Hough-space distance plus the Pearson correlation of accumulator
neighbourhoods, greedy one-to-one assignment, track update or coasting for
up to ``max_frames_without_update`` frames, births into dead slots, and a
(θ, ρ) trajectory ring per track.

Tracks are a fixed-capacity masked slot array; every step is tensor code
with no host synchronisation. The UKF mode (``with_kalman_filter=True``)
needs ``ukf.py``, which is not ported yet, and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .._device import resolve_device
from ..core.image import Image2d
from ..core.keypoints import drop_scatter
from .hough import HoughLines, hough_accumulator, hough_peaks

_INF = 1e30


@dataclasses.dataclass(frozen=True)
class HoughTrackerConfig:
    """Static knobs; names and defaults are the JAX package's."""
    t_theta: int = 255
    m_first_lines: int = 8
    rayon_exclusion_theta: int = 5
    rayon_exclusion_rho: int = 10
    acc_threshold: float = 30.0
    grad_threshold: float = 40.0
    max_dist_rho: float = 20.0          # gating radii for association
    max_dist_theta: float = 8.0
    appearance_radius: int = 4          # accumulator patch half-width
    appearance_weight: float = 0.5
    max_frames_without_update: int = 5
    capacity: int = 32                  # track slot budget
    traj_len: int = 15
    with_kalman_filter: bool = False


@dataclasses.dataclass
class HoughTrackerState:
    rho: torch.Tensor         # (C,) float32 accumulator-col units
    theta: torch.Tensor       # (C,) float32 accumulator-row units
    votes: torch.Tensor       # (C,)
    age: torch.Tensor         # (C,) int32; 0 = dead
    fwu: torch.Tensor         # (C,) int32 frames without update
    appearance: torch.Tensor  # (C, P, P) accumulator patches
    traj: torch.Tensor        # (C, L, 2) (theta, rho) ring, newest first
    traj_n: torch.Tensor      # (C,) int32
    ukf_x: torch.Tensor       # (C, 5)
    ukf_P: torch.Tensor       # (C, 5, 5)
    frame_id: int


def hough_tracker_init(cfg: HoughTrackerConfig,
                       device="cuda") -> HoughTrackerState:
    """Empty tracker state on ``device`` (the card unless asked for the
    CPU)."""
    dev = resolve_device(device)
    c = cfg.capacity
    p = 2 * cfg.appearance_radius + 1

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return HoughTrackerState(
        rho=zeros(c), theta=zeros(c), votes=zeros(c),
        age=zeros(c, dtype=torch.int32), fwu=zeros(c, dtype=torch.int32),
        appearance=zeros(c, p, p), traj=zeros(c, cfg.traj_len, 2),
        traj_n=zeros(c, dtype=torch.int32), ukf_x=zeros(c, 5),
        ukf_P=torch.eye(5, dtype=torch.float32, device=dev)[None].repeat(
            c, 1, 1),
        frame_id=-1)


def _acc_patches(acc: torch.Tensor, theta_idx: torch.Tensor,
                 rho_idx: torch.Tensor, radius: int) -> torch.Tensor:
    """(N, P, P) accumulator neighbourhoods; θ wraps, ρ clamps."""
    t_theta, rho_bins = acc.shape
    o = torch.arange(-radius, radius + 1, dtype=torch.int64,
                     device=acc.device)
    tt = torch.remainder(theta_idx.long()[:, None, None] + o[None, :, None],
                         t_theta)
    rr = (rho_idx.long()[:, None, None] + o[None, None, :]).clamp(
        0, rho_bins - 1)
    return acc[tt, rr]


def _pearson(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pearson correlation of flattened patch pairs (batched)."""
    af = a.reshape(a.shape[0], -1)
    bf = b.reshape(b.shape[0], -1)
    am = af - af.mean(dim=1, keepdim=True)
    bm = bf - bf.mean(dim=1, keepdim=True)
    num = (am * bm).sum(1)
    den = torch.sqrt((am * am).sum(1) * (bm * bm).sum(1))
    return num / den.clamp(min=1e-9)


def hough_tracker_update(st: HoughTrackerState, frame: Image2d,
                         cfg: HoughTrackerConfig
                         ) -> Tuple[HoughTrackerState, HoughLines]:
    """One tracker step on the frame's device."""
    if cfg.with_kalman_filter:
        raise NotImplementedError(
            "vpp_tpu_torch: with_kalman_filter needs ukf.py, not ported yet")
    c = cfg.capacity
    m = cfg.m_first_lines
    t_theta = cfg.t_theta
    dev = st.rho.device

    acc = hough_accumulator(frame, t_theta=t_theta,
                            grad_threshold=cfg.grad_threshold)
    peaks = hough_peaks(acc, m, exclusion_theta=cfg.rayon_exclusion_theta,
                        exclusion_rho=cfg.rayon_exclusion_rho,
                        acc_threshold=cfg.acc_threshold)
    peak_app = _acc_patches(acc, peaks.theta_idx, peaks.rho_idx,
                            cfg.appearance_radius)

    alive = st.age > 0
    # -- association cost: Hough-space distance + appearance ---------------
    dth = (st.theta[:, None] - peaks.theta_idx[None].to(torch.float32)).abs()
    dth = torch.minimum(dth, t_theta - dth)             # circular θ
    drh = (st.rho[:, None] - peaks.rho_idx[None].to(torch.float32)).abs()
    gate = (dth <= cfg.max_dist_theta) & (drh <= cfg.max_dist_rho)
    space = dth / cfg.max_dist_theta + drh / cfg.max_dist_rho
    ta = st.appearance.reshape(c, -1)
    pa = peak_app.reshape(m, -1)
    tam = ta - ta.mean(dim=1, keepdim=True)
    pam = pa - pa.mean(dim=1, keepdim=True)
    num = tam @ pam.T
    den = torch.sqrt((tam * tam).sum(1)[:, None] * (pam * pam).sum(1)[None, :])
    corr = num / den.clamp(min=1e-9)
    cost = space + cfg.appearance_weight * (1.0 - corr)
    cost = torch.where(gate & alive[:, None] & peaks.valid[None, :], cost,
                       torch.full_like(cost, _INF))

    # -- greedy one-to-one assignment (m iterations, first argmin) ---------
    track_of_peak = torch.full((m,), -1, dtype=torch.int32, device=dev)
    for _ in range(m):
        flat = torch.argmin(cost).view(1)       # 1-element: stays on device
        ti, pi = flat // m, flat % m
        ok = cost.reshape(-1).gather(0, flat) < _INF
        track_of_peak = torch.where(
            ok, track_of_peak.scatter(0, pi, ti.to(torch.int32)),
            track_of_peak)
        cost = torch.where(ok, cost.index_fill(0, ti, _INF).index_fill(
            1, pi, _INF), cost)

    # per-track view: which peak (or none)
    matched_peak = track_of_peak >= 0
    ar = torch.arange(m, dtype=torch.int32, device=dev)
    peak_of_track = drop_scatter(torch.zeros((c,), dtype=torch.int32,
                                             device=dev),
                                 track_of_peak, ar, matched_peak)
    has_match = drop_scatter(torch.zeros((c,), dtype=torch.bool, device=dev),
                             track_of_peak, torch.ones_like(matched_peak),
                             matched_peak)
    pk = torch.where(has_match, peak_of_track,
                     torch.zeros_like(peak_of_track)).long()
    new_rho_det = peaks.rho_idx[pk].to(torch.float32)
    new_th_det = peaks.theta_idx[pk].to(torch.float32)

    ukf_x, ukf_P = st.ukf_x, st.ukf_P
    coast_rho, coast_th = st.rho, st.theta
    matched = alive & has_match
    coasting = alive & ~has_match & (st.fwu < cfg.max_frames_without_update)
    survive = matched | coasting

    rho = torch.where(matched, new_rho_det,
                      torch.where(coasting, coast_rho, st.rho))
    theta = torch.where(matched, new_th_det,
                        torch.where(coasting, coast_th, st.theta))
    votes = torch.where(matched, peaks.votes[pk], st.votes)
    age = torch.where(survive, st.age + 1, torch.zeros_like(st.age))
    fwu = torch.where(matched, torch.zeros_like(st.fwu),
                      torch.where(coasting, st.fwu + 1, st.fwu))
    appearance = torch.where(matched[:, None, None], peak_app[pk],
                             st.appearance)

    # -- births: unmatched valid peaks into dead slots ---------------------
    unmatched_peak = peaks.valid & (track_of_peak < 0)
    dead = ~survive
    dead_rank = torch.cumsum(dead.to(torch.int32), 0, dtype=torch.int32) - 1
    cand_rank = torch.cumsum(unmatched_peak.to(torch.int32), 0,
                             dtype=torch.int32) - 1
    n_cand = unmatched_peak.sum(dtype=torch.int32)
    cand_by_rank = drop_scatter(torch.zeros((m,), dtype=torch.int32,
                                            device=dev),
                                cand_rank, ar, unmatched_peak)
    take = dead & (dead_rank < n_cand)
    src = cand_by_rank[dead_rank.clamp(0, m - 1).long()].long()
    rho = torch.where(take, peaks.rho_idx[src].to(torch.float32), rho)
    theta = torch.where(take, peaks.theta_idx[src].to(torch.float32), theta)
    votes = torch.where(take, peaks.votes[src], votes)
    age = torch.where(take, torch.ones_like(age), age)
    fwu = torch.where(take, torch.zeros_like(fwu), fwu)
    appearance = torch.where(take[:, None, None], peak_app[src], appearance)
    ukf_x = ukf_x.clone()
    ukf_x[:, 0] = torch.where(take, rho, ukf_x[:, 0])
    ukf_x[:, 1] = torch.where(take, theta, ukf_x[:, 1])

    # -- Hough-space trajectory ring ---------------------------------------
    live = age > 0
    head = torch.stack([theta, rho], dim=-1)[:, None, :]
    shifted = torch.cat([head, st.traj[:, :-1]], dim=1)
    traj = torch.where(live[:, None, None], shifted, st.traj)
    traj_n = torch.where(
        live,
        torch.where(take | (age == 1), torch.ones_like(st.traj_n),
                    (st.traj_n + 1).clamp(max=cfg.traj_len)),
        torch.zeros_like(st.traj_n))

    out = HoughTrackerState(rho=rho, theta=theta, votes=votes, age=age,
                            fwu=fwu, appearance=appearance, traj=traj,
                            traj_n=traj_n, ukf_x=ukf_x, ukf_P=ukf_P,
                            frame_id=st.frame_id + 1)
    return out, peaks
