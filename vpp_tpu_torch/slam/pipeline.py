"""End-to-end SLAM engine: tracker -> keyframes -> triangulation ->
sliding-window BA, with tracking recovery, loop closure and a pose-graph
smoother over the keyframe history (port of ``vpp_tpu.slam.pipeline``).

The design is the JAX package's, slot-parallel and of static shape: the
tracker's keypoint slot IS the landmark id, keyframes live in a ring of
``cfg.ring`` columns that is the BA window, and the observation matrix
(N, R) is a ring-layout ``BATracks`` problem. New landmarks triangulate
from their oldest and newest ring observations, keyframe poses come from a
Gauss-Newton PnP against the live map, and the window refines with
``ba_solve_tracks``, which on the card runs kernel K6. Every keyframe also
archives its new landmarks; with ``enable_recovery`` (the default) one FAST
pass per keyframe matches the frame against that archive
(``_archive_pnp``): the full archive re-localises a starved tracker, the
entries at least ``lc_min_gap`` frames old measure a revisit, which
becomes a loop-closure edge, and a pose-graph smoother
(``slam/pose_graph.py``) pulls the keyframe history onto the closures.
``relocalize`` runs the same map vote (``_map_vote_pnp``, kernel K8 on the
card) against the live map.

PyTorch runs eagerly, so ``slam_step``'s keyframe branch is a host ``if``
on the frame count, and ``SlamState.n_keyframes`` is a Python int like the
tracker's ``frame_id``: the ring column, the history indices and the
bootstrap test are host arithmetic. Everything that depends on data (the
BA gate, the LM accept, the archive pointer, the lost flag, the recovery
and closure gates, the loop-closure ring's writes) stays on the device and
selects with ``torch.where``. A keyframe of ``enable_recovery=False`` makes
no host read. A keyframe with recovery makes exactly one: the two flags
(closure accepted now, any closure edge stored) that pick the smoother's
branch, a full double solve, a 2-iteration refresh or nothing, where the
JAX package's two ``lax.cond`` run only the chosen branch; running every
branch and selecting would cost 18 Gauss-Newton iterations a keyframe,
each a dense (6H, 6H) solve.

Streams. The tracker step (``video_extruder._tracker_step``) and the
keyframe (``_keyframe_step``) are written once, for S independent streams:
every tensor of the state carries a leading S, frames come as (S, H+2b,
W+2b) buffers, and each kernel launches once for every stream.
``slam_step``, ``slam_run`` and ``_do_keyframe`` run them at S = 1 through
views; ``slam_run_streams`` (the serving entry point: S clips at once)
runs them at S. The frame index, not the data, decides the keyframe
cadence, so ``n_keyframes`` and the tracker's ``frame_id`` stay host ints
shared by the streams. The recovery branch (archive PnP, loop closure,
smoother) runs at S = 1 only; ``slam_run_streams`` refuses it, as the JAX
package does.

Sharded BA: ``slam_step``, ``slam_run`` and the keyframe take a process
mesh (``parallel/mesh.py``) and an axis, as in the JAX package, and pass
them to the window BA, whose landmarks shard over the axis (capacity
divisible by its size; ``slam.ba``). Every rank runs the rest, the tracker
included, on the same frames, so the ranks hold the same state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .._device import device_constant, resolve_device
from ..algorithms.fast import fast9
from ..algorithms.geometry import triangulate_ls
from ..algorithms.pyramid import pyramid as build_pyramid, pyramid_streams
from ..algorithms.video_extruder import (VideoExtruderConfig,
                                         VideoExtruderState, _levels,
                                         _tracker_step, video_extruder_init)
from ..core.image import Image2d, _as_tensor
from ..core.interp import extract_patches, extract_patches_bilinear
from ..core.keypoints import drop_scatter
from ..core.streams import drop, lift, stack
from .ba import (BATracks, ba_solve_tracks, pnp_gn, project,
                 track_residuals)
from .map_vote import map_vote_pnp
from .pose_graph import PoseGraph, pose_graph_residuals, pose_graph_solve
from .se3 import se3_inverse


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Static pipeline knobs; names, defaults and meanings are the JAX
    package's. ``tracker.capacity`` is also the landmark table size;
    ``ring`` is the sliding-window length (BA poses); ``enable_recovery``
    runs the archive PnP (tracking recovery and loop-closure measurement)
    and the pose-graph smoother every keyframe."""
    intrinsics: Tuple[float, float, float, float]   # fx, fy, cx, cy
    keyframe_period: int = 4
    ring: int = 8
    ba_iters: int = 3
    ba_huber: float = 4.0
    ba_lam0: float = 1e-4
    ba_linalg: str = "chol"
    prune_reproj: float = 1.5
    subpix_refine: bool = False
    min_parallax: float = 3.0
    max_reproj: float = 3.0
    pnp_iters: int = 6
    history: int = 64
    desc_patch: int = 7
    archive_size: int = 1024
    lc_slots: int = 8
    lc_min_inliers: int = 12
    lc_max_err: float = 1.5
    lc_min_gap: int = 12
    lc_search_radius: float = 8.0
    lc_appearance_gate: float = 0.35
    rec_max_err: float = 6.0
    pg_lost_w: float = 0.05
    lc_dcs_c: float = 0.3
    lc_vote_range: float = 1.2
    pose_graph_iters: int = 8
    min_tracked: int = 10
    enable_recovery: bool = True
    tracker: VideoExtruderConfig = dataclasses.field(
        default_factory=lambda: VideoExtruderConfig(
            capacity=512, detect_k=256, nscales=3, winsize=9,
            keypoint_spacing=10, detector_period=1))


@dataclasses.dataclass
class SlamState:
    """The engine's state; S streams carry a leading S on every tensor."""
    tracker: VideoExtruderState
    kf_pose: torch.Tensor       # (R, 4, 4) ring of keyframe poses
    kf_valid: torch.Tensor      # (R,) bool
    obs_uv: torch.Tensor        # (N, R, 2) pixel obs per slot x ring column
    obs_valid: torch.Tensor     # (N, R) bool
    lm_X: torch.Tensor          # (N, 3) landmark positions
    lm_valid: torch.Tensor      # (N,) bool
    lm_desc: torch.Tensor       # (N, P*P) patch descriptor (latest keyframe)
    desc_ctr: torch.Tensor      # (N, 2) integer centre lm_desc was cut at
    age_at_kf: torch.Tensor     # (N,) tracker age at the last keyframe
    n_keyframes: int            # keyframes so far (a host int)
    hist_pose: torch.Tensor     # (H, 4, 4) global keyframe trajectory
    hist_frame: torch.Tensor    # (H,) int32 frame id per keyframe (-1 empty)
    arch_X: torch.Tensor        # (A, 3) archived landmark positions
    arch_desc: torch.Tensor     # (A, P*P) descriptor at archive time
    arch_frame: torch.Tensor    # (A,) int32 frame id archived at (-1 empty)
    arch_ptr: torch.Tensor      # () int32 ring write pointer
    arch_of_slot: torch.Tensor  # (N,) int32 slot -> archive row (-1 none)
    pg_T: torch.Tensor          # (H, 4, 4) odometry edge k-1 -> k
    pg_w: torch.Tensor          # (H,) odometry edge weight
    lc_j: torch.Tensor          # (L,) int32 loop-closure target keyframe
    lc_T: torch.Tensor          # (L, 4, 4) measured absolute pose
    lc_w: torch.Tensor          # (L,) float32 edge weight (0 = empty)
    lc_ptr: torch.Tensor        # () int32 ring write pointer


def _eye4(*lead: int, device) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device).expand(
        lead + (4, 4)).clone()


def slam_init(cfg: SlamConfig, bootstrap_poses=None,
              device="cuda") -> SlamState:
    """Empty state on ``device``. ``bootstrap_poses``: (2, 4, 4) poses of
    the first two keyframes (they pin the gauge and the monocular scale);
    identity for both when omitted."""
    dev = resolve_device(device)
    n, r = cfg.tracker.capacity, cfg.ring
    f32, i32 = torch.float32, torch.int32
    kf_pose = _eye4(r, device=dev)
    if bootstrap_poses is not None:
        kf_pose[0:2] = _as_tensor(bootstrap_poses, dev).to(f32)
    p2 = cfg.desc_patch ** 2
    return SlamState(
        tracker=video_extruder_init(cfg.tracker, device=dev),
        kf_pose=kf_pose,
        kf_valid=torch.zeros((r,), dtype=torch.bool, device=dev),
        obs_uv=torch.zeros((n, r, 2), dtype=f32, device=dev),
        obs_valid=torch.zeros((n, r), dtype=torch.bool, device=dev),
        lm_X=torch.zeros((n, 3), dtype=f32, device=dev),
        lm_valid=torch.zeros((n,), dtype=torch.bool, device=dev),
        lm_desc=torch.zeros((n, p2), dtype=f32, device=dev),
        desc_ctr=torch.zeros((n, 2), dtype=f32, device=dev),
        age_at_kf=torch.zeros((n,), dtype=i32, device=dev),
        n_keyframes=0,
        hist_pose=_eye4(cfg.history, device=dev),
        hist_frame=torch.full((cfg.history,), -1, dtype=i32, device=dev),
        arch_X=torch.zeros((cfg.archive_size, 3), dtype=f32, device=dev),
        arch_desc=torch.zeros((cfg.archive_size, p2), dtype=f32, device=dev),
        arch_frame=torch.full((cfg.archive_size,), -1, dtype=i32,
                              device=dev),
        arch_ptr=torch.zeros((), dtype=i32, device=dev),
        arch_of_slot=torch.full((n,), -1, dtype=i32, device=dev),
        pg_T=_eye4(cfg.history, device=dev),
        pg_w=torch.ones((cfg.history,), dtype=f32, device=dev),
        lc_j=torch.zeros((cfg.lc_slots,), dtype=i32, device=dev),
        lc_T=_eye4(cfg.lc_slots, device=dev),
        lc_w=torch.zeros((cfg.lc_slots,), dtype=f32, device=dev),
        lc_ptr=torch.zeros((), dtype=i32, device=dev))


def _projection_matrix(T: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) P = K [R|t] in (x=col, y=row) convention."""
    z = torch.zeros_like(intr[0])
    one = torch.ones_like(intr[0])
    K = torch.stack([intr[0], z, intr[2], z, intr[1], intr[3],
                     z, z, one]).view(3, 3)
    return K @ T[..., :3, :]


def _refine_obs_subpix(frame: Image2d, pos: torch.Tensor,
                       templ: torch.Tensor, valid: torch.Tensor, patch: int,
                       iters: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sub-pixel KLT alignment of each slot's position against its stored
    template (``lm_desc``): ``_refine_subpix`` on one frame."""
    refined, ok = _refine_subpix(frame.data[None], frame.border, pos[None],
                                 templ[None], valid[None], patch, iters)
    return refined[0], ok[0]


def _refine_subpix(data: torch.Tensor, b: int, pos: torch.Tensor,
                   templ: torch.Tensor, valid: torch.Tensor, patch: int,
                   iters: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sub-pixel KLT alignment of S streams' slots (pos (S, N, 2)) against
    their templates in the (S, H+2b, W+2b) frames: forward-additive
    Gauss-Newton on a pure translation, batched over slots, bilinear
    samples of the frame and of its central-difference gradient
    (``torch.gradient``, one-sided at the edges, as ``jnp.gradient``).
    Returns (refined (S, N, 2), ok (S, N)); ``ok`` is False where the
    alignment diverged or the patch no longer matches its template (see
    the JAX module for why that gate matters)."""
    data = data.to(torch.float32)
    gr, gc = torch.gradient(data, dim=(1, 2))
    grad = torch.stack([gr, gc], dim=-1)
    t = templ.reshape(templ.shape[:2] + (patch, patch))
    p = pos
    for _ in range(iters):
        smp = extract_patches_bilinear(data, p + b, patch, streams=True)
        g = extract_patches_bilinear(grad, p + b, patch, streams=True)
        r = smp - t
        g1, g2 = g[..., 0], g[..., 1]
        a11 = (g1 * g1).sum((-2, -1))
        a12 = (g1 * g2).sum((-2, -1))
        a22 = (g2 * g2).sum((-2, -1))
        b1 = (g1 * r).sum((-2, -1))
        b2 = (g2 * r).sum((-2, -1))
        det = a11 * a22 - a12 * a12
        inv = torch.where(det.abs() > 1e-8, 1.0 / det,
                          torch.zeros_like(det))
        step = -torch.stack([(a22 * b1 - a12 * b2) * inv,
                             (a11 * b2 - a12 * b1) * inv], dim=-1)
        p = p + step.clamp(-1.0, 1.0)
    drift = torch.linalg.norm(p - pos, dim=-1)
    smp = extract_patches_bilinear(data, p + b, patch, streams=True)
    sad = (smp - t).abs().sum((-2, -1))
    energy = t.abs().sum((-2, -1)).clamp(min=1.0)
    ok = valid & (drift <= 0.75) & (sad < 0.08 * energy)
    return torch.where(ok[..., None], p, pos), ok


def _det_shift_patches(frame: Image2d, pos: torch.Tensor,
                       patch: int) -> torch.Tensor:
    """(9, K, patch²) patches around each detection at the 9 ±1-px shifts,
    the appearance-gate templates of ``_map_vote_pnp``: one K5 launch of
    (patch + 2)² patches, then 9 static sub-views of it."""
    big = extract_patches(frame.data, pos + frame.border, patch + 2)
    return torch.stack([big[:, dr:dr + patch, dc:dc + patch].reshape(
        -1, patch * patch) for dr in range(3) for dc in range(3)])


def _vote_args(cfg: SlamConfig, rounds: int = 2) -> dict:
    """``map_vote_pnp``'s scalars from the configuration."""
    return dict(r_wide=3.0 * cfg.lc_search_radius,
                bmax=float(cfg.lc_vote_range), gate=cfg.lc_appearance_gate,
                rounds=rounds, pnp_iters=cfg.pnp_iters, huber=cfg.ba_huber)


def _map_vote_pnp(X: torch.Tensor, desc: torch.Tensor, base: torch.Tensor,
                  pos: torch.Tensor, valid: torch.Tensor, frame: Image2d,
                  cfg: SlamConfig, T_prior: torch.Tensor, intr: torch.Tensor,
                  *, rounds: int = 2, det_patches: torch.Tensor = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Drift-robust PnP of a frame's FAST detections against a landmark
    map (``X`` (A, 3), ``desc`` (A, P²), ``base`` (A,) usable entries): the
    matching routine behind tracking recovery, loop-closure measurement and
    ``relocalize``. ``rounds`` translation-consensus vote rounds (each
    shifting the pose by its histogram peak), then each entry's candidate
    nearest that peak, gated by the min-over-±1-px-shift SAD against the
    entry's descriptor, feeds two Huber PnP solves on the same pair set:
    one K8 launch on the card (``map_vote.map_vote_pnp``). Returns (T, err,
    n): the pose, the mean PnP reprojection error, and the number of
    distinct detections among the inlier pairs (0-d tensors)."""
    if det_patches is None:
        det_patches = _det_shift_patches(frame, pos, cfg.desc_patch)
    out = map_vote_pnp(X, desc, base[None], pos, valid, det_patches, T_prior,
                       intr, **_vote_args(cfg, rounds))
    return out.T[0], out.err[0], out.n[0]


def _archive_pnp(state: SlamState, frame2: Image2d, cfg: SlamConfig,
                 T_prior: torch.Tensor, intr: torch.Tensor,
                 min_frame_gap: int):
    """PnP of the frame against the landmark archive, as two match sets of
    one ``map_vote_pnp`` call (one K8 launch on the card):
    ((T_rec, err_rec, n_rec), (T_lc, err_lc, n_lc)), against every filled
    entry (tracking recovery) and against the entries at least
    ``min_frame_gap`` frames old (the revisit that measures a loop
    closure). One blockwise FAST pass (K2, K3) and one patch extraction
    (K5) serve both."""
    pos, _, valid = fast9(frame2, cfg.tracker.detector_th,
                          k=cfg.tracker.detect_k, blockwise=True,
                          block_size=cfg.tracker.keypoint_spacing)
    filled = state.arch_frame >= 0
    old_enough = filled & (state.arch_frame
                           <= state.tracker.frame_id - min_frame_gap)
    det_patches = _det_shift_patches(frame2, pos, cfg.desc_patch)
    out = map_vote_pnp(state.arch_X, state.arch_desc,
                       torch.stack([filled, old_enough]), pos, valid,
                       det_patches, T_prior, intr, **_vote_args(cfg))
    return ((out.T[0], out.err[0], out.n[0]),
            (out.T[1], out.err[1], out.n[1]))


def _smoother_branch(lc_good: torch.Tensor,
                     lc_w: torch.Tensor) -> Tuple[bool, bool]:
    """(a closure accepted at this keyframe, any closure edge stored): the
    one host read of a keyframe with recovery, which picks the smoother's
    branch."""
    new_closure, any_closure = torch.stack(
        [lc_good, (lc_w > 0).any()]).tolist()
    return new_closure, any_closure


def _smooth_history(hist: torch.Tensor, pg_T: torch.Tensor,
                    pg_w: torch.Tensor, lc_j: torch.Tensor,
                    lc_T: torch.Tensor, lc_w: torch.Tensor, kf: int,
                    cfg: SlamConfig, *, full: bool) -> torch.Tensor:
    """The pose-graph smoother over the keyframe history: the odometry
    chain plus the absolute revisit edges from the gauge node 0, nodes
    beyond keyframe ``kf`` fixed. With ``full`` (a keyframe that accepted a
    new closure) two ``pose_graph_iters`` solves, the second with the
    closures reweighted by the Dynamic Covariance Scaling kernel of their
    residuals at the first's poses; else a 2-iteration refresh with those
    weights taken at the current history. Returns the smoothed (H, 4, 4)
    history; it does not feed back into the live window."""
    hcap, lc_cap = hist.shape[0], lc_w.shape[0]
    dev = hist.device
    k_ids = torch.arange(hcap, dtype=torch.int32, device=dev)
    last = min(kf, hcap - 1)
    edge_i = torch.cat([(k_ids - 1).clamp(min=0),
                        torch.zeros((lc_cap,), dtype=torch.int32,
                                    device=dev)])
    edge_j = torch.cat([k_ids, lc_j])
    edge_valid = torch.cat([(k_ids >= 1) & (k_ids <= last), lc_w > 0])
    fixed = (k_ids == 0) | (k_ids > last)
    c2 = device_constant((cfg.lc_dcs_c ** 2,), torch.float32, dev)

    def build(h, lcw):
        return PoseGraph(poses=h, edge_i=edge_i, edge_j=edge_j,
                         edge_T=torch.cat([pg_T, se3_inverse(h[0]) @ lc_T]),
                         edge_w=torch.cat([pg_w, lcw]),
                         edge_valid=edge_valid, fixed=fixed)

    def dcs_weights(g):
        res = pose_graph_residuals(g)[hcap:]
        return (2.0 * c2 / (c2 + (res * res).sum(-1))).clamp(max=1.0)

    if full:
        g = build(hist, lc_w)
        solved, _ = pose_graph_solve(g, iters=cfg.pose_graph_iters)
        s = dcs_weights(g._replace(poses=solved.poses))
        solved, _ = pose_graph_solve(build(solved.poses, lc_w * s),
                                     iters=cfg.pose_graph_iters)
        return solved.poses
    s = dcs_weights(build(hist, lc_w))
    solved, _ = pose_graph_solve(build(hist, lc_w * s), iters=2)
    return solved.poses


def _do_keyframe(state: SlamState, frame2: Image2d, cfg: SlamConfig,
                 mesh=None, axis: str = "lm") -> SlamState:
    """Keyframe work of one stream: ``_keyframe_step`` at S = 1, the window
    BA's landmarks sharded over ``axis`` of ``mesh`` where one is given."""
    return drop(_keyframe_step(lift(state), frame2.data[None], frame2.border,
                              cfg, mesh=mesh, axis=axis))


def _recovery(state: SlamState, frame: torch.Tensor, border: int,
              cfg: SlamConfig, T_prior: torch.Tensor, intr: torch.Tensor):
    """``_archive_pnp`` of a one-stream keyframe, each result with the
    stream's leading 1. The recovery branch is single-stream:
    ``slam_run_streams`` refuses it."""
    if frame.shape[0] != 1:
        raise ValueError("the recovery branch (enable_recovery) runs one "
                         "stream at a time")
    out = _archive_pnp(drop(state), Image2d(data=frame[0], border=border),
                       cfg, T_prior[0], intr, cfg.lc_min_gap)
    return tuple(tuple(t[None] for t in pnp) for pnp in out)


def _keyframe_step(state: SlamState, frame: torch.Tensor, border: int,
                  cfg: SlamConfig, mesh=None, axis: str = "lm") -> SlamState:
    """Keyframe work of S streams: obs write -> PnP pose -> triangulate ->
    window BA -> prune -> archive and history writes. ``state`` carries a
    leading S, ``frame`` is (S, H+2b, W+2b) with border ``border``; K5 and
    K6 launch once for every stream. Float32 with TF32 off (the JAX
    package runs this at "highest" matmul precision); the window BA's
    landmark blocks are float64 (``slam/ba.py``). No host read without
    recovery."""
    dev = state.lm_X.device
    intr = device_constant(cfg.intrinsics, torch.float32, dev)
    kps = state.tracker.keypoints
    alive = kps.alive                                            # (S, N)
    n_streams, n, r = state.obs_valid.shape
    kf = state.n_keyframes               # index of the NEW keyframe (int)
    col = kf % r
    frame_id = state.tracker.frame_id
    si = torch.arange(n_streams, device=dev)

    # --- slot continuity (age handshake) -----------------------------
    if kf == 0:
        continuous = torch.zeros_like(alive)
    else:
        continuous = (alive & (state.age_at_kf > 0)
                      & (kps.age == state.age_at_kf + cfg.keyframe_period))
    obs_valid = state.obs_valid & continuous[..., None]
    lm_valid = state.lm_valid & continuous

    # new rows observe at the integer centre their template is cut at
    prev_col = (kf - 1) % r if kf >= 1 else 0
    obs_pos = torch.where(continuous[..., None], kps.position,
                          torch.round(kps.position))
    if cfg.subpix_refine:
        # continuing rows chain the sub-pixel motion of the previous
        # keyframe's patch onto its refined observation
        refined, ref_ok = _refine_subpix(
            frame, border, kps.position, state.lm_desc, continuous & alive,
            cfg.desc_patch)
        chain = state.obs_uv[:, :, prev_col] + (refined - state.desc_ctr)
        near = (chain - kps.position).abs().amax(-1) <= 1.5
        obs_pos = torch.where((continuous & ref_ok & near)[..., None],
                              chain, obs_pos)

    # --- pose estimate for this keyframe (PnP on live landmarks) ------
    T_prior = state.kf_pose[:, prev_col]                        # (S, 4, 4)
    tracked = lm_valid & alive
    T_pnp, _ = pnp_gn(T_prior, state.lm_X, obs_pos, tracked, intr,
                      iters=cfg.pnp_iters, huber=cfg.ba_huber)
    lost = tracked.sum(-1) < cfg.min_tracked                    # (S,)

    # --- tracking-lost recovery and loop-closure measurement ----------
    if cfg.enable_recovery:
        (T_rec, err_rec, n_rec), (T_lc, err_lc, n_lc) = _recovery(
            state, frame, border, cfg, T_prior, intr)
        rec_ok = (n_rec >= cfg.lc_min_inliers) & (err_rec < cfg.rec_max_err)
        T_pnp = torch.where((lost & rec_ok)[:, None, None], T_rec, T_pnp)
    # bootstrap: keyframes 0 and 1 keep their preset (gauge/scale) poses
    T_new = state.kf_pose[:, col] if kf < 2 else T_pnp

    kf_pose = state.kf_pose.clone()
    kf_pose[:, col] = T_new
    kf_valid = state.kf_valid.clone()
    kf_valid[:, col].fill_(True)   # fills on the device (no host copy)

    # --- write this keyframe's observations ---------------------------
    obs_valid[:, :, col] = alive       # obs_valid is a new tensor here
    obs_uv = state.obs_uv.clone()
    obs_uv[:, :, col] = obs_pos

    # descriptors: every live slot carries its latest appearance (K5)
    ctr = torch.round(kps.position).to(torch.int32) + border
    desc = extract_patches(frame, ctr, cfg.desc_patch).reshape(
        n_streams, n, -1).to(torch.float32)
    lm_desc = torch.where(alive[..., None], desc, state.lm_desc)
    desc_ctr = torch.where(alive[..., None], torch.round(kps.position),
                           state.desc_ctr)

    # --- triangulate new landmarks ------------------------------------
    # ring columns from the oldest keyframe (kf - r + 1) to the newest
    kf_ids = kf - torch.arange(r - 1, -1, -1, device=dev)
    cols = torch.remainder(kf_ids, r)
    valid_cols = (kf_ids >= 0) & kf_valid[:, cols]                # (S, R)
    obs_at = obs_valid[:, :, cols] & valid_cols[:, None]        # (S, N, R)
    # first True (argmax on bools picks the first in JAX): int32 keys
    first_ord = torch.argmax(obs_at.to(torch.int32), dim=-1)
    has_two = ((obs_at.sum(-1) >= 2)
               & obs_at.gather(-1, first_ord[..., None])[..., 0])
    first_col = cols[first_ord]                                 # (S, N)
    uv0 = obs_uv.gather(2, first_col[..., None, None].expand(
        n_streams, n, 1, 2))[:, :, 0]
    uv1 = obs_pos
    # rotation-compensated parallax (see the JAX module)
    T0 = kf_pose[si[:, None], first_col]                     # (S, N, 4, 4)
    R_rel = torch.einsum("sij,snkj->snik", T_new[:, :3, :3],
                         T0[..., :3, :3])
    ray = torch.stack([(uv0[..., 1] - intr[2]) / intr[0],
                       (uv0[..., 0] - intr[3]) / intr[1],
                       torch.ones_like(uv0[..., 0])], dim=-1)
    rot = torch.einsum("snij,snj->sni", R_rel, ray)
    zr = torch.where(rot[..., 2].abs() < 1e-6,
                     torch.full_like(rot[..., 2], 1e-6), rot[..., 2])
    uv_rot = torch.stack([intr[1] * rot[..., 1] / zr + intr[3],
                          intr[0] * rot[..., 0] / zr + intr[2]], dim=-1)
    parallax = torch.linalg.norm(uv1 - uv_rot, dim=-1)
    want = (alive & has_two & ~lm_valid & (parallax >= cfg.min_parallax)
            & (first_col != col))

    P1 = _projection_matrix(T0, intr)                        # (S, N, 3, 4)
    P2 = _projection_matrix(T_new, intr)[:, None]            # (S, 1, 3, 4)
    X = triangulate_ls(P1, P2, uv0.flip(-1), uv1.flip(-1))
    # acceptance: in front of both cameras + reprojection sanity
    z1 = (T0[..., 2, :3] * X).sum(-1) + T0[..., 2, 3]
    z2 = (X @ T_new[:, 2, :3, None])[..., 0] + T_new[:, None, 2, 3]
    re0 = torch.linalg.norm(project(T0, X, intr) - uv0, dim=-1)
    re1 = torch.linalg.norm(project(T_new[:, None], X, intr) - uv1, dim=-1)
    good = (want & (z1 > 0.05) & (z2 > 0.05) & (re0 < cfg.max_reproj)
            & (re1 < cfg.max_reproj))
    lm_X = torch.where(good[..., None], X, state.lm_X)
    lm_valid = lm_valid | good

    # --- sliding-window bundle adjustment ------------------------------
    # fix the two oldest valid keyframes in the ring (gauge + scale)
    ar = torch.arange(r, device=dev)
    first2_ord = torch.argsort(torch.where(valid_cols, ar,
                                           torch.full_like(ar, r)),
                               dim=-1, stable=True)[:, :2]
    fixed = torch.zeros((n_streams, r), dtype=torch.bool, device=dev)
    fixed.scatter_(1, cols[first2_ord], True)
    fixed = fixed & kf_valid
    ba_obs_valid = obs_valid & lm_valid[..., None] & kf_valid[:, None]
    prob = BATracks(poses=kf_pose, landmarks=lm_X,
                    obs_pose=ar.to(torch.int32).expand(n_streams, n, r),
                    obs_uv=obs_uv, obs_valid=ba_obs_valid, intrinsics=intr,
                    fixed_poses=fixed)
    enough = ba_obs_valid.sum((-2, -1)) >= 12                    # (S,)
    solved, _ = ba_solve_tracks(prob, iters=cfg.ba_iters, huber=cfg.ba_huber,
                                lam0=cfg.ba_lam0, mesh=mesh, axis=axis,
                                ring_layout=True, linalg=cfg.ba_linalg)
    kf_pose = torch.where(enough[:, None, None, None], solved.poses, kf_pose)
    lm_X = torch.where(enough[:, None, None], solved.landmarks, lm_X)

    # post-BA outlier pruning of observations that still reproject badly
    res = track_residuals(solved._replace(poses=kf_pose, landmarks=lm_X),
                          ring_layout=True)
    bad = (torch.linalg.norm(res, dim=-1) > cfg.prune_reproj) & ba_obs_valid
    obs_valid = torch.where(enough[:, None, None], obs_valid & ~bad,
                            obs_valid)

    # --- archive new landmarks (the loop-closure / recovery map) -------
    a_cap = state.arch_X.shape[1]
    # refresh entries whose slot is still live, then append the new ones
    arch_X = drop_scatter(state.arch_X, state.arch_of_slot, lm_X,
                          lm_valid & (state.arch_of_slot >= 0), dim=1)
    a_off = torch.cumsum(good.to(torch.int32), -1, dtype=torch.int32) - 1
    a_idx = torch.where(good, torch.remainder(state.arch_ptr[:, None] + a_off,
                                              a_cap),
                        torch.full_like(a_off, a_cap))
    arch_X = drop_scatter(arch_X, a_idx, lm_X, good, dim=1)
    arch_desc = drop_scatter(state.arch_desc, a_idx, desc, good, dim=1)
    arch_frame = drop_scatter(state.arch_frame, a_idx,
                              torch.full_like(a_idx, frame_id), good, dim=1)
    arch_ptr = torch.remainder(
        state.arch_ptr + good.sum(-1, dtype=torch.int32), a_cap)
    minus1 = torch.full_like(state.arch_of_slot, -1)
    arch_of_slot = torch.where(
        good, a_idx.clamp(max=a_cap - 1),
        torch.where(lm_valid, state.arch_of_slot, minus1))
    # ring-wrap invalidation: clear pointers whose row was just overwritten
    overwritten = drop_scatter(
        torch.zeros((n_streams, a_cap), dtype=torch.bool, device=dev), a_idx,
        torch.ones_like(good), good, dim=1)
    stale = ((arch_of_slot >= 0) & ~good
             & overwritten.gather(1, arch_of_slot.clamp(0, a_cap - 1).long()))
    arch_of_slot = torch.where(stale, minus1, arch_of_slot)

    # --- trajectory history -------------------------------------------
    hcap = state.hist_pose.shape[1]
    hist_frame = state.hist_frame.clone()
    in_ring = valid_cols & (kf_ids >= 0) & (kf_ids < hcap)
    hist_pose = drop_scatter(state.hist_pose, kf_ids, kf_pose[:, cols],
                             in_ring, dim=1)
    if kf < hcap:
        hist_frame[:, kf].fill_(frame_id)
        hist_pose[:, kf] = kf_pose[:, col]

    # --- pose-graph edges ----------------------------------------------
    oldest = kf - (r - 1)
    pair_ok = (valid_cols & (kf_ids - 1 >= max(oldest, 0)) & (kf_ids >= 1)
               & (kf_ids < hcap))
    prev_cols = torch.remainder(kf_ids - 1, r)
    rel = se3_inverse(kf_pose[:, prev_cols]) @ kf_pose[:, cols]
    pg_T = drop_scatter(state.pg_T, kf_ids, rel, pair_ok, dim=1)
    pg_w = state.pg_w.clone()
    if kf < hcap:
        pg_w[:, kf] = torch.where(lost, cfg.pg_lost_w, 1.0)

    lc_j, lc_T, lc_w, lc_ptr = state.lc_j, state.lc_T, state.lc_w, \
        state.lc_ptr
    if cfg.enable_recovery:
        # loop closure: the revisit PnP becomes an absolute-pose edge from
        # the gauge node when enough old archive entries agree
        lc_cap = lc_w.shape[1]
        lc_good = ((n_lc >= cfg.lc_min_inliers) & (err_lc < cfg.lc_max_err)
                   & (2 <= kf < hcap))
        li = torch.remainder(lc_ptr, lc_cap)[:, None]
        keep = lc_good[:, None]
        lc_j = drop_scatter(lc_j, li, torch.full_like(li, kf), keep, dim=1)
        lc_T = drop_scatter(lc_T, li, T_lc[:, None], keep, dim=1)
        # weight: inlier support up, the PnP residual down quadratically
        w_lc = ((n_lc.to(torch.float32) / 8.0).clamp(max=4.0)
                * (1.5 / err_lc.clamp(min=1.5)) ** 2)
        lc_w = drop_scatter(lc_w, li, w_lc[:, None], keep, dim=1)
        lc_ptr = lc_ptr + lc_good.to(torch.int32)
        new_closure, any_closure = _smoother_branch(lc_good[0], lc_w[0])
        if new_closure or any_closure:
            hist_pose = _smooth_history(
                hist_pose[0], pg_T[0], pg_w[0], lc_j[0], lc_T[0], lc_w[0],
                kf, cfg, full=new_closure)[None]

    return dataclasses.replace(
        state, kf_pose=kf_pose, kf_valid=kf_valid, obs_uv=obs_uv,
        obs_valid=obs_valid, lm_X=lm_X, lm_valid=lm_valid, lm_desc=lm_desc,
        desc_ctr=desc_ctr, age_at_kf=kps.age, n_keyframes=kf + 1,
        hist_pose=hist_pose, hist_frame=hist_frame, arch_X=arch_X,
        arch_desc=arch_desc, arch_frame=arch_frame, arch_ptr=arch_ptr,
        arch_of_slot=arch_of_slot, pg_T=pg_T, pg_w=pg_w, lc_j=lc_j,
        lc_T=lc_T, lc_w=lc_w, lc_ptr=lc_ptr)


def slam_step(state: SlamState, frame1: Image2d, frame2: Image2d,
              cfg: SlamConfig, mesh=None, axis: str = "lm",
              pyr1=None, pyr2=None) -> SlamState:
    """One frame: track, and on keyframe frames run the back end
    (``_slam_step_streams`` at S = 1; ``mesh``/``axis`` shard the window
    BA's landmarks)."""
    b = max(3, cfg.tracker.winsize)
    if pyr1 is None:
        pyr1 = build_pyramid(frame1, cfg.tracker.nscales, border=b)
    if pyr2 is None:
        pyr2 = build_pyramid(frame2, cfg.tracker.nscales, border=b)
    return drop(_slam_step_streams(lift(state), frame2.data[None],
                                  frame2.border, cfg, _levels(pyr1),
                                  _levels(pyr2), pyr1[0].border, mesh=mesh,
                                  axis=axis))


def _slam_step_streams(state: SlamState, frame2: torch.Tensor, border: int,
                      cfg: SlamConfig, levels1: Tuple[torch.Tensor, ...],
                      levels2: Tuple[torch.Tensor, ...],
                      level_border: int, mesh=None,
                      axis: str = "lm") -> SlamState:
    """One frame of S streams (``_tracker_step``'s operands): track, and on
    keyframe frames (the frame index decides, the same for every stream)
    run ``_keyframe_step`` (its window BA sharded over ``mesh`` where one is
    given, one stream)."""
    tracker = _tracker_step(state.tracker, frame2, border, cfg.tracker,
                           levels1, levels2, level_border)
    state = dataclasses.replace(state, tracker=tracker)
    if tracker.frame_id % cfg.keyframe_period == 0:
        if frame2.shape[0] == 1:
            # one stream goes through the single-stream entry, views both
            # ways, so that a caller who wraps ``_do_keyframe`` sees it
            state = lift(_do_keyframe(drop(state), Image2d(
                data=frame2[0], border=border), cfg, mesh=mesh, axis=axis))
        else:
            state = _keyframe_step(state, frame2, border, cfg, mesh=mesh,
                                   axis=axis)
    return state


def _run_streams(frames: torch.Tensor, cfg: SlamConfig,
                 boot: Optional[torch.Tensor], collect_tracks: bool,
                 mesh=None, axis: str = "lm"):
    """The run loop of S clips (S, T, H, W) on their device: each frame's
    pyramids built once for every stream (``pyramid_streams``), reused as
    the next step's frame-1 levels, level 0 as the frame buffer."""
    dev = frames.device
    n_streams, t = frames.shape[0], frames.shape[1]
    b = max(3, cfg.tracker.winsize)
    states = [slam_init(cfg, None if boot is None else boot[i], device=dev)
              for i in range(n_streams)]
    state = lift(states[0]) if n_streams == 1 else stack(states)
    if collect_tracks:
        k = cfg.tracker.capacity
        hist_pos = torch.empty((n_streams, t, k, 2), dtype=torch.float32,
                               device=dev)
        hist_alive = torch.empty((n_streams, t, k), dtype=torch.bool,
                                 device=dev)
    lv1 = pyramid_streams(frames[:, 0], cfg.tracker.nscales, border=b)
    for i in range(t):
        lv2 = pyramid_streams(frames[:, i], cfg.tracker.nscales, border=b)
        state = _slam_step_streams(state, lv2[0], b, cfg, lv1, lv2, b,
                                   mesh=mesh, axis=axis)
        if collect_tracks:
            hist_pos[:, i] = state.tracker.keypoints.position
            hist_alive[:, i] = state.tracker.keypoints.alive
        lv1 = lv2
    return (state, (hist_pos, hist_alive)) if collect_tracks else state


def slam_run(frames, cfg: SlamConfig, bootstrap_poses=None, mesh=None,
             axis: str = "lm", collect_tracks: bool = False, device="cuda"):
    """Whole-clip SLAM on ``device`` (frames (T, H, W)): the JAX package's
    scan, frame by frame; each frame's pyramid is built once, from the
    unbordered frame, and reused as the next step's frame-1 pyramid, with
    its level 0 as the frame image (the ``b``-bordered symmetric pad that
    ``from_array(frame, border=b, border_mode="mirror")`` gives). The
    streams' run loop at S = 1.

    With ``collect_tracks`` returns (state, (positions (T, K, 2),
    alive (T, K))), the per-frame tracker history. ``mesh``/``axis`` shard
    the window BA's landmarks; every rank of the mesh calls with the whole
    clip and gets the same state."""
    dev = resolve_device(device)
    frames = _as_tensor(frames, dev)
    boot = (None if bootstrap_poses is None
            else _as_tensor(bootstrap_poses, dev)[None])
    out = _run_streams(frames[None], cfg, boot, collect_tracks, mesh=mesh,
                       axis=axis)
    if collect_tracks:
        state, (pos, alive) = out
        return drop(state), (pos[0], alive[0])
    return drop(out)


def slam_run_streams(frames, cfg: SlamConfig, bootstrap_poses,
                     device="cuda") -> SlamState:
    """``slam_run`` over S independent clips at once on one card: frames
    (S, T, H, W), bootstrap_poses (S, 2, 4, 4); returns the final
    ``SlamState`` with a leading S on every tensor (``n_keyframes`` and the
    tracker's ``frame_id`` are host ints, the same for every stream). The
    serving configuration: each kernel launches once a step for all S
    streams, so the launches a frame do not grow with S, except the window
    BA past ``ring`` 16 poses (more than K6 holds): there a keyframe makes
    S K9 launches, one a stream in stream order.

    As in the JAX package, requires T % keyframe_period == 0 and
    ``enable_recovery=False`` (``ValueError`` otherwise); the keyframe
    runs after the first tracker step of every ``keyframe_period``, the
    cadence of ``slam_run``."""
    frames_shape = tuple(frames.shape)
    period = cfg.keyframe_period
    if frames_shape[1] % period != 0:
        raise ValueError(
            f"slam_run_streams needs T % keyframe_period == 0, got "
            f"T={frames_shape[1]}, period={period}")
    if cfg.enable_recovery:
        raise ValueError(
            "slam_run_streams requires enable_recovery=False (the "
            "recovery branch and the closure smoother run one stream at a "
            "time)")
    dev = resolve_device(device)
    frames = _as_tensor(frames, dev)
    boot = _as_tensor(bootstrap_poses, dev)
    if len(frames_shape) != 4 or tuple(boot.shape) != (frames_shape[0], 2,
                                                       4, 4):
        raise ValueError(f"slam_run_streams: frames (S, T, H, W) and "
                         f"bootstrap_poses (S, 2, 4, 4), got {frames_shape} "
                         f"and {tuple(boot.shape)}")
    return _run_streams(frames, cfg, boot, collect_tracks=False)


def relocalize(state: SlamState, frame: Image2d, cfg: SlamConfig,
               detect_th: int = 10
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The camera pose of ``frame`` from the live map alone: FAST
    detections at ``detect_th`` (K2, K3), then ``_map_vote_pnp`` (one K8
    launch) from the last keyframe's pose. Returns (pose (4, 4), mean
    reprojection error of the matches, number of distinct inlier
    detections); accept on ``n >= cfg.lc_min_inliers`` (with no eligible
    match the pose is the prior and the error 0)."""
    dev = state.lm_X.device
    intr = device_constant(cfg.intrinsics, torch.float32, dev)
    pos, _, valid = fast9(frame, detect_th, k=cfg.tracker.detect_k,
                          blockwise=True,
                          block_size=cfg.tracker.keypoint_spacing)
    n_kf = state.n_keyframes
    T_prior = state.kf_pose[(n_kf - 1) % cfg.ring if n_kf > 0 else 0]
    return _map_vote_pnp(state.lm_X, state.lm_desc, state.lm_valid, pos,
                         valid, frame, cfg, T_prior, intr)


def keyframe_trajectory(state: SlamState
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, 4, 4) optimized keyframe poses and their frame ids, with
    ``n = min(n_keyframes, history)``; warns when keyframes overflowed the
    history."""
    n_kf = state.n_keyframes
    cap = state.hist_pose.shape[0]
    if n_kf > cap:
        import warnings
        warnings.warn(
            f"keyframe_trajectory: {n_kf} keyframes exceed the history "
            f"capacity {cap}; returning the first {cap} (raise "
            "SlamConfig.history to keep the full trajectory)",
            stacklevel=2)
    n = min(n_kf, cap)
    return state.hist_pose[:n], state.hist_frame[:n]


def ate_rmse(est: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Absolute trajectory error: camera-centre RMSE, no alignment (the
    gauge is pinned by the bootstrap poses)."""
    def centres(T):
        return -(T[:, :3, :3].transpose(-1, -2) @ T[:, :3, 3:])[..., 0]
    d = centres(est) - centres(gt.to(est.dtype))
    return torch.sqrt((d * d).sum(1).mean())
