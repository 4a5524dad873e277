"""End-to-end SLAM: tracker -> keyframes -> triangulation -> sliding-window
BA (port of ``vpp_tpu.slam.pipeline``, the tracking+BA configuration).

The design is the JAX package's, slot-parallel and of static shape: the
tracker's keypoint slot IS the landmark id, keyframes live in a ring of
``cfg.ring`` columns that is the BA window, and the observation matrix
(N, R) is a ring-layout ``BATracks`` problem. New landmarks triangulate
from their oldest and newest ring observations, keyframe poses come from a
Gauss-Newton PnP against the live map, and the window refines with
``ba_solve_tracks``, which on the card runs kernel K6.

PyTorch runs eagerly, so ``slam_step``'s keyframe branch is a host ``if``
on the frame count, and ``SlamState.n_keyframes`` is a Python int like the
tracker's ``frame_id``: the ring column, the history indices and the
bootstrap test are host arithmetic. Everything that depends on data (the
BA gate, the LM accept, the archive pointer, the lost flag) stays on the
device and selects with ``torch.where``: a keyframe makes no host read.

Ported: the ``enable_recovery=False``, ``subpix_refine=False``
configuration (the matched tracking+BA benchmark). The landmark archive is
written as in the JAX package. Not yet: the archive PnP (tracking recovery
and loop-closure measurement), the pose-graph smoother, ``relocalize``,
checkpoints and ``slam_run_streams``. ``SlamConfig`` keeps the JAX
defaults, so ``SlamConfig(intrinsics=...)`` alone (``enable_recovery=True``)
raises ``NotImplementedError`` at ``slam_init`` until recovery is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .._device import device_constant, resolve_device
from ..algorithms.geometry import triangulate_ls
from ..algorithms.pyramid import pyramid as build_pyramid
from ..algorithms.video_extruder import (VideoExtruderConfig,
                                         VideoExtruderState,
                                         video_extruder_init,
                                         video_extruder_update)
from ..core.image import Image2d, _as_tensor
from ..core.interp import extract_patches
from ..core.keypoints import drop_scatter
from .ba import (BATracks, ba_solve_tracks, chol_solve, project,
                 proj_jacobians, track_residuals)
from .se3 import se3_exp, se3_inverse


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Static pipeline knobs; names and defaults are the JAX package's.
    ``tracker.capacity`` is also the landmark table size; ``ring`` is the
    sliding-window length (BA poses). The port runs only
    ``enable_recovery=False`` and ``subpix_refine=False`` so far."""
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


def _check_supported(cfg: SlamConfig, mesh=None) -> None:
    if cfg.enable_recovery:
        raise NotImplementedError(
            "vpp_tpu_torch SLAM: enable_recovery=True (archive PnP, loop "
            "closure, pose graph) is not ported yet; pass "
            "enable_recovery=False")
    if cfg.subpix_refine:
        raise NotImplementedError(
            "vpp_tpu_torch SLAM: subpix_refine=True is not ported yet")
    if mesh is not None:
        raise NotImplementedError(
            "vpp_tpu_torch SLAM: the landmark-sharded BA (mesh) is not "
            "ported yet")


def _eye4(*lead: int, device) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device).expand(
        lead + (4, 4)).clone()


def slam_init(cfg: SlamConfig, bootstrap_poses=None,
              device="cuda") -> SlamState:
    """Empty state on ``device``. ``bootstrap_poses``: (2, 4, 4) poses of
    the first two keyframes (they pin the gauge and the monocular scale);
    identity for both when omitted."""
    _check_supported(cfg)
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


def pnp_gn(T0: torch.Tensor, X: torch.Tensor, uv: torch.Tensor,
           valid: torch.Tensor, intr: torch.Tensor, *, iters: int = 6,
           huber: float = 4.0, lam: float = 1e-4
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-pose Gauss-Newton PnP from masked 2D-3D matches: returns
    (pose (4, 4), mean |residual| over valid matches). With < 4 valid
    matches the damped system keeps the pose near its prior; a Cholesky
    that fails gives NaN, as in the JAX package."""
    nvalid = valid.sum().clamp(min=1)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    T = T0
    for _ in range(iters):
        pred, J, _ = proj_jacobians(T, X, intr)
        r = pred - uv
        nrm = torch.linalg.norm(r, dim=-1)
        w = torch.where(nrm <= huber, torch.ones_like(nrm),
                        huber / nrm.clamp(min=1e-12))
        w = torch.where(valid, w, torch.zeros_like(w))
        Jw = J * w[:, None, None]
        H = torch.einsum("nri,nrj->ij", Jw, J) + lam * eye6
        b = -torch.einsum("nri,nr->i", Jw, r)
        T = se3_exp(chol_solve(H, b)) @ T
    r = project(T, X, intr) - uv
    nrm = torch.linalg.norm(r, dim=-1)
    err = torch.where(valid, nrm, torch.zeros_like(nrm)).sum() / nvalid
    return T, err


def _projection_matrix(T: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) P = K [R|t] in (x=col, y=row) convention."""
    z = torch.zeros_like(intr[0])
    one = torch.ones_like(intr[0])
    K = torch.stack([intr[0], z, intr[2], z, intr[1], intr[3],
                     z, z, one]).view(3, 3)
    return K @ T[..., :3, :]


def _do_keyframe(state: SlamState, frame2: Image2d, cfg: SlamConfig,
                 mesh=None, axis: str = "lm") -> SlamState:
    """Keyframe work: obs write -> PnP pose -> triangulate -> window BA ->
    prune -> archive and history writes. Float32 with TF32 off (the JAX
    package runs this at "highest" matmul precision); the window BA's
    landmark blocks are float64 (``slam/ba.py``)."""
    _check_supported(cfg, mesh)
    dev = state.lm_X.device
    intr = device_constant(cfg.intrinsics, torch.float32, dev)
    kps = state.tracker.keypoints
    alive = kps.alive
    n, r = state.obs_valid.shape
    kf = state.n_keyframes               # index of the NEW keyframe (int)
    col = kf % r
    frame_id = state.tracker.frame_id

    # --- slot continuity (age handshake) -----------------------------
    if kf == 0:
        continuous = torch.zeros((n,), dtype=torch.bool, device=dev)
    else:
        continuous = (alive & (state.age_at_kf > 0)
                      & (kps.age == state.age_at_kf + cfg.keyframe_period))
    obs_valid = state.obs_valid & continuous[:, None]
    lm_valid = state.lm_valid & continuous

    # new rows observe at the integer centre their template is cut at
    obs_pos = torch.where(continuous[:, None], kps.position,
                          torch.round(kps.position))

    # --- pose estimate for this keyframe (PnP on live landmarks) ------
    prev_col = (kf - 1) % r if kf >= 1 else 0
    T_prior = state.kf_pose[prev_col]
    tracked = lm_valid & alive
    T_pnp, _ = pnp_gn(T_prior, state.lm_X, obs_pos, tracked, intr,
                      iters=cfg.pnp_iters, huber=cfg.ba_huber)
    # recovery is compiled out: no recovery pose can replace T_pnp
    lost = tracked.sum() < cfg.min_tracked
    # bootstrap: keyframes 0 and 1 keep their preset (gauge/scale) poses
    T_new = state.kf_pose[col] if kf < 2 else T_pnp

    kf_pose = state.kf_pose.clone()
    kf_pose[col] = T_new
    kf_valid = state.kf_valid.clone()
    kf_valid[col].fill_(True)      # fills on the device (no host copy)

    # --- write this keyframe's observations ---------------------------
    obs_valid[:, col] = alive          # obs_valid is a new tensor here
    obs_uv = state.obs_uv.clone()
    obs_uv[:, col] = obs_pos

    # descriptors: every live slot carries its latest appearance (K5)
    ctr = torch.round(kps.position).to(torch.int32) + frame2.border
    desc = extract_patches(frame2.data, ctr, cfg.desc_patch).reshape(
        n, -1).to(torch.float32)
    lm_desc = torch.where(alive[:, None], desc, state.lm_desc)
    desc_ctr = torch.where(alive[:, None], torch.round(kps.position),
                           state.desc_ctr)

    # --- triangulate new landmarks ------------------------------------
    # ring columns from the oldest keyframe (kf - r + 1) to the newest
    kf_ids = kf - torch.arange(r - 1, -1, -1, device=dev)
    cols = torch.remainder(kf_ids, r)
    valid_cols = (kf_ids >= 0) & kf_valid[cols]
    obs_at = obs_valid[:, cols] & valid_cols[None]              # (N, R)
    # first True (argmax on bools picks the first in JAX): int32 keys
    first_ord = torch.argmax(obs_at.to(torch.int32), dim=1)
    has_two = ((obs_at.sum(1) >= 2)
               & obs_at.gather(1, first_ord[:, None])[:, 0])
    first_col = cols[first_ord]
    uv0 = obs_uv.gather(1, first_col[:, None, None].expand(n, 1, 2))[:, 0]
    uv1 = obs_pos
    # rotation-compensated parallax (see the JAX module)
    T0 = kf_pose[first_col]                                     # (N, 4, 4)
    R_rel = torch.einsum("ij,nkj->nik", T_new[:3, :3], T0[:, :3, :3])
    ray = torch.stack([(uv0[:, 1] - intr[2]) / intr[0],
                       (uv0[:, 0] - intr[3]) / intr[1],
                       torch.ones_like(uv0[:, 0])], dim=1)
    rot = torch.einsum("nij,nj->ni", R_rel, ray)
    zr = torch.where(rot[:, 2].abs() < 1e-6,
                     torch.full_like(rot[:, 2], 1e-6), rot[:, 2])
    uv_rot = torch.stack([intr[1] * rot[:, 1] / zr + intr[3],
                          intr[0] * rot[:, 0] / zr + intr[2]], dim=1)
    parallax = torch.linalg.norm(uv1 - uv_rot, dim=1)
    want = (alive & has_two & ~lm_valid & (parallax >= cfg.min_parallax)
            & (first_col != col))

    P1 = _projection_matrix(T0, intr)                           # (N, 3, 4)
    P2 = _projection_matrix(T_new, intr)
    X = triangulate_ls(P1, P2, uv0.flip(-1), uv1.flip(-1))
    # acceptance: in front of both cameras + reprojection sanity
    z1 = (T0[:, 2, :3] * X).sum(-1) + T0[:, 2, 3]
    z2 = X @ T_new[2, :3] + T_new[2, 3]
    re0 = torch.linalg.norm(project(T0, X, intr) - uv0, dim=1)
    re1 = torch.linalg.norm(project(T_new[None], X, intr) - uv1, dim=1)
    good = (want & (z1 > 0.05) & (z2 > 0.05) & (re0 < cfg.max_reproj)
            & (re1 < cfg.max_reproj))
    lm_X = torch.where(good[:, None], X, state.lm_X)
    lm_valid = lm_valid | good

    # --- sliding-window bundle adjustment ------------------------------
    # fix the two oldest valid keyframes in the ring (gauge + scale)
    ar = torch.arange(r, device=dev)
    first2_ord = torch.argsort(torch.where(valid_cols, ar,
                                           torch.full_like(ar, r)),
                               stable=True)[:2]
    fixed = torch.zeros((r,), dtype=torch.bool, device=dev)
    fixed.index_fill_(0, cols[first2_ord], True)
    fixed = fixed & kf_valid
    ba_obs_valid = obs_valid & lm_valid[:, None] & kf_valid[None]
    prob = BATracks(poses=kf_pose, landmarks=lm_X,
                    obs_pose=ar.to(torch.int32)[None].expand(n, r),
                    obs_uv=obs_uv, obs_valid=ba_obs_valid, intrinsics=intr,
                    fixed_poses=fixed)
    enough = ba_obs_valid.sum() >= 12
    solved, _ = ba_solve_tracks(prob, iters=cfg.ba_iters, huber=cfg.ba_huber,
                                lam0=cfg.ba_lam0, ring_layout=True,
                                linalg=cfg.ba_linalg)
    kf_pose = torch.where(enough, solved.poses, kf_pose)
    lm_X = torch.where(enough, solved.landmarks, lm_X)

    # post-BA outlier pruning of observations that still reproject badly
    res = track_residuals(solved._replace(poses=kf_pose, landmarks=lm_X),
                          ring_layout=True)
    bad = (torch.linalg.norm(res, dim=-1) > cfg.prune_reproj) & ba_obs_valid
    obs_valid = torch.where(enough, obs_valid & ~bad, obs_valid)

    # --- archive new landmarks (the loop-closure / recovery map) -------
    a_cap = state.arch_X.shape[0]
    # refresh entries whose slot is still live, then append the new ones
    arch_X = drop_scatter(state.arch_X, state.arch_of_slot, lm_X,
                          lm_valid & (state.arch_of_slot >= 0))
    a_off = torch.cumsum(good.to(torch.int32), 0, dtype=torch.int32) - 1
    a_idx = torch.where(good, torch.remainder(state.arch_ptr + a_off, a_cap),
                        torch.full_like(a_off, a_cap))
    arch_X = drop_scatter(arch_X, a_idx, lm_X, good)
    arch_desc = drop_scatter(state.arch_desc, a_idx, desc, good)
    arch_frame = drop_scatter(state.arch_frame, a_idx,
                              torch.full_like(a_idx, frame_id), good)
    arch_ptr = torch.remainder(state.arch_ptr + good.sum(dtype=torch.int32),
                               a_cap)
    minus1 = torch.full_like(state.arch_of_slot, -1)
    arch_of_slot = torch.where(
        good, a_idx.clamp(max=a_cap - 1),
        torch.where(lm_valid, state.arch_of_slot, minus1))
    # ring-wrap invalidation: clear pointers whose row was just overwritten
    overwritten = drop_scatter(
        torch.zeros((a_cap,), dtype=torch.bool, device=dev), a_idx,
        torch.ones_like(good), good)
    stale = ((arch_of_slot >= 0) & ~good
             & overwritten[arch_of_slot.clamp(0, a_cap - 1).long()])
    arch_of_slot = torch.where(stale, minus1, arch_of_slot)

    # --- trajectory history -------------------------------------------
    hcap = state.hist_pose.shape[0]
    hist_frame = state.hist_frame.clone()
    in_ring = valid_cols & (kf_ids >= 0) & (kf_ids < hcap)
    hist_pose = drop_scatter(state.hist_pose, kf_ids, kf_pose[cols], in_ring)
    if kf < hcap:
        hist_frame[kf].fill_(frame_id)
        hist_pose[kf] = kf_pose[col]

    # --- pose-graph edges ----------------------------------------------
    oldest = kf - (r - 1)
    pair_ok = (valid_cols & (kf_ids - 1 >= max(oldest, 0)) & (kf_ids >= 1)
               & (kf_ids < hcap))
    prev_cols = torch.remainder(kf_ids - 1, r)
    rel = se3_inverse(kf_pose[prev_cols]) @ kf_pose[cols]
    pg_T = drop_scatter(state.pg_T, kf_ids, rel, pair_ok)
    pg_w = state.pg_w.clone()
    if kf < hcap:
        pg_w[kf] = torch.where(lost, cfg.pg_lost_w, 1.0)

    # loop closure: with recovery compiled out the revisit PnP reports no
    # inliers (n_lc = 0, err_lc = 0); the JAX gate then decides on the host
    n_lc, err_lc = 0, 0.0
    lc_j, lc_T, lc_w, lc_ptr = state.lc_j, state.lc_T, state.lc_w, \
        state.lc_ptr
    if (2 <= kf < hcap and n_lc >= cfg.lc_min_inliers
            and err_lc < cfg.lc_max_err):
        lc_cap = lc_w.shape[0]
        li = torch.remainder(lc_ptr, lc_cap).long().reshape(1)
        lc_j = lc_j.index_fill(0, li, kf)
        lc_T = lc_T.index_copy(0, li, T_prior[None])
        w_lc = (min(n_lc / 8.0, 4.0) * (1.5 / max(err_lc, 1.5)) ** 2)
        lc_w = lc_w.index_fill(0, li, w_lc)
        lc_ptr = lc_ptr + 1

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
    """One frame: track, and on keyframe frames run the back end."""
    _check_supported(cfg, mesh)
    tracker = video_extruder_update(state.tracker, frame1, frame2,
                                    cfg.tracker, pyr1=pyr1, pyr2=pyr2)
    state = dataclasses.replace(state, tracker=tracker)
    if tracker.frame_id % cfg.keyframe_period == 0:
        state = _do_keyframe(state, frame2, cfg)
    return state


def slam_run(frames, cfg: SlamConfig, bootstrap_poses=None, mesh=None,
             axis: str = "lm", collect_tracks: bool = False, device="cuda"):
    """Whole-clip SLAM on ``device`` (frames (T, H, W)): the JAX package's
    scan, frame by frame; each frame's pyramid is built once, from the
    unbordered frame, and reused as the next step's frame-1 pyramid, with
    its level 0 as the frame image (the ``b``-bordered symmetric pad that
    ``from_array(frame, border=b, border_mode="mirror")`` gives).

    With ``collect_tracks`` returns (state, (positions (T, K, 2),
    alive (T, K))), the per-frame tracker history."""
    _check_supported(cfg, mesh)
    dev = resolve_device(device)
    frames = _as_tensor(frames, dev)
    b = max(3, cfg.tracker.winsize)
    state = slam_init(cfg, bootstrap_poses, device=dev)
    t = frames.shape[0]
    if collect_tracks:
        k = cfg.tracker.capacity
        hist_pos = torch.empty((t, k, 2), dtype=torch.float32, device=dev)
        hist_alive = torch.empty((t, k), dtype=torch.bool, device=dev)
    pyr1 = build_pyramid(Image2d(data=frames[0], border=0),
                         cfg.tracker.nscales, border=b)
    for i in range(t):
        pyr2 = build_pyramid(Image2d(data=frames[i], border=0),
                             cfg.tracker.nscales, border=b)
        state = slam_step(state, pyr1[0], pyr2[0], cfg, pyr1=pyr1,
                          pyr2=pyr2)
        if collect_tracks:
            hist_pos[i] = state.tracker.keypoints.position
            hist_alive[i] = state.tracker.keypoints.alive
        pyr1 = pyr2
    return (state, (hist_pos, hist_alive)) if collect_tracks else state


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
