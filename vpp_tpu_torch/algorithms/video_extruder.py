"""video_extruder — the flagship point tracker (port of
``vpp_tpu.algorithms.video_extruder``).

Per frame: (1) track all keypoints with semi-dense optical flow, move or
kill; (2) merge particles that converged to the same spacing-grid cell,
oldest wins; (3) kill points whose FAST score dropped below 3; (4) every
``detector_period`` frames, detect new FAST keypoints outside the
occupancy mask (blockwise, one per ``keypoint_spacing`` block) and spawn
them; (5) append positions to trajectories.

The state is a plain dataclass of tensors. ``frame_id`` is a Python int,
so the every-``detector_period`` branch is a host ``if`` that costs no
device synchronisation; the results are those of the JAX ``lax.cond``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .._device import resolve_device
from ..core.image import Image2d, _as_tensor
from ..core.keypoints import (Keypoints, keypoints_empty, kp_add,
                              kp_kill_where, kp_move_all)
from .fast import fast9, fast9_cull_scores
from .flow import semi_dense_optical_flow
from .pyramid import Pyramid, pyramid


@dataclasses.dataclass(frozen=True)
class VideoExtruderConfig:
    """Static knobs; names and defaults are the JAX package's."""
    detector_th: int = 10
    keypoint_spacing: int = 10
    detector_period: int = 5
    max_trajectory_length: int = 15
    nscales: int = 3
    winsize: int = 9
    propagation: int = 2
    patchsize: int = 5
    capacity: int = 2048           # keypoint slot budget
    detect_k: int = 1024           # per-detection candidate budget


@dataclasses.dataclass
class VideoExtruderState:
    keypoints: Keypoints
    traj: torch.Tensor       # (K, L, 2) float32, newest first
    traj_len: torch.Tensor   # (K,) int32
    frame_id: int            # frames processed - 1


def video_extruder_init(cfg: VideoExtruderConfig,
                        device="cuda") -> VideoExtruderState:
    """Empty tracker state on ``device`` (the card unless asked for the
    CPU)."""
    dev = resolve_device(device)
    k, length = cfg.capacity, cfg.max_trajectory_length + 1
    return VideoExtruderState(
        keypoints=keypoints_empty(k, device=dev),
        traj=torch.zeros((k, length, 2), dtype=torch.float32, device=dev),
        traj_len=torch.zeros((k,), dtype=torch.int32, device=dev),
        frame_id=-1)


def _spacing_cells(kps: Keypoints, gh: int, gw: int, spacing: int):
    r = (kps.position[:, 0] / spacing).to(torch.int32).clamp(0, gh - 1)
    c = (kps.position[:, 1] / spacing).to(torch.int32).clamp(0, gw - 1)
    return r, c


def _merge_collided(kps: Keypoints, shape: Tuple[int, int],
                    spacing: int) -> Keypoints:
    """Oldest particle per spacing cell survives; equal-age collisions all
    survive."""
    h, w = shape
    gh, gw = max(h // spacing, 1), max(w // spacing, 1)
    r, c = _spacing_cells(kps, gh, gw, spacing)
    flat = (r * gw + c).long()
    age = torch.where(kps.alive, kps.age, torch.zeros_like(kps.age))
    cell_max = torch.zeros((gh * gw,), dtype=torch.int32,
                           device=age.device)
    cell_max.scatter_reduce_(0, flat, age, "amax", include_self=True)
    lose = kps.alive & (age < cell_max[flat])
    return kp_kill_where(kps, lose)


def _occupancy_mask(kps: Keypoints, shape: Tuple[int, int],
                    spacing: int) -> torch.Tensor:
    """(H, W) uint8, 1 where detection is allowed: a 3x3 dilation of the
    occupied spacing cells is blanked."""
    h, w = shape
    gh, gw = -(-h // spacing), -(-w // spacing)
    r, c = _spacing_cells(kps, gh, gw, spacing)
    occ = torch.zeros((gh * gw,), dtype=torch.int32, device=r.device)
    occ.scatter_reduce_(0, (r * gw + c).long(), kps.alive.to(torch.int32),
                        "amax", include_self=True)
    occ_p = torch.nn.functional.pad(occ.view(gh, gw), (1, 1, 1, 1))
    dil = torch.zeros((gh, gw), dtype=torch.bool, device=r.device)
    for dr in (0, 1, 2):
        for dc in (0, 1, 2):
            dil = dil | (occ_p[dr:dr + gh, dc:dc + gw] != 0)
    mask = ~dil
    full = mask.repeat_interleave(spacing, 0).repeat_interleave(spacing, 1)
    return full[:h, :w].to(torch.uint8)


def video_extruder_update(state: VideoExtruderState, frame1: Image2d,
                          frame2: Image2d, cfg: VideoExtruderConfig,
                          pyr1: Optional[Pyramid] = None,
                          pyr2: Optional[Pyramid] = None
                          ) -> VideoExtruderState:
    """One tracker step. frame1/frame2 are grayscale images with border
    >= max(3, winsize) on the state's device; ``pyr1``/``pyr2`` may carry
    prebuilt pyramids."""
    kps = state.keypoints
    frame_id = state.frame_id + 1
    h, w = frame2.shape

    # 1. Track.
    match_pos, _, matched = semi_dense_optical_flow(
        kps.position, kps.alive, frame1, frame2,
        winsize=cfg.winsize, nscales=cfg.nscales,
        propagation=cfg.propagation, patchsize=cfg.patchsize,
        pyr1=pyr1, pyr2=pyr2)
    in_dom = ((match_pos[:, 0] >= 0) & (match_pos[:, 0] <= h - 1) &
              (match_pos[:, 1] >= 0) & (match_pos[:, 1] <= w - 1))
    kps = kp_move_all(kps, match_pos, matched & in_dom)

    # 2. Merge collided particles.
    kps = _merge_collided(kps, (h, w), cfg.keypoint_spacing)

    # 3. Cull low-score points: K2 scores each slot's rounded, clamped
    # position from its 17 samples, the values of the JAX package's full
    # score map read at those pixels.
    sc = fast9_cull_scores(frame2, kps.position, cfg.detector_th)
    kps = kp_kill_where(kps, kps.alive & (sc < 3))

    # 4. Periodic detection of new keypoints.
    if frame_id % cfg.detector_period == 0:
        mask = _occupancy_mask(kps, (h, w), cfg.keypoint_spacing)
        pos, _, valid = fast9(frame2, cfg.detector_th, k=cfg.detect_k,
                              blockwise=True,
                              block_size=cfg.keypoint_spacing, mask=mask)
        kps = kp_add(kps, pos.to(torch.float32), valid)

    # 5. Trajectories: newest-first ring, slot-parallel.
    is_new = kps.age == 1
    alive = kps.alive
    shifted = torch.cat([kps.position[:, None, :], state.traj[:, :-1]],
                        dim=1)
    traj = torch.where(alive[:, None, None], shifted, state.traj)
    traj_len = torch.where(
        alive,
        torch.where(is_new, torch.ones_like(state.traj_len),
                    (state.traj_len + 1).clamp(
                        max=cfg.max_trajectory_length)),
        torch.zeros_like(state.traj_len))
    return VideoExtruderState(keypoints=kps, traj=traj, traj_len=traj_len,
                              frame_id=frame_id)


def video_extruder_run(frames, cfg: VideoExtruderConfig,
                       border: Optional[int] = None, device="cuda"):
    """Track a whole (T, H, W) grayscale clip on ``device``.

    Returns (final_state, (positions (T, K, 2), alive (T, K))): the JAX
    package's scan, frame by frame. The first step tracks frame 0 against
    itself, and each frame's pyramid is built once, from the unbordered
    frame, and reused as the next step's frame-1 pyramid. Its level 0 is
    the frame image: ``pyramid`` pads it ``max(border, 3) = b`` symmetric,
    as ``from_array(frame, border=b, border_mode="mirror")`` would."""
    dev = resolve_device(device)
    frames = _as_tensor(frames, dev)
    b = border if border is not None else max(3, cfg.winsize)
    state = video_extruder_init(cfg, device=dev)
    t = frames.shape[0]
    hist_pos = torch.empty((t, cfg.capacity, 2), dtype=torch.float32,
                           device=dev)
    hist_alive = torch.empty((t, cfg.capacity), dtype=torch.bool, device=dev)

    pyr1 = pyramid(Image2d(data=frames[0], border=0), cfg.nscales, border=b)
    for i in range(t):
        pyr2 = pyramid(Image2d(data=frames[i], border=0), cfg.nscales,
                       border=b)
        state = video_extruder_update(state, pyr1[0], pyr2[0], cfg,
                                      pyr1=pyr1, pyr2=pyr2)
        hist_pos[i] = state.keypoints.position
        hist_alive[i] = state.keypoints.alive
        pyr1 = pyr2
    return state, (hist_pos, hist_alive)
