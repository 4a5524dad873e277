"""Synthetic 3-D scene renderer (host-side, numpy) for SLAM tests and the
card's smoke run.

The port's own copy of ``vpp_tpu.utils.synth``: a random 3-D point cloud
rendered as Gaussian blobs under a moving pinhole camera, so triangulation
and BA have ground truth to recover. Same functions, seeds and numbers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_cloud(n_points: int, seed: int = 0,
               extent=(4.0, 3.0, 4.0), center=(0.0, 0.0, 6.0)
               ) -> np.ndarray:
    """(P, 3) world points in a box in front of the origin."""
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n_points, 3) - 0.5) * np.asarray(extent)
    return (pts + np.asarray(center)).astype(np.float32)


def camera_path(n_frames: int, step=(0.05, 0.0, 0.0),
                yaw_per_frame: float = 0.0) -> np.ndarray:
    """(T, 4, 4) camera-from-world poses: constant translation + optional
    yaw. Pose T maps world -> camera."""
    poses = []
    t = np.zeros(3)
    yaw = 0.0
    for i in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
        cam_pos = t.copy()
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = -R @ cam_pos
        poses.append(T)
        t = t + np.asarray(step)
        yaw += yaw_per_frame
    return np.stack(poses)


def render_frames(points: np.ndarray, poses: np.ndarray,
                  intrinsics, shape: Tuple[int, int],
                  sigma=1.3, seed: int = 0,
                  background: float = 12.0) -> np.ndarray:
    """(T, H, W) float32 frames: each world point splats a Gaussian blob
    (separable outer-product rendering; occlusion-free sparse cloud).

    ``sigma``: scalar for identical isotropic blobs, or a (lo, hi) range
    for per-point anisotropic shapes — identical blobs make appearance
    matching information-free by construction (every feature looks the
    same); the anisotropic variant gives descriptors something to bite on
    (used by the relocalization test)."""
    rng = np.random.RandomState(seed + 1)
    h, w = shape
    npts = points.shape[0]
    fx, fy, cx, cy = [float(v) for v in intrinsics]
    intensity = rng.rand(npts).astype(np.float32) * 160 + 90
    if np.isscalar(sigma):
        sig_r = np.full(npts, float(sigma), np.float32)
        sig_c = sig_r
    else:
        lo, hi = sigma
        sig_r = rng.rand(npts).astype(np.float32) * (hi - lo) + lo
        sig_c = rng.rand(npts).astype(np.float32) * (hi - lo) + lo
    rr = np.arange(h, dtype=np.float32)
    cc = np.arange(w, dtype=np.float32)
    hom = np.concatenate([points, np.ones_like(points[:, :1])], axis=1)
    frames = []
    for T in poses:
        pc = hom @ T.T                      # (P, 4) camera coords
        z = pc[:, 2]
        vis = z > 0.1
        u = fx * pc[:, 0] / np.maximum(z, 0.1) + cx   # col
        v = fy * pc[:, 1] / np.maximum(z, 0.1) + cy   # row
        vis &= (u > -3) & (u < w + 3) & (v > -3) & (v < h + 3)
        er = np.exp(-0.5 * ((rr[None, :] - v[:, None])
                            / sig_r[:, None]) ** 2)
        ec = np.exp(-0.5 * ((cc[None, :] - u[:, None])
                            / sig_c[:, None]) ** 2)
        er = er * (intensity * vis)[:, None]
        frames.append(er.T @ ec + background)
    return np.stack(frames).astype(np.float32)
