"""Synthetic SLAM clips rendered on the device: a PyTorch copy of
``vpp_tpu_torch/utils/synth.py`` (the same recipe, draws and numbers), whose
splat of every point into every frame runs as one product a frame on the
card instead of numpy on the host.

A random 3-D point cloud rendered as Gaussian blobs under a moving pinhole
camera; the per-point draws (positions, intensities, blob widths) come
from numpy generators seeded as ``utils/synth.py`` seeds them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def make_cloud(n_points: int, seed: int, extent, center) -> np.ndarray:
    """(P, 3) float32 world points in a box (``utils/synth.make_cloud``)."""
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n_points, 3) - 0.5) * np.asarray(extent)
    return (pts + np.asarray(center)).astype(np.float32)


def camera_path(n_frames: int, step) -> np.ndarray:
    """(T, 4, 4) camera-from-world poses of a constant translation
    (``utils/synth.camera_path`` without yaw)."""
    poses = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
    t = np.zeros(3)
    for i in range(n_frames):
        poses[i, :3, 3] = -t
        t = t + np.asarray(step)
    return poses


def point_draws(npts: int, seed: int, sigma) -> Tuple[np.ndarray, ...]:
    """(intensity, sigma_r, sigma_c) as ``utils/synth.render_frames`` draws
    them for a (lo, hi) ``sigma``."""
    rng = np.random.RandomState(seed + 1)
    intensity = rng.rand(npts).astype(np.float32) * 160 + 90
    lo, hi = sigma
    sig_r = rng.rand(npts).astype(np.float32) * (hi - lo) + lo
    sig_c = rng.rand(npts).astype(np.float32) * (hi - lo) + lo
    return intensity, sig_r, sig_c


def render(points: np.ndarray, poses: np.ndarray, intrinsics,
           shape: Tuple[int, int], sigma, seed: int, device,
           out: torch.Tensor = None, background: float = 12.0,
           chunk: int = 16) -> torch.Tensor:
    """(T, H, W) float32 frames on ``device``: each point splats a blob
    (separable outer products, one matrix product a frame, float32 with
    TF32 off); written into ``out`` when given."""
    h, w = shape
    fx, fy, cx, cy = [float(v) for v in intrinsics]
    inten, sig_r, sig_c = (torch.from_numpy(a).to(device)
                           for a in point_draws(points.shape[0], seed, sigma))
    hom = torch.from_numpy(np.concatenate(
        [points, np.ones_like(points[:, :1])], axis=1)).to(device)
    T_all = torch.from_numpy(np.ascontiguousarray(poses)).to(device)
    rr = torch.arange(h, dtype=torch.float32, device=device)
    cc = torch.arange(w, dtype=torch.float32, device=device)
    if out is None:
        out = torch.empty((len(poses), h, w), dtype=torch.float32,
                          device=device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for t0 in range(0, len(poses), chunk):
            T = T_all[t0:t0 + chunk]
            pc = hom[None] @ T.transpose(-1, -2)           # (C, P, 4)
            z = pc[..., 2]
            vis = z > 0.1
            zc = torch.clamp(z, min=0.1)
            u = fx * pc[..., 0] / zc + cx
            v = fy * pc[..., 1] / zc + cy
            vis = vis & (u > -3) & (u < w + 3) & (v > -3) & (v < h + 3)
            er = torch.exp(-0.5 * ((rr[None, None, :] - v[..., None])
                                   / sig_r[None, :, None]) ** 2)
            ec = torch.exp(-0.5 * ((cc[None, None, :] - u[..., None])
                                   / sig_c[None, :, None]) ** 2)
            er = er * (inten[None] * vis)[..., None]
            torch.matmul(er.transpose(-1, -2), ec,
                         out=out[t0:t0 + chunk])
            out[t0:t0 + chunk] += background
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out
