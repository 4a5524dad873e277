"""Bundle-adjustment problems from a seed: a numpy copy of the recipe of
``tests/test_slam_scale.py:13-40`` (and its noisy start, ``:76-97``).

M poses in a chain, each stepping -0.1 along its x axis with 0.01 rad of
random rotation; N landmarks, each seen by K consecutive poses and lying
in front of them; exact observations; landmarks perturbed by 0.03 as the
start; the first two poses fixed. Intrinsics (300, 300, 160, 120).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

INTRINSICS = (300.0, 300.0, 160.0, 120.0)


def rng_of(seed: int, *keys: int) -> np.random.RandomState:
    """A numpy generator for (seed, keys): any non-negative seed, also
    past 32 bits."""
    state = np.random.SeedSequence([int(seed), *map(int, keys)])
    return np.random.RandomState(int(state.generate_state(1)[0]))


def hat(w: np.ndarray) -> np.ndarray:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = np.zeros_like(wx)
    return np.stack([np.stack([z, -wz, wy], -1),
                     np.stack([wz, z, -wx], -1),
                     np.stack([-wy, wx, z], -1)], -2)


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """Twist [w | v] -> 4x4, float64 (Rodrigues and its V matrix)."""
    w, v = xi[:3].astype(np.float64), xi[3:].astype(np.float64)
    th = float(np.linalg.norm(w))
    K = hat(w)
    if th < 1e-8:
        a, b, c = 1.0, 0.5, 1.0 / 6.0
    else:
        a = np.sin(th) / th
        b = (1 - np.cos(th)) / th ** 2
        c = (th - np.sin(th)) / th ** 3
    R = np.eye(3) + a * K + b * K @ K
    V = np.eye(3) + b * K + c * K @ K
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, V @ v
    return T


def project(T: np.ndarray, X: np.ndarray, intr) -> np.ndarray:
    """(row, col) of world points X under camera-from-world T."""
    pc = np.einsum("...ij,...j->...i", T[..., :3, :3], X) + T[..., :3, 3]
    fx, fy, cx, cy = intr
    return np.stack([fy * pc[..., 1] / pc[..., 2] + cy,
                     fx * pc[..., 0] / pc[..., 2] + cx], -1)


def problem(m: int, n: int, k: int, seed: int, index: int = 0
            ) -> Dict[str, np.ndarray]:
    """Problem ``index`` of the pool of ``seed``: poses (M, 4, 4) float32
    (the truth), landmarks (N, 3) float32 (perturbed), obs_pose (N, K)
    int32, obs_uv (N, K, 2) float32, obs_valid (N, K) bool, fixed (M,)
    bool, intrinsics (4,) float32, and the true landmarks."""
    rng = rng_of(seed, index)
    poses = [np.eye(4)]
    for _ in range(1, m):
        xi = np.zeros(6)
        xi[3] = -0.1
        xi[:3] = rng.randn(3) * 0.01
        poses.append(se3_exp(xi) @ poses[-1])
    poses = np.stack(poses).astype(np.float32)
    start = rng.randint(0, m - k + 1, size=n)
    lms = rng.rand(n, 3) * [2.0, 1.5, 1.0] + [-1.0, -0.75, 3.0]
    lms[:, 0] += 0.1 * start
    lms = lms.astype(np.float32)
    obs_pose = (start[:, None] + np.arange(k)[None]).astype(np.int32)
    uv = project(poses[obs_pose].astype(np.float64),
                 lms[:, None].astype(np.float64), INTRINSICS)
    noisy = (lms + rng.randn(n, 3) * 0.03).astype(np.float32)
    fixed = np.zeros(m, bool)
    fixed[:2] = True
    return dict(poses=poses, landmarks=noisy, obs_pose=obs_pose,
                obs_uv=uv.astype(np.float32),
                obs_valid=np.ones((n, k), bool), fixed=fixed,
                intrinsics=np.asarray(INTRINSICS, np.float32),
                landmarks_true=lms)
