"""The least work of kernel K9 (one generic-layout ``ba_solve_tracks``
call), from the problem's shapes and its pose graph: a frozen copy of
``chip_smoke.py``'s ``band_ops`` and ``k9_bound``.

Each input read once and each output written once, against, per
iteration, float32 Jacobians (~60 operations a valid slot), the float64
landmark algebra (~486 a slot, at the float64 rate), the Schur pairs of
one landmark with k <= l (216 operations a pair, on the float64 tensor
cores) and the band factorisation and its two solves at the half-bandwidth
of this problem's own pose graph.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from portbench import peaks


def band_ops(n: int, beta: int, linalg: str) -> float:
    """Operations of one band factorisation and its two triangular solves
    of the (n, n) pose system at block half-bandwidth ``beta`` (scalar
    half-bandwidth 6 beta + 5)."""
    kl = min(6 * beta + 5, n - 1)
    ops = 0.0
    for j in range(n):
        km = min(kl, n - 1 - j)
        if linalg == "lu":
            ju = min(2 * kl, n - 1 - j)
            ops += km + 2.0 * km * ju + 2 * (km + ju)
        else:
            ops += km + km * (km + 1) + 4 * km
    return ops


def band_of(obs_pose: np.ndarray) -> int:
    """The block half-bandwidth of S: the widest span of poses that one
    landmark's slots name (every slot valid, indices in [0, M))."""
    if not obs_pose.size:
        return 0
    return int((obs_pose.max(1) - obs_pose.min(1)).max())


def k9_bound_s(n: int, k: int, m: int, slots_per_landmark: Sequence[int],
               iters: int, beta: int, linalg: str) -> float:
    """The least seconds of one call."""
    cnt = [float(c) for c in slots_per_landmark]
    total = sum(cnt)
    pairs = sum(c * (c + 1) / 2 for c in cnt)
    rest = (60 * total
            + 486 * total * peaks.FP32_OPS_PER_S / peaks.FP64_OPS_PER_S
            + 216 * pairs * peaks.FP32_OPS_PER_S / peaks.FP64_MMA_OPS_PER_S)
    ops = iters * (rest + band_ops(6 * m, beta, linalg))
    nbytes = 2 * m * 64 + 2 * n * 12 + n * k * (4 + 8 + 1) + 16 + m \
        + iters * 4
    return peaks.bound_s(nbytes, ops)
