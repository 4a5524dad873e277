"""Kernel K6 (``kernels/csrc/ba_tracks.cu``): the whole window-BA
Levenberg-Marquardt solve on the ring layout in one cluster launch.

``ba.ba_solve_tracks`` calls ``lm_tracks`` on CUDA tensors with
``ring_layout=True``; its plain version is ``ba._lm_tracks(kernel=False)``
(with ``_tracks_assemble``, ``_tracks_solve_poses``, ``apply_pose_step``,
``_tracks_backsub`` and ``_tracks_cost``). One launch runs every
iteration: assembly, the rank-ordered reduction of S/rhs/cost over the
cluster, the pose solve (Cholesky or pivoted LU in shared memory; no
cuSOLVER), the pose step, back-substitution, the candidate's cost and the
accept test. Every sum is taken in a fixed order, so two calls on the same
inputs give the same bits. M is at most ``MAX_POSES``. The landmark blocks
are float64, as in the plain versions (see ``slam/ba.py`` on precision).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import LAUNCHES, require_cuda, stream_handle
from .ba import BATracks

MAX_POSES = 16


class LMTrace(NamedTuple):
    """What the kernel records besides its result: the first iteration's
    reduced system before damping, and per iteration the pose step, the
    damping used, the cost of the iterate and of the candidate, and the
    decision."""
    S: torch.Tensor          # (M, 6, M, 6) float32
    rhs: torch.Tensor        # (M, 6)
    cost: torch.Tensor       # ()
    dp: torch.Tensor         # (iters, M, 6); NaN where the solve failed
    lam: torch.Tensor        # (iters,)
    cost_before: torch.Tensor  # (iters,)
    cost_after: torch.Tensor   # (iters,) the candidate's cost
    accept: torch.Tensor     # (iters,) 1.0 where accepted, else 0.0


def _operands(p: BATracks):
    n, k = p.obs_valid.shape
    m = p.poses.shape[0]
    if k != m:
        raise ValueError(f"K6: ring layout needs K == M, got K={k}, M={m}")
    if not 1 <= m <= MAX_POSES:
        raise ValueError(f"K6: takes 1 to {MAX_POSES} poses, got {m}")
    if tuple(p.obs_uv.shape) != (n, m, 2) or tuple(p.landmarks.shape) != (
            n, 3) or tuple(p.poses.shape[1:]) != (4, 4) or tuple(
            p.fixed_poses.shape) != (m,):
        raise ValueError("K6: poses (M,4,4), landmarks (N,3), obs_uv "
                         "(N,M,2), obs_valid (N,M), fixed_poses (M,) "
                         "expected")
    ops = (p.poses.contiguous(), p.landmarks.contiguous(),
           p.obs_uv.contiguous(), p.obs_valid.contiguous(),
           p.intrinsics.contiguous(), p.fixed_poses.contiguous())
    require_cuda("ba_tracks", *ops, dtypes=(torch.float32,) * 3
                 + (torch.bool, torch.float32, torch.bool))
    return ops, n, m


def lm_tracks(p: BATracks, iters: int, huber: float, lam0: float,
              linalg: str):
    """K6: ``iters`` LM iterations in one launch. Returns (poses (M,4,4),
    landmarks (N,3), costs (iters,), ``LMTrace``). ``iters`` is at least
    1: ``ba_solve_tracks(iters=0)`` returns before it."""
    from ..kernels import _build
    if iters < 1:
        raise ValueError(f"K6: takes at least one iteration, got {iters}")
    (poses, lms, uv, valid, intr, fixed), n, m = _operands(p)
    dev = lms.device
    lib = _build.load()
    D = 6 * m
    P = D * D + D + 1
    f32, f64 = torch.float32, torch.float64
    poses_out = torch.empty((m, 4, 4), dtype=f32, device=dev)
    lms_out = torch.empty((n, 3), dtype=f32, device=dev)
    costs = torch.empty((iters,), dtype=f32, device=dev)
    trace = torch.empty((P + iters * (D + 4),), dtype=f32, device=dev)
    hinv = torch.empty((n, 3, 3), dtype=f64, device=dev)
    bl = torch.empty((n, 3), dtype=f64, device=dev)
    U = torch.empty((n, m, 6, 3), dtype=f64, device=dev)
    seen = torch.empty((n,), dtype=torch.uint8, device=dev)
    cand = torch.empty((n, 3), dtype=f32, device=dev)
    code = lib.vpp_ba_lm(
        poses.data_ptr(), lms.data_ptr(), uv.data_ptr(), valid.data_ptr(),
        intr.data_ptr(), fixed.data_ptr(), float(lam0), float(huber), n, m,
        iters, 1 if linalg == "lu" else 0,
        poses_out.data_ptr(), lms_out.data_ptr(), costs.data_ptr(),
        trace.data_ptr(), hinv.data_ptr(), bl.data_ptr(), U.data_ptr(),
        seen.data_ptr(), cand.data_ptr(), stream_handle(lms))
    LAUNCHES["ba_tracks"] += 1
    _build.check(code, "ba_lm")
    per = trace[P:].view(iters, D + 4)
    tr = LMTrace(S=trace[:D * D].view(m, 6, m, 6),
                 rhs=trace[D * D:D * D + D].view(m, 6), cost=trace[P - 1],
                 dp=per[:, :D].view(iters, m, 6), lam=per[:, D],
                 cost_before=per[:, D + 1], cost_after=per[:, D + 2],
                 accept=per[:, D + 3])
    return poses_out, lms_out, costs, tr
