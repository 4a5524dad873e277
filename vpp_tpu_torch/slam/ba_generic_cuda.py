"""Kernel K9 (``kernels/csrc/ba_generic.cu``): the Levenberg-Marquardt
solve of ``ba_solve_tracks`` on the generic tracks layout, where
``obs_pose[n, k]`` names any pose.

``ba.ba_solve_tracks`` calls ``lm_generic`` on CUDA tensors with
``ring_layout=False``; its plain version is ``ba._lm_tracks(kernel=False)``
(with ``_tracks_assemble``'s generic branch, ``_tracks_solve_poses``,
``apply_pose_step``, ``_tracks_backsub`` and ``_tracks_cost``). A call makes
one index launch (the slots sorted by pose, the list of non-empty 6x6
blocks of S), then per iteration four K9 launches and the library's dense
pose solve between them: the landmark blocks; S, rhs and the cost, a warp
a non-empty block; the damped, gauge-fixed, Jacobi-scaled system; the
library's LU (``torch.linalg.solve_ex``) or Cholesky (``cholesky_ex`` and
two triangular solves), the one library call of the route, as in the plain
version; then the pose step, back-substitution and candidate cost; and the
accept test with the damping update. Every sum runs in a fixed order, so
two calls on the same inputs give the same bits; no iteration reads the
host. The landmark blocks are float64, as in the plain version (see
``slam/ba.py`` on precision).

Limits, checked here (``ValueError`` beyond them): one problem (no stream
dimension), 1 to ``MAX_POSES`` poses, 1 to ``MAX_SLOTS`` slots a landmark,
at least one landmark and at most ``MAX_OBSERVATIONS`` slots in all.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import LAUNCHES, require_cuda, stream_handle
from .ba import BATracks
from .ba_cuda import LMTrace

MAX_POSES = 512
MAX_SLOTS = 32
MAX_OBSERVATIONS = 1 << 22


def _operands(p: BATracks):
    if p.landmarks.dim() != 2:
        raise ValueError("K9: takes one problem, not streams")
    n, k = p.obs_valid.shape
    m = p.poses.shape[0]
    if not 1 <= m <= MAX_POSES:
        raise ValueError(f"K9: takes 1 to {MAX_POSES} poses, got {m}")
    if not 1 <= k <= MAX_SLOTS:
        raise ValueError(f"K9: takes 1 to {MAX_SLOTS} slots a landmark, "
                         f"got {k}")
    if n < 1 or n * k > MAX_OBSERVATIONS:
        raise ValueError(f"K9: takes 1 to {MAX_OBSERVATIONS} slots in all "
                         f"and at least one landmark, got N={n}, K={k}")
    if tuple(p.poses.shape) != (m, 4, 4) or tuple(p.landmarks.shape) != (
            n, 3) or tuple(p.obs_pose.shape) != (n, k) or tuple(
            p.obs_uv.shape) != (n, k, 2) or tuple(
            p.fixed_poses.shape) != (m,) or tuple(
            p.intrinsics.shape) != (4,):
        raise ValueError("K9: poses (M,4,4), landmarks (N,3), obs_pose "
                         "(N,K), obs_uv (N,K,2), obs_valid (N,K), "
                         "fixed_poses (M,) and intrinsics (4,) expected")
    ops = (p.poses.contiguous(), p.landmarks.contiguous(),
           p.obs_pose.contiguous(), p.obs_uv.contiguous(),
           p.obs_valid.contiguous(), p.intrinsics.contiguous(),
           p.fixed_poses.contiguous())
    require_cuda("ba_generic", *ops, dtypes=(
        torch.float32, torch.float32, torch.int32, torch.float32,
        torch.bool, torch.float32, torch.bool))
    return ops, n, k, m


def pose_solve(Sp: torch.Tensor, bs: torch.Tensor, linalg: str):
    """The library's solve of the scaled system: (x, info), info 0 where it
    solved (``lu``: a zero pivot; ``chol``: not positive definite)."""
    if linalg == "chol":
        L, info = torch.linalg.cholesky_ex(Sp)
        y = torch.linalg.solve_triangular(L, bs[:, None], upper=False)
        x = torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]
        return x.contiguous(), info
    x, info = torch.linalg.solve_ex(Sp, bs)
    return x, info


def lm_generic(p: BATracks, iters: int, huber: float, lam0: float,
               linalg: str):
    """K9: ``iters`` LM iterations of one generic-layout problem. Returns
    (poses (M,4,4), landmarks (N,3), costs (iters,), ``LMTrace``: the
    first iteration's S, rhs and cost, copied out, and per iteration dp,
    lam, the costs and the decision). ``iters`` is at least 1:
    ``ba_solve_tracks(iters=0)`` returns before it."""
    from ..kernels import _build
    if iters < 1:
        raise ValueError(f"K9: takes at least one iteration, got {iters}")
    if linalg not in ("lu", "chol"):
        raise ValueError(f"K9: unknown linalg {linalg!r}")
    (poses, lms, opose, uv, valid, intr, fixed), n, k, m = _operands(p)
    dev = lms.device
    lib = _build.load()
    nbytes = ctypes.c_longlong(0)
    _build.check(lib.vpp_ba_generic_workspace(n, k, m, ctypes.byref(nbytes)),
                 "ba_generic workspace")
    D = 6 * m
    f32 = torch.float32
    ws = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
    S = torch.zeros((D, D), dtype=f32, device=dev)
    Sp = torch.empty((D, D), dtype=f32, device=dev)
    vec = torch.empty((3, D), dtype=f32, device=dev)      # rhs, bs, d
    rhs, bs, dsc = vec[0], vec[1], vec[2]
    state = torch.empty(2, dtype=f32, device=dev)         # lam, cost
    poses_out = torch.empty((m, 4, 4), dtype=f32, device=dev)
    lms_out = torch.empty((n, 3), dtype=f32, device=dev)
    costs = torch.empty(iters, dtype=f32, device=dev)
    per = torch.empty((iters, D + 4), dtype=f32, device=dev)
    sh = stream_handle(lms)
    use_lu = 1 if linalg == "lu" else 0
    huber, lam0 = float(huber), float(lam0)

    def launch(name, code):
        LAUNCHES["ba_generic"] += 1
        _build.check(code, f"ba_generic {name}")

    launch("index", lib.vpp_ba_generic_index(
        opose.data_ptr(), valid.data_ptr(), n, k, m, lam0, ws.data_ptr(),
        state.data_ptr(), sh))
    for it in range(iters):
        launch("landmarks", lib.vpp_ba_generic_landmarks(
            poses.data_ptr(), poses_out.data_ptr(), lms.data_ptr(),
            lms_out.data_ptr(), opose.data_ptr(), uv.data_ptr(),
            valid.data_ptr(), intr.data_ptr(), n, k, m, huber, use_lu, it,
            state.data_ptr(), ws.data_ptr(), sh))
        launch("blocks", lib.vpp_ba_generic_blocks(
            opose.data_ptr(), valid.data_ptr(), n, k, m, ws.data_ptr(),
            S.data_ptr(), rhs.data_ptr(), state.data_ptr(), sh))
        if it == 0:
            first = (S.clone(), rhs.clone(), state[1].clone())
        launch("prep", lib.vpp_ba_generic_prep(
            S.data_ptr(), rhs.data_ptr(), fixed.data_ptr(), m,
            state.data_ptr(), Sp.data_ptr(), bs.data_ptr(), dsc.data_ptr(),
            sh))
        x, info = pose_solve(Sp, bs, linalg)
        launch("step", lib.vpp_ba_generic_step(
            x.data_ptr(), info.data_ptr(), dsc.data_ptr(), fixed.data_ptr(),
            poses_out.data_ptr(), lms_out.data_ptr(), opose.data_ptr(),
            uv.data_ptr(), valid.data_ptr(), intr.data_ptr(), n, k, m, huber,
            ws.data_ptr(), per[it].data_ptr(), sh))
        launch("decide", lib.vpp_ba_generic_decide(
            n, k, m, it, ws.data_ptr(), state.data_ptr(),
            poses_out.data_ptr(), lms_out.data_ptr(), costs.data_ptr(),
            per[it].data_ptr(), sh))
    tr = LMTrace(S=first[0].view(m, 6, m, 6), rhs=first[1].view(m, 6),
                 cost=first[2], dp=per[:, :D].view(iters, m, 6),
                 lam=per[:, D], cost_before=per[:, D + 1],
                 cost_after=per[:, D + 2], accept=per[:, D + 3])
    return poses_out, lms_out, costs, tr
