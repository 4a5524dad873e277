"""Bundle adjustment on the landmark-major (tracks) layout — port of the
part of ``vpp_tpu.slam.ba`` that the SLAM keyframe path runs.

Levenberg-Marquardt with the landmark Schur complement: per landmark the
residuals, analytic Jacobians, Huber weights, a damped 3x3 inverse and the
reduction of its observation pairs into the (6M, 6M) reduced camera system;
a dense pose solve; back-substitution of the landmarks; a cost comparison
that accepts or rejects the step on the device, without a host read.

The LM loop ``_lm_tracks`` with ``_tracks_assemble``,
``_tracks_solve_poses``, ``apply_pose_step``, ``_tracks_backsub`` and
``_tracks_cost`` here is the plain PyTorch version of kernel K6.
``ba_solve_tracks`` on CUDA tensors in the ring layout runs K6 instead
(``slam/ba_cuda.py``, ``kernels/csrc/ba_tracks.cu``): the whole loop, the
pose solve included, in one launch.

Precision. Residuals and Jacobians are float32, as in the JAX package, but
each landmark's 3x3 block algebra (Hll, its damped inverse, U, W and the
landmark's Schur terms and back-substitution) runs in float64, in the
plain versions and in K6 alike, and S, rhs and the cost are summed in
float64 and rounded to float32. A landmark seen once, or with little
parallax, has an Hll whose damped condition number (~|Jl|^2 / lam, about
1e8 at VGA focal lengths) is past float32's: there ``_inv3``'s last pivot
goes non-positive, its clamp returns an inverse orders of magnitude too
large along the ray, and the float32 Schur terms are rounding noise that
swamps S (JAX's own results there depend on the last bits of its
einsums). In exact arithmetic that
direction contributes nothing (U and bl are orthogonal to the ray), and
float64 keeps it so. On well-conditioned problems the two agree to
float32's rounding (tests/test_torch_slam_ba.py).

Linear algebra that JAX returns as NaN on failure (Cholesky of a matrix
that is not positive definite, a singular solve) uses the ``_ex`` variants
here and sets NaN where ``info != 0``, so an LM step that fails is
rejected as in the JAX package, and nothing syncs the host.

Not ported yet: the flat ``ba_solve``, ``tracks_from_flat``, the generic
(non-ring) layout on the card, and the landmark-sharded path (``mesh``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .se3 import _hat, se3_apply, se3_exp


def _inv3(A: torch.Tensor) -> torch.Tensor:
    """Batched SPD 3x3 inverse via a scaled closed-form Cholesky: pure
    elementwise arithmetic, the same sequence of operations as the JAX
    ``_inv3``. Callers damp A so it is SPD."""
    dg = torch.stack([A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]], -1)
    s = torch.rsqrt(dg.abs().clamp(min=1e-30))
    A = A * s[..., :, None] * s[..., None, :]
    a11, a21, a31 = A[..., 0, 0], A[..., 1, 0], A[..., 2, 0]
    a22, a32, a33 = A[..., 1, 1], A[..., 2, 1], A[..., 2, 2]
    tiny = 1e-30
    l11 = torch.sqrt(a11.clamp(min=tiny))
    il11 = 1.0 / l11
    l21 = a21 * il11
    l31 = a31 * il11
    l22 = torch.sqrt((a22 - l21 * l21).clamp(min=tiny))
    il22 = 1.0 / l22
    l32 = (a32 - l31 * l21) * il22
    l33 = torch.sqrt((a33 - l31 * l31 - l32 * l32).clamp(min=tiny))
    il33 = 1.0 / l33
    m11 = il11
    m21 = -l21 * il11 * il22
    m31 = (l21 * l32 - l31 * l22) * il11 * il22 * il33
    m22 = il22
    m32 = -l32 * il22 * il33
    m33 = il33
    i11 = m11 * m11 + m21 * m21 + m31 * m31
    i12 = m21 * m22 + m31 * m32
    i13 = m31 * m33
    i22 = m22 * m22 + m32 * m32
    i23 = m32 * m33
    i33 = m33 * m33
    inv = torch.stack([
        torch.stack([i11, i12, i13], -1),
        torch.stack([i12, i22, i23], -1),
        torch.stack([i13, i23, i33], -1)], -2)
    return inv * s[..., :, None] * s[..., None, :]


def _nan_where_failed(x: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """``x`` with NaN in every batch entry whose factorisation failed."""
    bad = (info != 0).reshape(info.shape + (1,) * (x.dim() - info.dim()))
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def _inv_lu(A: torch.Tensor) -> torch.Tensor:
    """Batched pivoted-LU inverse; NaN where A is singular."""
    inv, info = torch.linalg.inv_ex(A)
    return _nan_where_failed(inv, info)


def chol_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for a (damped) SPD A by Cholesky and two triangular
    solves; NaN where A is not positive definite (JAX's behaviour)."""
    L, info = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
    return _nan_where_failed(x, info)


def lu_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b with pivoted LU; NaN where A is singular."""
    x, info = torch.linalg.solve_ex(A, b)
    return _nan_where_failed(x, info)


def proj_jacobians(T: torch.Tensor, X: torch.Tensor, intr: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Analytic projection Jacobians: (pred (..., 2) = (row, col), Jp
    (..., 2, 6) wrt the left-multiplied pose twist [w | v] of the
    ``se3_exp(δ) @ T`` retraction, Jl (..., 2, 3) wrt the world point)."""
    pc = se3_apply(T, X)
    z = torch.where(pc[..., 2].abs() < 1e-6,
                    torch.full_like(pc[..., 2], 1e-6), pc[..., 2])
    iz = 1.0 / z
    u = intr[0] * pc[..., 0] * iz + intr[2]
    v = intr[1] * pc[..., 1] * iz + intr[3]
    pred = torch.stack([v, u], -1)
    zero = torch.zeros_like(iz)
    du = torch.stack([intr[0] * iz, zero,
                      -intr[0] * pc[..., 0] * iz * iz], -1)
    dv = torch.stack([zero, intr[1] * iz,
                      -intr[1] * pc[..., 1] * iz * iz], -1)
    dproj = torch.stack([dv, du], -2)                     # (..., 2, 3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[:-1] + (3, 3))
    dpc = torch.cat([-_hat(pc), eye], -1)                 # (..., 3, 6)
    Jp = dproj @ dpc
    Jl = dproj @ T[..., :3, :3]
    return pred, Jp, Jl


def project(T: torch.Tensor, X: torch.Tensor,
            intr: torch.Tensor) -> torch.Tensor:
    """Pinhole projection of world points X by camera-from-world T:
    (row, col) = (fy y/z + cy, fx x/z + cx)."""
    xc = se3_apply(T, X)
    z = torch.where(xc[..., 2].abs() < 1e-6,
                    torch.full_like(xc[..., 2], 1e-6), xc[..., 2])
    u = intr[0] * xc[..., 0] / z + intr[2]
    v = intr[1] * xc[..., 1] / z + intr[3]
    return torch.stack([v, u], dim=-1)


class BATracks(NamedTuple):
    """Landmark-major BA problem: slot j of row l is the j-th observation
    of landmark l (masked by obs_valid)."""
    poses: torch.Tensor        # (M, 4, 4) camera-from-world
    landmarks: torch.Tensor    # (N, 3)
    obs_pose: torch.Tensor     # (N, K) int32, pose index per observation
    obs_uv: torch.Tensor       # (N, K, 2) float32 (row, col)
    obs_valid: torch.Tensor    # (N, K) bool
    intrinsics: torch.Tensor   # (4,) [fx, fy, cx, cy]
    fixed_poses: torch.Tensor  # (M,) bool


def _obs_poses(p: BATracks, ring_layout: bool = False) -> torch.Tensor:
    """(N, K, 4, 4) pose per observation; in the ring layout
    (``obs_pose[n, j] == j``) a broadcast."""
    if ring_layout:
        return p.poses[None].expand(p.obs_uv.shape[:2] + (4, 4))
    return p.poses[p.obs_pose.long()]


def _huber(nrm: torch.Tensor, huber: float) -> torch.Tensor:
    return torch.where(nrm <= huber, torch.ones_like(nrm),
                       huber / nrm.clamp(min=1e-12))


def track_residuals(p: BATracks, ring_layout: bool = False) -> torch.Tensor:
    """(N, K, 2) reprojection residuals, masked slots -> 0."""
    T = _obs_poses(p, ring_layout)
    r = project(T, p.landmarks[:, None, :], p.intrinsics) - p.obs_uv
    return torch.where(p.obs_valid[..., None], r, torch.zeros_like(r))


def _track_jacobians(p: BATracks, ring_layout: bool = False):
    """r (N,K,2), Jp (N,K,2,6) wrt the pose twist, Jl (N,K,2,3)."""
    T = _obs_poses(p, ring_layout)
    X = p.landmarks[:, None, :].expand(p.obs_uv.shape[:2] + (3,))
    pred, Jp, Jl = proj_jacobians(T, X, p.intrinsics)
    return pred - p.obs_uv, Jp, Jl


def _tracks_cost(p: BATracks, huber: float,
                 ring_layout: bool = False) -> torch.Tensor:
    """Plain version of K6's cost: the Huber-weighted squared residuals."""
    r = track_residuals(p, ring_layout)
    w = _huber(torch.linalg.norm(r, dim=-1), huber)
    c = w * (r * r).sum(-1)
    return torch.where(p.obs_valid, c, torch.zeros_like(c)).sum(
        dtype=torch.float64).float()


def rhs_term_scale(p: BATracks, huber: float,
                   ring_layout: bool = False) -> float:
    """The scale that the rounding of rhs = bp - sum W bl is relative to:
    the largest entry of sum |Jp_w^T| |r| (a host float). The two sums
    cancel to far below their terms, so a tolerance on rhs is set against
    its terms, not its value."""
    r, Jp, _ = _track_jacobians(p, ring_layout)
    w = _huber(torch.linalg.norm(r, dim=-1), huber) * p.obs_valid
    return float(torch.einsum("nkri,nkr->ki",
                              (Jp * w[..., None, None]).abs(),
                              r.abs()).max())


def _tracks_assemble(p: BATracks, lam, huber: float,
                     ring_layout: bool = False, linalg: str = "lu"):
    """Plain version of K6's assembly. Returns (S (M,6,M,6), rhs (M,6),
    cost) in float32 and the landmark-local (Hll_inv (N,3,3), bl (N,3),
    U (N,K,6,3) in float64, pose_idx or None, seen (N,)). Pose damping is
    added in ``_tracks_solve_poses``; landmark damping here."""
    m = p.poses.shape[0]
    r, Jp, Jl = _track_jacobians(p, ring_layout)
    w = _huber(torch.linalg.norm(r, dim=-1), huber)
    w = torch.where(p.obs_valid, w, torch.zeros_like(w))       # (N, K)
    cost = (w * (r * r).sum(-1)).sum(dtype=torch.float64)
    # the landmark blocks and their Schur terms in float64 (module doc)
    r, Jp, Jl, w = r.double(), Jp.double(), Jl.double(), w.double()
    Jp_w = Jp * w[..., None, None]
    Jl_w = Jl * w[..., None, None]

    Hll = torch.einsum("nkri,nkrj->nij", Jl_w, Jl)
    bl = -torch.einsum("nkri,nkr->ni", Jl_w, r)
    U = torch.einsum("nkri,nkrj->nkij", Jp_w, Jl)               # (N,K,6,3)

    seen = w.sum(1) > 0
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    Hll_d = torch.where(seen[:, None, None],
                        Hll + (lam + 1e-6) * eye3, eye3.expand_as(Hll))
    bl = torch.where(seen[:, None], bl, torch.zeros_like(bl))
    Hll_inv = _inv_lu(Hll_d) if linalg == "lu" else _inv3(Hll_d)
    W = torch.einsum("nkij,njc->nkic", U, Hll_inv)               # (N,K,6,3)

    ar = torch.arange(m, device=Hll.device)
    if ring_layout:
        pose_idx = None
        Hpp = torch.einsum("nkri,nkrj->kij", Jp_w, Jp)
        bp = -torch.einsum("nkri,nkr->ki", Jp_w, r)
        S = -torch.einsum("nkij,nlmj->klim", W, U)               # (M,M,6,6)
        S[ar, ar] += Hpp
        rhs = bp - torch.einsum("nkij,nj->ki", W, bl)
    else:
        pose_idx = torch.where(p.obs_valid, p.obs_pose,
                               torch.zeros_like(p.obs_pose)).long()
        Hpp = torch.zeros((m, 6, 6), dtype=Jp.dtype, device=Jp.device)
        Hpp.index_add_(0, pose_idx.reshape(-1), torch.einsum(
            "nkri,nkrj->nkij", Jp_w, Jp).reshape(-1, 6, 6))
        bp = torch.zeros((m, 6), dtype=Jp.dtype, device=Jp.device)
        bp.index_add_(0, pose_idx.reshape(-1), -torch.einsum(
            "nkri,nkr->nki", Jp_w, r).reshape(-1, 6))
        pair = torch.einsum("nkij,nlmj->nklim", W, U)           # (N,K,K,6,6)
        flat = (pose_idx[:, :, None] * m + pose_idx[:, None, :]).reshape(-1)
        S = torch.zeros((m * m, 6, 6), dtype=Jp.dtype, device=Jp.device)
        S.index_add_(0, flat, -pair.reshape(-1, 6, 6))
        S = S.view(m, m, 6, 6)
        S[ar, ar] += Hpp
        Wbl = torch.zeros((m, 6), dtype=Jp.dtype, device=Jp.device)
        Wbl.index_add_(0, pose_idx.reshape(-1), torch.einsum(
            "nkij,nj->nki", W, bl).reshape(-1, 6))
        rhs = bp - Wbl
    S = S.permute(0, 2, 1, 3).float().contiguous()                # (M,6,M,6)
    return ((S, rhs.float(), cost.float()),
            (Hll_inv, bl, U, pose_idx, seen))


def _tracks_solve_poses(S, rhs, fixed_poses, lam, linalg: str = "lu"):
    """The damped, gauge-fixed, Jacobi-scaled (6M, 6M) pose solve."""
    m = rhs.shape[0]
    S = S.reshape(m * 6, m * 6)
    eye = torch.eye(m * 6, dtype=S.dtype, device=S.device)
    S = S + lam * eye
    fixed = fixed_poses[:, None].expand(m, 6).reshape(-1)
    S = torch.where(fixed[:, None] | fixed[None, :], eye, S)
    rhs = torch.where(fixed, torch.zeros_like(rhs.reshape(-1)),
                      rhs.reshape(-1))
    d = torch.rsqrt(torch.diagonal(S).clamp(min=1e-12))
    Sp = S * d[:, None] * d[None, :]
    if linalg == "chol":
        dp = d * chol_solve(Sp, d * rhs)
    else:
        dp = d * lu_solve(Sp, d * rhs)
    return dp.reshape(m, 6)


def _tracks_backsub(local, dp):
    """Plain version of K6's back-substitution: dl = Hll_inv (bl - Σ U dp),
    zero where the landmark is unseen."""
    Hll_inv, bl, U, pose_idx, seen = local
    dp = dp.to(U.dtype)
    if pose_idx is None:
        Udp = torch.einsum("nkij,ki->nj", U, dp)
    else:
        Udp = torch.einsum("nkij,nki->nj", U, dp[pose_idx])
    dl = torch.einsum("nij,nj->ni", Hll_inv, bl - Udp).float()
    return torch.where(seen[:, None], dl, torch.zeros_like(dl))


def apply_pose_step(poses: torch.Tensor, dp: torch.Tensor,
                    fixed: torch.Tensor) -> torch.Tensor:
    """``se3_exp(dp_k) @ T_k`` for every free pose."""
    cand = se3_exp(dp) @ poses
    return torch.where(fixed[:, None, None], poses, cand)


def ba_solve_tracks(p: BATracks, *, iters: int = 10, huber: float = 4.0,
                    lam0: float = 1e-3, mesh=None, axis: str = "lm",
                    ring_layout: bool = False, linalg: str = "lu"
                    ) -> Tuple[BATracks, torch.Tensor]:
    """Levenberg-Marquardt over a landmark-major problem; returns (refined
    problem, (iters,) accepted costs).

    ``ring_layout=True`` promises ``obs_pose[n, j] == j`` (K == M). On CUDA
    tensors it runs kernel K6: every iteration in one launch, M at most
    ``ba_cuda.MAX_POSES``. ``linalg`` is "lu" (pivoted
    landmark inverses and pose solve) or "chol" (closed-form scaled
    Cholesky inverses and a Cholesky pose solve). Raises
    ``NotImplementedError`` for ``mesh`` and for the generic layout on a
    card."""
    if mesh is not None:
        raise NotImplementedError(
            "ba_solve_tracks: the landmark-sharded path (mesh) is not "
            "ported yet")
    if linalg not in ("lu", "chol"):
        raise ValueError(f"ba_solve_tracks: unknown linalg {linalg!r}")
    if ring_layout and p.obs_pose.shape[1] != p.poses.shape[0]:
        raise ValueError("ring_layout requires K == M (obs column j "
                         "observed by pose j)")
    on_card = p.landmarks.device.type == "cuda"
    if on_card and not ring_layout:
        raise NotImplementedError(
            "ba_solve_tracks: the generic (non-ring) layout is not ported "
            "to the card yet")
    return _lm_tracks(p, iters, huber, lam0, ring_layout, linalg,
                      kernel=on_card)


def _lm_tracks(p: BATracks, iters: int, huber: float, lam0: float,
               ring_layout: bool, linalg: str, kernel: bool):
    """The LM loop of ``ba_solve_tracks``: with ``kernel`` (ring layout,
    CUDA tensors) the whole loop is K6's one launch, else the plain version
    below (on any device). No iteration returns ``p`` itself and empty
    costs, as the JAX package's ``lax.scan(length=0)`` does, and launches
    nothing."""
    if iters == 0:
        return p, torch.empty((0,), dtype=torch.float32,
                              device=p.landmarks.device)
    if kernel:
        from . import ba_cuda
        poses, lms, costs, _ = ba_cuda.lm_tracks(p, iters, huber, lam0,
                                                 linalg)
        return p._replace(poses=poses, landmarks=lms), costs
    poses0, lms0 = p.poses, p.landmarks
    lam = torch.full((), lam0, dtype=torch.float32, device=lms0.device)
    costs = []
    for _ in range(iters):
        prob = p._replace(poses=poses0, landmarks=lms0)
        (S, rhs, cost), local = _tracks_assemble(
            prob, lam, huber, ring_layout, linalg)
        dp = _tracks_solve_poses(S, rhs, p.fixed_poses, lam, linalg)
        cand_poses = apply_pose_step(poses0, dp, p.fixed_poses)
        cand_lms = lms0 + _tracks_backsub(local, dp)
        new_cost = _tracks_cost(p._replace(poses=cand_poses,
                                           landmarks=cand_lms),
                                huber, ring_layout)
        accept = new_cost < cost
        poses0 = torch.where(accept, cand_poses, poses0)
        lms0 = torch.where(accept, cand_lms, lms0)
        lam = torch.where(accept, (lam * 0.3).clamp(min=1e-8),
                          (lam * 4.0).clamp(max=1e4))
        costs.append(torch.where(accept, new_cost, cost))
    return p._replace(poses=poses0, landmarks=lms0), torch.stack(costs)
