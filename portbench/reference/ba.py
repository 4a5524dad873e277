"""Plain Levenberg-Marquardt bundle adjustment on the landmark-major
(tracks) layout, the semantics of ``ba_solve_tracks``: per iteration the
Huber-weighted residuals and analytic Jacobians, the landmark Schur
complement into the (6M, 6M) pose system, pose damping lam and landmark
damping lam + 1e-6, the gauge-fixed, Jacobi-scaled pose solve,
back-substitution, and a step accepted only where it lowers the cost (lam
times 0.3 then, times 4 otherwise). Costs are the Huber-weighted squared
residuals summed, one per iteration after its decision.

Written once for any dtype: the reference runs it in float64; the control
in float32 with every product's operands rounded to TF32 (``ar``,
``reference/precision.py``); a witness in plain float32. The ring layout (``ring=True``: slot j
observed by pose j, a leading stream dimension allowed) is the SLAM
window's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from portbench.reference.precision import EXACT, TF32, Arith


def hat(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def _abc(t2: torch.Tensor):
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(th)) / t2s)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (th - torch.sin(th)) / (t2s * th))
    return a, b, c


def se3_exp(xi: torch.Tensor, ar: Arith = EXACT) -> torch.Tensor:
    """Twist (..., 6) [w | v] -> (..., 4, 4)."""
    w, v = xi[..., :3], xi[..., 3:]
    t2 = (w * w).sum(-1)[..., None, None]
    K = hat(w)
    a, b, c = _abc(t2)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    KK = ar.mm(K, K)
    R = eye + a * K + b * KK
    V = eye + b * K + c * KK
    t = ar.mm(V, v[..., None])[..., 0]
    out = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype,
                      device=xi.device)
    out[..., :3, :3] = R
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def se3_apply(T: torch.Tensor, X: torch.Tensor,
              ar: Arith = EXACT) -> torch.Tensor:
    return ar.mm(T[..., :3, :3], X[..., None])[..., 0] + T[..., :3, 3]


def project(T: torch.Tensor, X: torch.Tensor, intr,
            ar: Arith = EXACT) -> torch.Tensor:
    """(row, col) of X under T, the depth kept 1e-6 away from 0."""
    pc = se3_apply(T, X, ar)
    z = torch.where(pc[..., 2].abs() < 1e-6,
                    torch.full_like(pc[..., 2], 1e-6), pc[..., 2])
    return torch.stack([intr[1] * pc[..., 1] / z + intr[3],
                        intr[0] * pc[..., 0] / z + intr[2]], -1)


def jacobians(T: torch.Tensor, X: torch.Tensor, intr, ar: Arith = EXACT):
    """(pred (..., 2), Jp (..., 2, 6) wrt the left twist [w | v], Jl
    (..., 2, 3))."""
    pc = se3_apply(T, X, ar)
    z = torch.where(pc[..., 2].abs() < 1e-6,
                    torch.full_like(pc[..., 2], 1e-6), pc[..., 2])
    iz = 1.0 / z
    pred = torch.stack([intr[1] * pc[..., 1] * iz + intr[3],
                        intr[0] * pc[..., 0] * iz + intr[2]], -1)
    zero = torch.zeros_like(iz)
    dv = torch.stack([zero, intr[1] * iz, -intr[1] * pc[..., 1] * iz * iz],
                     -1)
    du = torch.stack([intr[0] * iz, zero, -intr[0] * pc[..., 0] * iz * iz],
                     -1)
    dproj = torch.stack([dv, du], -2)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[:-1] + (3, 3))
    Jp = ar.mm(dproj, torch.cat([-hat(pc), eye], -1))
    Jl = ar.mm(dproj, T[..., :3, :3])
    return pred, Jp, Jl


def huber_w(nrm: torch.Tensor, delta: float) -> torch.Tensor:
    return torch.where(nrm <= delta, torch.ones_like(nrm),
                       delta / nrm.clamp(min=1e-12))


def _obs_T(poses, obs_pose, ring: bool, shape):
    if ring:
        return poses[..., None, :, :, :].expand(shape + (4, 4))
    return poses[obs_pose.long()]


def cost(poses, lms, obs_pose, uv, valid, intr, huber, ring=False,
         ar: Arith = EXACT):
    T = _obs_T(poses, obs_pose, ring, uv.shape[:-1])
    r = project(T, lms[..., :, None, :], intr, ar) - uv
    r = torch.where(valid[..., None], r, torch.zeros_like(r))
    c = huber_w(torch.linalg.norm(r, dim=-1), huber) * (r * r).sum(-1)
    return torch.where(valid, c, torch.zeros_like(c)).sum((-2, -1))


def _chol_solve(A: torch.Tensor, b: torch.Tensor,
                ar: Arith = EXACT) -> torch.Tensor:
    """A x = b for SPD A; NaN where the factorisation fails."""
    L, info = torch.linalg.cholesky_ex(ar.r(A))
    x = torch.cholesky_solve(ar.r(b)[..., None], ar.r(L))[..., 0]
    bad = (info != 0).reshape(info.shape + (1,) * (x.dim() - info.dim()))
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def lm(p: Dict[str, torch.Tensor], iters: int, huber: float, lam0: float,
       ring: bool = False, arith: str = "float64"
       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(poses, landmarks, costs (..., iters)) after ``iters`` LM iterations
    on ``p`` (poses, landmarks, obs_pose, obs_uv, obs_valid, fixed,
    intrinsics) in ``arith``: ``float64``; ``tf32``, float32 with TF32
    products (the control); or ``float32`` (a witness)."""
    if arith == "tf32":
        return _lm(p, iters, huber, lam0, torch.float32, ring, TF32)
    if arith == "float32":
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return _lm(p, iters, huber, lam0, torch.float32, ring, EXACT)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return _lm(p, iters, huber, lam0, torch.float64, ring, EXACT)


def _lm(p, iters, huber, lam0, dtype, ring, ar: Arith):
    poses = p["poses"].to(dtype)
    lms = p["landmarks"].to(dtype)
    uv = p["obs_uv"].to(dtype)
    valid = p["obs_valid"]
    obs_pose = p["obs_pose"]
    fixed = p["fixed"]
    intr = p["intrinsics"].to(dtype)
    lead = lms.shape[:-2]
    m = poses.shape[-3]
    dev = lms.device
    lam = torch.full(lead, lam0, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6m = torch.eye(6 * m, dtype=dtype, device=dev)
    fixed6 = fixed[..., :, None].expand(lead + (m, 6)).reshape(
        lead + (6 * m,))
    costs = []
    for _ in range(iters):
        T = _obs_T(poses, obs_pose, ring, uv.shape[:-1])
        X = lms[..., :, None, :].expand(uv.shape[:-1] + (3,))
        pred, Jp, Jl = jacobians(T, X, intr, ar)
        r = torch.where(valid[..., None], pred - uv, torch.zeros_like(uv))
        w = huber_w(torch.linalg.norm(r, dim=-1), huber)
        w = torch.where(valid, w, torch.zeros_like(w))
        c0 = (w * (r * r).sum(-1)).sum((-2, -1))
        Jpw = Jp * w[..., None, None]
        Jlw = Jl * w[..., None, None]
        Hll = ar.einsum("...nkri,...nkrj->...nij", Jlw, Jl)
        bl = -ar.einsum("...nkri,...nkr->...ni", Jlw, r)
        U = ar.einsum("...nkri,...nkrj->...nkij", Jpw, Jl)
        seen = w.sum(-1) > 0
        Hll = torch.where(seen[..., None, None],
                          Hll + (lam + 1e-6)[..., None, None, None] * eye3,
                          eye3.expand_as(Hll))
        bl = torch.where(seen[..., None], bl, torch.zeros_like(bl))
        Hinv = ar.r(torch.linalg.inv(ar.r(Hll)))
        W = ar.mm(U, Hinv[..., None, :, :])                   # (N, K, 6, 3)
        Hpp_o = ar.einsum("...nkri,...nkrj->...nkij", Jpw, Jp)
        bp_o = -ar.einsum("...nkri,...nkr->...nki", Jpw, r)
        Wbl = ar.mm(W, bl[..., None, :, None])[..., 0]
        pair = -ar.einsum("...nkij,...nlmj->...nklim", W, U)
        if ring:
            S = pair.sum(-5)                                  # (M, M, 6, 6)
            im = torch.arange(m, device=dev)
            S[..., im, im, :, :] += Hpp_o.sum(-4)
            rhs = (bp_o - Wbl).sum(-3)                        # (M, 6)
        else:
            idx = obs_pose.long()
            vk = valid
            flat = (idx[:, :, None] * m + idx[:, None, :])
            both = vk[:, :, None] & vk[:, None, :]
            S = torch.zeros((m * m, 6, 6), dtype=dtype, device=dev)
            S.index_add_(0, flat[both], pair[both])
            S = S.view(m, m, 6, 6)
            Hpp = torch.zeros((m, 6, 6), dtype=dtype, device=dev)
            Hpp.index_add_(0, idx[vk], Hpp_o[vk])
            im = torch.arange(m, device=dev)
            S[im, im] += Hpp
            rhs = torch.zeros((m, 6), dtype=dtype, device=dev)
            rhs.index_add_(0, idx[vk], (bp_o - Wbl)[vk])
        S = S.transpose(-3, -2).reshape(lead + (6 * m, 6 * m))
        S = S + lam[..., None, None] * eye6m
        S = torch.where(fixed6[..., :, None] | fixed6[..., None, :],
                        eye6m, S)
        rhs = torch.where(fixed6, torch.zeros_like(fixed6, dtype=dtype),
                          rhs.reshape(lead + (6 * m,)))
        d = torch.rsqrt(torch.diagonal(S, dim1=-2, dim2=-1).clamp(min=1e-12))
        dp = d * _chol_solve(S * d[..., :, None] * d[..., None, :], d * rhs,
                             ar)
        dp = dp.reshape(lead + (m, 6))
        cand_p = torch.where(fixed[..., None, None], poses,
                             ar.mm(se3_exp(dp, ar), poses))
        if ring:
            Udp = ar.einsum("...nkij,...ki->...nj", U, dp)
        else:
            Udp = ar.einsum("nkij,nki->nj", U * valid[..., None, None],
                            dp[obs_pose.long()])
        dl = ar.mm(Hinv, (bl - Udp)[..., None])[..., 0]
        cand_l = lms + torch.where(seen[..., None], dl, torch.zeros_like(dl))
        c1 = cost(cand_p, cand_l, obs_pose, uv, valid, intr, huber, ring, ar)
        acc = c1 < c0
        poses = torch.where(acc[..., None, None, None], cand_p, poses)
        lms = torch.where(acc[..., None, None], cand_l, lms)
        lam = torch.where(acc, (lam * 0.3).clamp(min=1e-8),
                          (lam * 4.0).clamp(max=1e4))
        costs.append(torch.where(acc, c1, c0))
    return poses, lms, torch.stack(costs, -1)
