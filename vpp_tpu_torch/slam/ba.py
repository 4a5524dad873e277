"""Bundle adjustment — port of ``vpp_tpu.slam.ba``: the landmark-major
(tracks) layout that the SLAM keyframe path runs, its generic layout at
production scale, and the flat observation layout.

Levenberg-Marquardt with the landmark Schur complement: per landmark the
residuals, analytic Jacobians, Huber weights, a damped 3x3 inverse and the
reduction of its observation pairs into the (6M, 6M) reduced camera system;
a dense pose solve; back-substitution of the landmarks; a cost comparison
that accepts or rejects the step on the device, without a host read.

The LM loop ``_lm_plain`` with ``_tracks_assemble``,
``_tracks_solve_poses``, ``apply_pose_step``, ``_tracks_backsub`` and
``_tracks_cost`` here is the plain PyTorch version of kernels K6 and K9.
``ba_solve_tracks`` on CUDA tensors in the ring layout runs K6 instead
(``slam/ba_cuda.py``, ``kernels/csrc/ba_tracks.cu``): the whole loop, the
pose solve included, in one launch. On the generic layout, and for one
ring problem of more poses than K6 takes, it runs K9
(``slam/ba_generic_cuda.py``, ``kernels/csrc/ba_generic.cu``): the whole
loop in one cooperative launch, an index of the non-empty blocks of S and
a band factorisation of the pose system its own. ``pnp_gn``, the
single-pose Gauss-Newton PnP of the keyframe path and of kernel K8's plain
version (``slam/map_vote.py``), is here too.

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

Streams: ``pnp_gn`` and the tracks layout take leading stream dimensions
(S problems of one shape: poses (S, M, 4, 4), landmarks (S, N, 3), the
observations (S, N, K, ...), ``fixed_poses`` (S, M), shared intrinsics);
every sum, solve, LM decision and damping stays per stream, and K6 solves
S ring-layout problems in one launch.

The flat layout (``BAProblem``, ``ba_solve``, ``reprojection_residuals``)
is plain PyTorch on every device, as the JAX package leaves it to XLA: the
small-window solver and the cross-check oracle of the tracks layout. It
follows the JAX ``_assemble``/``_schur_solve`` step by step (pivoted-LU
landmark inverses, pose damping inside the Schur solve, no Jacobi
scaling, a pivoted-LU pose solve) under the same precision rule: the
assembly's blocks, the landmark inverses, the Schur sums and the
back-substitution in float64 (the (N, M, 6, 3) coupling too, so it takes
twice the JAX package's memory), S, rhs and the costs rounded to float32.
Its Jacobians are the analytic ``proj_jacobians``, which the JAX package
pins equal to its ``jacfwd`` oracle. ``tracks_from_flat`` converts a flat
problem on its device, vectorised.

Indices outside [0, M) (``obs_pose``) or [0, N) (``obs_lm``) follow the
JAX package's rules, on both layouts and on the card: a negative index
counts from the end; a gather then clamps into range, and a scatter-add
drops what is still outside (``gather_index``, ``scatter_index``).

Sharded (``mesh=``, ``parallel/mesh.py``'s process mesh; every rank calls
with the whole problem, as a JAX caller passes global arrays): the flat
``ba_solve`` shards its observations over ``axis`` (O divisible by the axis
size), each rank assembles the normal-equation blocks of its share and the
blocks are all-reduced; ``ba_solve_tracks`` shards its landmarks (N
divisible by the axis size), each rank assembles its block's S, rhs and
cost, only those pose-sized sums (and each trial cost) are all-reduced, the
pose solve is replicated and each rank back-substitutes its own landmarks;
the landmarks are all-gathered at the end, so every rank returns the whole
problem, the same bits on each. The sums cross ranks in float64 and are
rounded to float32 after the reduction, as the single-device sums are. On
CUDA tensors this route runs the plain PyTorch stages on the card, by
design and not as a fallback: K6 and K9 fuse the whole LM call into one
launch, and a reduction across ranks every iteration cannot sit inside it
(the JAX sharded BA has no kernel either); without a mesh nothing changes.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..parallel.mesh import all_gather_stack, all_reduce_sum
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


def _wrap_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    idx = idx.long()
    return torch.where(idx < 0, idx + size, idx)


def gather_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """JAX's gather rule for an index into ``size`` rows: a negative index
    counts from the end, then the index is clamped into [0, size)."""
    return _wrap_index(idx, size).clamp(0, size - 1)


def scatter_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """JAX's scatter-add rule for an index into ``size`` rows: a negative
    index counts from the end, and one still outside [0, size) is dropped.
    Dropped indices come back as ``size``: the caller scatters into one
    spare row and cuts it off."""
    w = _wrap_index(idx, size)
    return torch.where((w >= 0) & (w < size), w, torch.full_like(w, size))


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
    return pinhole(se3_apply(T, X), intr)


def pinhole(xc: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """``project`` of camera-frame points xc (..., 3), depth clamped away
    from 0 as in ``project``."""
    z = torch.where(xc[..., 2].abs() < 1e-6,
                    torch.full_like(xc[..., 2], 1e-6), xc[..., 2])
    u = intr[0] * xc[..., 0] / z + intr[2]
    v = intr[1] * xc[..., 1] / z + intr[3]
    return torch.stack([v, u], dim=-1)


def pnp_gn(T0: torch.Tensor, X: torch.Tensor, uv: torch.Tensor,
           valid: torch.Tensor, intr: torch.Tensor, *, iters: int = 6,
           huber: float = 4.0, lam: float = 1e-4
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-pose Gauss-Newton PnP from masked 2D-3D matches: returns
    (pose (4, 4), mean |residual| over valid matches). With < 4 valid
    matches the damped system keeps the pose near its prior; a Cholesky
    that fails gives NaN, as in the JAX package. Leading stream dimensions
    (T0 (S, 4, 4), X (S, N, 3), uv (S, N, 2), valid (S, N)) solve S poses
    at once."""
    nvalid = valid.sum(-1).clamp(min=1)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)

    def per_match(T):                      # a stream's pose to its matches
        return T if T.dim() == 2 else T[..., None, :, :]

    T = T0
    for _ in range(iters):
        pred, J, _ = proj_jacobians(per_match(T), X, intr)
        r = pred - uv
        nrm = torch.linalg.norm(r, dim=-1)
        w = torch.where(nrm <= huber, torch.ones_like(nrm),
                        huber / nrm.clamp(min=1e-12))
        w = torch.where(valid, w, torch.zeros_like(w))
        Jw = J * w[..., None, None]
        H = torch.einsum("...nri,...nrj->...ij", Jw, J) + lam * eye6
        b = -torch.einsum("...nri,...nr->...i", Jw, r)
        T = se3_exp(chol_solve(H, b)) @ T
    r = project(per_match(T), X, intr) - uv
    nrm = torch.linalg.norm(r, dim=-1)
    err = torch.where(valid, nrm, torch.zeros_like(nrm)).sum(-1) / nvalid
    return T, err


class BAProblem(NamedTuple):
    """Flat BA problem: O observations, each of one pose and one
    landmark (masked by obs_valid)."""
    poses: torch.Tensor        # (M, 4, 4) camera-from-world
    landmarks: torch.Tensor    # (N, 3) world points
    obs_pose: torch.Tensor     # (O,) int32
    obs_lm: torch.Tensor       # (O,) int32
    obs_uv: torch.Tensor       # (O, 2) float32 (row, col)
    obs_valid: torch.Tensor    # (O,) bool
    intrinsics: torch.Tensor   # (4,) [fx, fy, cx, cy]
    fixed_poses: torch.Tensor  # (M,) bool, gauge freeze


def _flat_gather(p: BAProblem):
    """Each observation's pose (O, 4, 4) and landmark (O, 3)."""
    return (p.poses[gather_index(p.obs_pose, p.poses.shape[0])],
            p.landmarks[gather_index(p.obs_lm, p.landmarks.shape[0])])


def reprojection_residuals(p: BAProblem) -> torch.Tensor:
    """(O, 2) residuals, masked slots -> 0."""
    T, X = _flat_gather(p)
    r = project(T, X, p.intrinsics) - p.obs_uv
    return torch.where(p.obs_valid[:, None], r, torch.zeros_like(r))


def _obs_jacobians(p: BAProblem):
    """Per observation the residual r (O, 2), Jp (O, 2, 6) wrt the pose's
    twist (retraction exp(δ)·T) and Jl (O, 2, 3) wrt the landmark: the
    analytic ``proj_jacobians``, where the JAX package takes ``jacfwd``
    through ``se3_exp`` (its tests pin the two equal)."""
    T, X = _flat_gather(p)
    pred, Jp, Jl = proj_jacobians(T, X, p.intrinsics)
    return pred - p.obs_uv, Jp, Jl


def _huber_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS Huber weights per observation from the residual norm."""
    return _huber(torch.linalg.norm(r, dim=-1), delta)


def _assemble(p: BAProblem, r, Jp, Jl, w):
    """The normal-equation blocks by scatter-adds, in float64: (Hpp (M,6,6),
    Hll (N,3,3), Hpl (N,M,6,3), bp (M,6), bl (N,3), cost, nobs_lm (N,))."""
    m, n = p.poses.shape[0], p.landmarks.shape[0]
    wv = torch.where(p.obs_valid, w, torch.zeros_like(w))
    cost = (wv * (r * r).sum(-1)).sum(dtype=torch.float64)
    r, Jp, Jl, wv = r.double(), Jp.double(), Jl.double(), wv.double()
    Jp_w = Jp * wv[:, None, None]
    Jl_w = Jl * wv[:, None, None]
    pi = scatter_index(p.obs_pose, m)
    li = scatter_index(p.obs_lm, n)
    f64, dev = torch.float64, Jp.device

    def scatter(rows, idx, vals):
        out = torch.zeros((rows + 1,) + vals.shape[1:], dtype=f64,
                          device=dev)
        return out.index_add_(0, idx, vals)[:rows]

    Hpp = scatter(m, pi, torch.einsum("oki,okj->oij", Jp_w, Jp))
    Hll = scatter(n, li, torch.einsum("oki,okj->oij", Jl_w, Jl))
    pl = torch.where((pi < m) & (li < n), li * m + pi, n * m)
    Hpl = scatter(n * m, pl, torch.einsum("oki,okj->oij", Jp_w, Jl)).view(
        n, m, 6, 3)
    bp = scatter(m, pi, -torch.einsum("oki,ok->oi", Jp_w, r))
    bl = scatter(n, li, -torch.einsum("oki,ok->oi", Jl_w, r))
    nobs_lm = scatter(n, li, wv)
    return Hpp, Hll, Hpl, bp, bl, cost, nobs_lm


def _schur_solve(p: BAProblem, Hpp, Hll, Hpl, bp, bl, nobs_lm, lam):
    """Damped Schur-complement solve -> (δposes (M, 6), δlandmarks (N, 3)):
    pose damping ``lam I`` inside S, the gauge's identity rows, no Jacobi
    scaling, a pivoted-LU pose solve in float32."""
    m = p.poses.shape[0]
    f64, dev = torch.float64, Hll.device
    eye3 = torch.eye(3, dtype=f64, device=dev)
    eye6 = torch.eye(6, dtype=f64, device=dev)
    Hll_d = Hll + (lam + 1e-6) * eye3
    seen = nobs_lm > 0
    Hll_d = torch.where(seen[:, None, None], Hll_d, eye3.expand_as(Hll))
    bl = torch.where(seen[:, None], bl, torch.zeros_like(bl))
    Hll_inv = _inv_lu(Hll_d)
    HplWinv = torch.einsum("nmij,njk->nmik", Hpl, Hll_inv)    # (N,M,6,3)
    S = -torch.einsum("nmik,npjk->mipj", HplWinv, Hpl)        # (M,6,M,6)
    ar = torch.arange(m, device=dev)
    S[ar, :, ar, :] += Hpp + lam * eye6
    S = S.reshape(m * 6, m * 6).float()
    rhs = (bp - torch.einsum("nmik,nk->mi", HplWinv, bl)).reshape(
        m * 6).float()
    fixed = p.fixed_poses[:, None].expand(m, 6).reshape(-1)
    eye = torch.eye(m * 6, dtype=S.dtype, device=dev)
    S = torch.where(fixed[:, None] | fixed[None, :], eye, S)
    rhs = torch.where(fixed, torch.zeros_like(rhs), rhs)
    dp = lu_solve(S, rhs).reshape(m, 6)
    Hlp_dp = torch.einsum("nmij,mi->nj", Hpl, dp.double())
    dl = torch.einsum("nij,nj->ni", Hll_inv, bl - Hlp_dp).float()
    return dp, torch.where(seen[:, None], dl, torch.zeros_like(dl))


def _apply_step(p: BAProblem, dp, dl) -> BAProblem:
    return p._replace(poses=apply_pose_step(p.poses, dp, p.fixed_poses),
                      landmarks=p.landmarks + dl)


def _masked_cost(p: BAProblem, huber: float) -> torch.Tensor:
    r = reprojection_residuals(p)
    c = _huber_weight(r, huber) * (r * r).sum(-1)
    return torch.where(p.obs_valid, c, torch.zeros_like(c)).sum(
        dtype=torch.float64).float()


def _all_reduce_parts(parts, mesh, axis: str):
    """Every tensor of ``parts`` summed over ``axis`` in one all-reduce of
    their flattened float64 concatenation (all must be float64)."""
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in parts]), mesh,
                          axis)
    out, at = [], 0
    for t in parts:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return tuple(out)


def ba_solve(p: BAProblem, *, iters: int = 10, huber: float = 4.0,
             lam0: float = 1e-3, mesh=None, axis: str = "obs"
             ) -> Tuple[BAProblem, torch.Tensor]:
    """Levenberg-Marquardt BA on the flat observation layout: the
    small-window solver and the cross-check oracle of ``ba_solve_tracks``,
    the production path. Plain PyTorch on every device.

    The Schur assembly materialises an (N, M, 6, 3) coupling tensor; as in
    the JAX package a problem whose float32 coupling would pass 4 GB raises
    ``ValueError`` (this port holds it in float64, twice that). Returns
    (refined problem, (iters,) accepted costs). With ``mesh`` the
    observations shard over ``axis`` (O divisible by its size): each rank
    assembles the blocks of its share, the blocks are all-reduced, and
    every rank makes the same replicated solve (module docstring)."""
    n_lm, n_pose = p.landmarks.shape[0], p.poses.shape[0]
    coupling_gb = n_lm * n_pose * 18 * 4 / 1e9
    if coupling_gb > 4.0:
        raise ValueError(
            f"ba_solve's flat layout would allocate ~{coupling_gb:.1f} GB "
            f"for the (N={n_lm}, M={n_pose}, 6, 3) coupling tensor; use "
            "ba_solve_tracks (landmark-major, shardable) at this scale")
    dev = p.landmarks.device
    part = p
    if mesh is not None:
        n_ax, rank = mesh.size(axis), mesh.get_local_rank(axis)
        o = p.obs_pose.shape[0]
        if o % n_ax:
            raise ValueError(f"ba_solve: {o} observations do not shard over "
                             f"{n_ax} ranks of {axis!r}")
        sl = slice(rank * (o // n_ax), (rank + 1) * (o // n_ax))
        part = p._replace(obs_pose=p.obs_pose[sl], obs_lm=p.obs_lm[sl],
                          obs_uv=p.obs_uv[sl], obs_valid=p.obs_valid[sl])
    if iters == 0:
        return p, torch.empty((0,), dtype=torch.float32, device=dev)
    lam = torch.full((), lam0, dtype=torch.float32, device=dev)
    costs = []
    for _ in range(iters):
        part = part._replace(poses=p.poses, landmarks=p.landmarks)
        r, Jp, Jl = _obs_jacobians(part)
        blocks = _assemble(part, r, Jp, Jl, _huber_weight(r, huber))
        if mesh is not None:
            blocks = _all_reduce_parts(blocks, mesh, axis)
        Hpp, Hll, Hpl, bp, bl, cost, nobs = blocks
        cost = cost.float()
        dp, dl = _schur_solve(p, Hpp, Hll, Hpl, bp, bl, nobs, lam)
        cand = _apply_step(p, dp, dl)
        new_cost = _masked_cost(cand, huber)
        accept = new_cost < cost
        p = p._replace(
            poses=torch.where(accept, cand.poses, p.poses),
            landmarks=torch.where(accept, cand.landmarks, p.landmarks))
        lam = torch.where(accept, (lam * 0.3).clamp(min=1e-8),
                          (lam * 4.0).clamp(max=1e4))
        costs.append(torch.where(accept, new_cost, cost))
    return p, torch.stack(costs)


class BATracks(NamedTuple):
    """Landmark-major BA problem: slot j of row l is the j-th observation
    of landmark l (masked by obs_valid). S problems of one shape carry a
    leading S on every field but ``intrinsics``."""
    poses: torch.Tensor        # (M, 4, 4) camera-from-world
    landmarks: torch.Tensor    # (N, 3)
    obs_pose: torch.Tensor     # (N, K) int32, pose index per observation
    obs_uv: torch.Tensor       # (N, K, 2) float32 (row, col)
    obs_valid: torch.Tensor    # (N, K) bool
    intrinsics: torch.Tensor   # (4,) [fx, fy, cx, cy]
    fixed_poses: torch.Tensor  # (M,) bool


def tracks_from_flat(p: BAProblem, k_max: Optional[int] = None
                     ) -> BATracks:
    """The landmark-major problem of a flat one, on its device: slot j of
    landmark l holds the j-th valid observation of l in flat order, rows
    cut at ``k_max`` slots, which defaults to the longest track (at least
    1). Landmark indices follow the JAX package's numpy walk: a negative
    one counts from the end (with ``k_max`` given; ``np.bincount`` refuses
    it otherwise, ``ValueError``), one outside [-N, N) raises
    ``IndexError``. Reads the host once (the indices' range and the
    longest track)."""
    n = p.landmarks.shape[0]
    dev = p.landmarks.device
    sel = torch.nonzero(p.obs_valid).reshape(-1)           # flat order
    lm = p.obs_lm[sel].long()
    lo = int(lm.min()) if lm.numel() else 0
    hi = int(lm.max()) if lm.numel() else 0
    if lo < -n or hi >= n:
        raise IndexError(f"tracks_from_flat: a valid obs_lm outside "
                         f"[-{n}, {n})")
    if lo < 0 and k_max is None:
        raise ValueError("tracks_from_flat: negative obs_lm with k_max "
                         "unset")
    lm = torch.where(lm < 0, lm + n, lm)
    order = torch.sort(lm, stable=True).indices
    lm, src = lm[order], sel[order]
    counts = torch.bincount(lm, minlength=n)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(lm.numel(), device=dev) - start[lm]
    if k_max is None:
        k_max = max(1, int(counts.max()) if n else 1)
    keep = rank < k_max
    rows, slots, src = lm[keep], rank[keep], src[keep]
    obs_pose = torch.zeros((n, k_max), dtype=torch.int32, device=dev)
    obs_uv = torch.zeros((n, k_max, 2), dtype=torch.float32, device=dev)
    obs_valid = torch.zeros((n, k_max), dtype=torch.bool, device=dev)
    obs_pose[rows, slots] = p.obs_pose[src].to(torch.int32)
    obs_uv[rows, slots] = p.obs_uv[src].to(torch.float32)
    obs_valid[rows, slots] = True
    return BATracks(poses=p.poses, landmarks=p.landmarks, obs_pose=obs_pose,
                    obs_uv=obs_uv, obs_valid=obs_valid,
                    intrinsics=p.intrinsics, fixed_poses=p.fixed_poses)


def _obs_poses(p: BATracks, ring_layout: bool = False) -> torch.Tensor:
    """(..., N, K, 4, 4) pose per observation; in the ring layout
    (``obs_pose[n, j] == j``) a broadcast."""
    if ring_layout:
        return p.poses[..., None, :, :, :].expand(
            p.obs_uv.shape[:-1] + (4, 4))
    idx = gather_index(p.obs_pose, p.poses.shape[-3])
    if p.poses.dim() == 4:
        si = torch.arange(p.poses.shape[0], device=p.poses.device)
        return p.poses[si[:, None, None], idx]
    return p.poses[idx]


def _huber(nrm: torch.Tensor, huber: float) -> torch.Tensor:
    return torch.where(nrm <= huber, torch.ones_like(nrm),
                       huber / nrm.clamp(min=1e-12))


def track_residuals(p: BATracks, ring_layout: bool = False) -> torch.Tensor:
    """(..., N, K, 2) reprojection residuals, masked slots -> 0."""
    T = _obs_poses(p, ring_layout)
    r = project(T, p.landmarks[..., :, None, :], p.intrinsics) - p.obs_uv
    return torch.where(p.obs_valid[..., None], r, torch.zeros_like(r))


def _track_jacobians(p: BATracks, ring_layout: bool = False):
    """r (...,N,K,2), Jp (...,N,K,2,6) wrt the pose twist, Jl
    (...,N,K,2,3)."""
    T = _obs_poses(p, ring_layout)
    X = p.landmarks[..., :, None, :].expand(p.obs_uv.shape[:-1] + (3,))
    pred, Jp, Jl = proj_jacobians(T, X, p.intrinsics)
    return pred - p.obs_uv, Jp, Jl


def _tracks_cost64(p: BATracks, huber: float,
                   ring_layout: bool = False) -> torch.Tensor:
    """The Huber-weighted squared residuals summed in float64, one a
    stream."""
    r = track_residuals(p, ring_layout)
    w = _huber(torch.linalg.norm(r, dim=-1), huber)
    c = w * (r * r).sum(-1)
    return torch.where(p.obs_valid, c, torch.zeros_like(c)).sum(
        dim=(-2, -1), dtype=torch.float64)


def _tracks_cost(p: BATracks, huber: float,
                 ring_layout: bool = False) -> torch.Tensor:
    """Plain version of K6's cost: ``_tracks_cost64`` rounded to
    float32."""
    return _tracks_cost64(p, huber, ring_layout).float()


def rhs_term_scale(p: BATracks, huber: float,
                   ring_layout: bool = False) -> float:
    """The scale that the rounding of rhs = bp - sum W bl is relative to:
    the largest entry of sum |Jp_w^T| |r| (a host float, over every
    stream). The two sums cancel to far below their terms, so a tolerance
    on rhs is set against its terms, not its value."""
    r, Jp, _ = _track_jacobians(p, ring_layout)
    w = _huber(torch.linalg.norm(r, dim=-1), huber) * p.obs_valid
    return float(torch.einsum("...nkri,...nkr->...ki",
                              (Jp * w[..., None, None]).abs(),
                              r.abs()).max())


def _tracks_assemble(p: BATracks, lam, huber: float,
                     ring_layout: bool = False, linalg: str = "lu",
                     reduce: Optional[Callable] = None):
    """Plain version of K6's assembly. Returns (S (M,6,M,6), rhs (M,6),
    cost) in float32 and the landmark-local (Hll_inv (N,3,3), bl (N,3),
    U (N,K,6,3) in float64, pose_idx or None, seen (N,)), each with the
    problem's leading stream dimensions (``lam`` one a stream). Pose
    damping is added in ``_tracks_solve_poses``; landmark damping here.
    ``reduce`` maps the float64 (S, rhs, cost) sums before they are
    rounded (the sharded route's all-reduce)."""
    m = p.poses.shape[-3]
    r, Jp, Jl = _track_jacobians(p, ring_layout)
    w = _huber(torch.linalg.norm(r, dim=-1), huber)
    w = torch.where(p.obs_valid, w, torch.zeros_like(w))       # (N, K)
    cost = (w * (r * r).sum(-1)).sum(dim=(-2, -1), dtype=torch.float64)
    # the landmark blocks and their Schur terms in float64 (module doc)
    r, Jp, Jl, w = r.double(), Jp.double(), Jl.double(), w.double()
    Jp_w = Jp * w[..., None, None]
    Jl_w = Jl * w[..., None, None]

    Hll = torch.einsum("...nkri,...nkrj->...nij", Jl_w, Jl)
    bl = -torch.einsum("...nkri,...nkr->...ni", Jl_w, r)
    U = torch.einsum("...nkri,...nkrj->...nkij", Jp_w, Jl)     # (N,K,6,3)

    seen = w.sum(-1) > 0
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    damp = (lam + 1e-6)[..., None, None, None] if torch.is_tensor(lam) \
        else lam + 1e-6
    Hll_d = torch.where(seen[..., None, None],
                        Hll + damp * eye3, eye3.expand_as(Hll))
    bl = torch.where(seen[..., None], bl, torch.zeros_like(bl))
    Hll_inv = _inv_lu(Hll_d) if linalg == "lu" else _inv3(Hll_d)
    W = torch.einsum("...nkij,...njc->...nkic", U, Hll_inv)     # (N,K,6,3)

    ar = torch.arange(m, device=Hll.device)
    if ring_layout:
        pose_idx = None
        Hpp = torch.einsum("...nkri,...nkrj->...kij", Jp_w, Jp)
        bp = -torch.einsum("...nkri,...nkr->...ki", Jp_w, r)
        S = -torch.einsum("...nkij,...nlmj->...klim", W, U)     # (M,M,6,6)
        S[..., ar, ar, :, :] += Hpp
        rhs = bp - torch.einsum("...nkij,...nj->...ki", W, bl)
    else:
        if p.landmarks.dim() != 2:
            raise NotImplementedError(
                "ba_solve_tracks: the generic (non-ring) layout takes one "
                "problem, not streams")
        # invalid slots go to pose 0 with weight 0; a valid slot's pose
        # follows JAX's rules: gathered clamped (dp in the back-substitution),
        # scattered or dropped (row m, cut off below)
        zero = torch.zeros_like(p.obs_pose, dtype=torch.long)
        pose_idx = torch.where(p.obs_valid, gather_index(p.obs_pose, m), zero)
        sidx = torch.where(p.obs_valid, scatter_index(p.obs_pose, m), zero)
        si = sidx.reshape(-1)
        Hpp = torch.zeros((m + 1, 6, 6), dtype=Jp.dtype, device=Jp.device)
        Hpp.index_add_(0, si, torch.einsum(
            "nkri,nkrj->nkij", Jp_w, Jp).reshape(-1, 6, 6))
        bp = torch.zeros((m + 1, 6), dtype=Jp.dtype, device=Jp.device)
        bp.index_add_(0, si, -torch.einsum(
            "nkri,nkr->nki", Jp_w, r).reshape(-1, 6))
        pair = torch.einsum("nkij,nlmj->nklim", W, U)           # (N,K,K,6,6)
        both = (sidx[:, :, None] < m) & (sidx[:, None, :] < m)
        flat = torch.where(both, sidx[:, :, None] * m + sidx[:, None, :],
                           m * m).reshape(-1)
        S = torch.zeros((m * m + 1, 6, 6), dtype=Jp.dtype, device=Jp.device)
        S.index_add_(0, flat, -pair.reshape(-1, 6, 6))
        S = S[:m * m].view(m, m, 6, 6)
        S[ar, ar] += Hpp[:m]
        Wbl = torch.zeros((m + 1, 6), dtype=Jp.dtype, device=Jp.device)
        Wbl.index_add_(0, si, torch.einsum(
            "nkij,nj->nki", W, bl).reshape(-1, 6))
        rhs = bp[:m] - Wbl[:m]
    if reduce is not None:
        S, rhs, cost = reduce((S, rhs, cost))
    S = S.transpose(-3, -2).float().contiguous()                 # (M,6,M,6)
    return ((S, rhs.float(), cost.float()),
            (Hll_inv, bl, U, pose_idx, seen))


def _tracks_solve_poses(S, rhs, fixed_poses, lam, linalg: str = "lu"):
    """The damped, gauge-fixed, Jacobi-scaled (6M, 6M) pose solve, one a
    stream."""
    m = rhs.shape[-2]
    lead = rhs.shape[:-2]
    S = S.reshape(lead + (m * 6, m * 6))
    eye = torch.eye(m * 6, dtype=S.dtype, device=S.device)
    damp = lam[..., None, None] if torch.is_tensor(lam) else lam
    S = S + damp * eye
    fixed = fixed_poses[..., :, None].expand(lead + (m, 6)).reshape(
        lead + (m * 6,))
    S = torch.where(fixed[..., :, None] | fixed[..., None, :], eye, S)
    rhs = rhs.reshape(lead + (m * 6,))
    rhs = torch.where(fixed, torch.zeros_like(rhs), rhs)
    d = torch.rsqrt(torch.diagonal(S, dim1=-2, dim2=-1).clamp(min=1e-12))
    Sp = S * d[..., :, None] * d[..., None, :]
    if linalg == "chol":
        dp = d * chol_solve(Sp, d * rhs)
    else:
        dp = d * lu_solve(Sp, d * rhs)
    return dp.reshape(lead + (m, 6))


def _tracks_backsub(local, dp):
    """Plain version of K6's back-substitution: dl = Hll_inv (bl - Σ U dp),
    zero where the landmark is unseen."""
    Hll_inv, bl, U, pose_idx, seen = local
    dp = dp.to(U.dtype)
    if pose_idx is None:
        Udp = torch.einsum("...nkij,...ki->...nj", U, dp)
    else:
        Udp = torch.einsum("nkij,nki->nj", U, dp[pose_idx])
    dl = torch.einsum("...nij,...nj->...ni", Hll_inv, bl - Udp).float()
    return torch.where(seen[..., None], dl, torch.zeros_like(dl))


def apply_pose_step(poses: torch.Tensor, dp: torch.Tensor,
                    fixed: torch.Tensor) -> torch.Tensor:
    """``se3_exp(dp_k) @ T_k`` for every free pose."""
    cand = se3_exp(dp) @ poses
    return torch.where(fixed[..., None, None], poses, cand)


def ba_solve_tracks(p: BATracks, *, iters: int = 10, huber: float = 4.0,
                    lam0: float = 1e-3, mesh=None, axis: str = "lm",
                    ring_layout: bool = False, linalg: str = "lu"
                    ) -> Tuple[BATracks, torch.Tensor]:
    """Levenberg-Marquardt over a landmark-major problem; returns (refined
    problem, (iters,) accepted costs). S problems (a leading S on every
    field but ``intrinsics``) are solved side by side, each with its own
    damping and decisions; the costs are then (S, iters).

    ``ring_layout=True`` promises ``obs_pose[n, j] == j`` (K == M). On CUDA
    tensors it runs kernel K6: every iteration of every problem in one
    launch, M at most ``ba_cuda.MAX_POSES``; a ring of more poses runs
    kernel K9 with ``obs_pose = arange(M)``, one launch a problem (S
    launches for S streams, in stream order on the caller's CUDA stream,
    each stream with its own damping and decisions). The generic layout
    takes one problem; on
    CUDA tensors it runs kernel K9 at any M, K and N: what grows with M
    sits in shared memory where it fits and in device memory where it does
    not, with the same bits (``ba_generic_cuda.k9_routes``; on the H100
    the step leaves shared memory past M 2640, the landmark stage past
    3630, the index past 6453, and the pose solve's panel past M 1612 at a
    full band). ``linalg`` is "lu" (pivoted landmark
    inverses and pose solve) or "chol" (closed-form scaled Cholesky
    inverses and a Cholesky pose solve). Raises ``NotImplementedError``
    for the generic layout with a stream dimension.

    With ``mesh`` the landmarks shard over ``axis`` (N divisible by its
    size): every rank calls with the whole problem, assembles its block,
    all-reduces S, rhs and the cost, solves the poses, back-substitutes its
    landmarks and all-reduces each trial cost; the landmarks are
    all-gathered at the end. This route runs the plain stages on every
    device, the card included: K6 and K9 hold the whole LM loop in one
    launch, where a reduction across ranks cannot sit (module
    docstring)."""
    if linalg not in ("lu", "chol"):
        raise ValueError(f"ba_solve_tracks: unknown linalg {linalg!r}")
    if ring_layout and p.obs_pose.shape[-1] != p.poses.shape[-3]:
        raise ValueError("ring_layout requires K == M (obs column j "
                         "observed by pose j)")
    if not ring_layout and p.landmarks.dim() != 2:
        raise NotImplementedError(
            "ba_solve_tracks: the generic (non-ring) layout takes one "
            "problem, not streams")
    if mesh is not None:
        return _lm_tracks_sharded(p, iters, huber, lam0, ring_layout, linalg,
                                  mesh, axis)
    return _lm_tracks(p, iters, huber, lam0, ring_layout, linalg,
                      kernel=p.landmarks.device.type == "cuda")


def _lm_tracks_sharded(p: BATracks, iters: int, huber: float, lam0: float,
                       ring_layout: bool, linalg: str, mesh, axis: str):
    """``_lm_plain`` on this rank's landmark block (rows ``rank * N/n``
    on), its float64 sums all-reduced over ``axis``: every decision is made
    on reduced, replicated values, so the ranks stay equal. The landmarks
    are all-gathered at the end."""
    n_ax, rank = mesh.size(axis), mesh.get_local_rank(axis)
    n = p.landmarks.shape[-2]
    if n % n_ax:
        raise ValueError(f"ba_solve_tracks: {n} landmarks do not shard over "
                         f"{n_ax} ranks of {axis!r}")
    lead = p.landmarks.shape[:-2]
    if iters == 0:
        return p, torch.empty(lead + (0,), dtype=torch.float32,
                              device=p.landmarks.device)
    sl = slice(rank * (n // n_ax), (rank + 1) * (n // n_ax))
    part = p._replace(landmarks=p.landmarks[..., sl, :],
                      obs_pose=p.obs_pose[..., sl, :],
                      obs_uv=p.obs_uv[..., sl, :, :],
                      obs_valid=p.obs_valid[..., sl, :])
    part, costs = _lm_plain(part, iters, huber, lam0, ring_layout, linalg,
                            reduce=lambda t: _all_reduce_parts(t, mesh, axis))
    # (n, ..., N/n, 3) blocks back into rows in rank order
    blocks = all_gather_stack(part.landmarks, mesh, axis)
    return (p._replace(poses=part.poses,
                       landmarks=torch.cat(tuple(blocks), dim=-2)), costs)


def _lm_tracks(p: BATracks, iters: int, huber: float, lam0: float,
               ring_layout: bool, linalg: str, kernel: bool):
    """The LM loop of ``ba_solve_tracks``: with ``kernel`` (CUDA tensors)
    K6's one launch on the ring layout, or K9's one launch on the generic
    one; a ring of more poses than K6 takes runs K9 with ``obs_pose =
    arange(M)``, one launch a stream, in stream order (K9 takes one
    problem), the results stacked. Else the plain version below (on any
    device). Every stream's decisions and damping are its own.
    No iteration returns ``p`` itself and empty costs, as the JAX
    package's ``lax.scan(length=0)`` does, and launches nothing."""
    lead = p.landmarks.shape[:-2]
    if iters == 0:
        return p, torch.empty(lead + (0,), dtype=torch.float32,
                              device=p.landmarks.device)
    if kernel:
        from . import ba_cuda
        from .ba_generic_cuda import lm_generic
        fused = ba_cuda.lm_tracks if ring_layout else lm_generic
        m = p.poses.shape[-3]
        if ring_layout and m > ba_cuda.MAX_POSES:
            # K6 holds at most MAX_POSES poses; K9 takes one ring problem of
            # any size as the generic layout with obs_pose[n, j] = j: one
            # launch a stream, each on the stream's own problem
            flat = BATracks(*(t if i == 5 else t.reshape(
                (-1,) + t.shape[len(lead):]) for i, t in enumerate(p)))
            arange = torch.arange(m, dtype=torch.int32,
                                  device=p.landmarks.device)
            outs = []
            for s in range(lead.numel()):
                one = BATracks(*(t if i == 5 else t[s]
                                 for i, t in enumerate(flat)))
                outs.append(lm_generic(one._replace(obs_pose=arange.expand(
                    one.obs_valid.shape).contiguous()), iters, huber, lam0,
                    linalg)[:3])
            poses, lms, costs = (torch.stack(t).reshape(lead + t[0].shape)
                                 for t in zip(*outs))
        else:
            poses, lms, costs, _ = fused(p, iters, huber, lam0, linalg)
        return p._replace(poses=poses, landmarks=lms), costs
    return _lm_plain(p, iters, huber, lam0, ring_layout, linalg)


def _lm_plain(p: BATracks, iters: int, huber: float, lam0: float,
              ring_layout: bool, linalg: str,
              reduce: Optional[Callable] = None):
    """The plain LM loop, the plain version of K6 and K9 (any device; at
    least one iteration), every stream's decisions and damping its own.
    ``reduce`` sums a tuple of float64 partial sums over the ranks of the
    sharded route: S, rhs and the cost before they are rounded, and each
    trial cost."""
    lead = p.landmarks.shape[:-2]
    poses0, lms0 = p.poses, p.landmarks
    lam = torch.full(lead, lam0, dtype=torch.float32, device=lms0.device)
    costs = []
    for _ in range(iters):
        prob = p._replace(poses=poses0, landmarks=lms0)
        (S, rhs, cost), local = _tracks_assemble(
            prob, lam, huber, ring_layout, linalg, reduce=reduce)
        dp = _tracks_solve_poses(S, rhs, p.fixed_poses, lam, linalg)
        cand_poses = apply_pose_step(poses0, dp, p.fixed_poses)
        cand_lms = lms0 + _tracks_backsub(local, dp)
        new_cost = _tracks_cost64(p._replace(poses=cand_poses,
                                             landmarks=cand_lms),
                                  huber, ring_layout)
        if reduce is not None:
            (new_cost,) = reduce((new_cost,))
        new_cost = new_cost.float()
        accept = new_cost < cost
        poses0 = torch.where(accept[..., None, None, None], cand_poses,
                             poses0)
        lms0 = torch.where(accept[..., None, None], cand_lms, lms0)
        lam = torch.where(accept, (lam * 0.3).clamp(min=1e-8),
                          (lam * 4.0).clamp(max=1e4))
        costs.append(torch.where(accept, new_cost, cost))
    return (p._replace(poses=poses0, landmarks=lms0),
            torch.stack(costs, dim=-1))
