"""SfM from line correspondences: pose estimation, vanishing points,
Plücker line algebra (port of ``vpp_tpu.slam.sfm``).

* ``pose_from_line_correspondences``: (R, t) from N 3-D line segments and
  their image segments, by a bank of damped Gauss-Newton solvers on SE(3)
  from ``restarts`` rotations spread over SO(3), all restarts in lockstep
  as one batch: the Jacobians from ``torch.func.vmap`` of
  ``torch.func.jacfwd`` (forward mode, as the JAX package), the 6x6 steps
  from ``torch.linalg.solve_ex`` (NaN where the solve fails, as
  ``jnp.linalg.solve``). The lowest-residual restart wins.
* ``vanishing_points``: every pair of (θ, ρ) lines votes its intersection,
  back-projected to a unit direction, into a (φ, ψ) accumulator; the
  ``top`` cells win, lower flat index first among equal votes (``top_k``).
* Plücker coordinates and their rigid transform.

Plain PyTorch on the operands' device; nothing reads the host.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..algorithms.hough import top_k
from ..core.image import saturate_cast
from .se3 import se3_exp


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


# -- Plücker lines ----------------------------------------------------------

def plucker_from_points(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """(..., 6) Plücker coordinates [d | m] of the line through p1, p2:
    d = p2 - p1 (normalised), m = p1 x d."""
    d = _unit(p2 - p1)
    return torch.cat([d, torch.linalg.cross(p1, d)], dim=-1)


def plucker_transform(L: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Rigid transform of Plücker lines: d' = R d, m' = R m + t x (R d)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    d = (R @ L[..., :3, None])[..., 0]
    m = (R @ L[..., 3:, None])[..., 0] + torch.linalg.cross(
        t.expand_as(d), d)
    return torch.cat([d, m], dim=-1)


def plucker_point_distance(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Distance from points X to lines L."""
    d, m = L[..., :3], L[..., 3:]
    X, d = torch.broadcast_tensors(X, d)
    return torch.linalg.vector_norm(torch.linalg.cross(X, d) - m, dim=-1)


# -- pose from line correspondences ----------------------------------------

def _line_residuals(xi: torch.Tensor, P1: torch.Tensor, P2: torch.Tensor,
                    normals: torch.Tensor) -> torch.Tensor:
    """(N, 2): the camera-frame endpoint directions of each 3-D line dotted
    with the observed image line's interpretation-plane normal. ``xi`` is
    (1, 6): the leading unit dimension keeps ``jacfwd``'s tangents float32
    through the SE(3) map (a 0-d tensor times a Python float gets a
    float64 tangent)."""
    T = se3_exp(xi)[0]
    R = T[:3, :3]
    t = T[:3, 3]
    c1 = _unit(P1 @ R.T + t)
    c2 = _unit(P2 @ R.T + t)
    return torch.stack([(c1 * normals).sum(-1), (c2 * normals).sum(-1)],
                       dim=-1)


def image_line_normals(l1: torch.Tensor, l2: torch.Tensor,
                       intr: torch.Tensor) -> torch.Tensor:
    """(N, 3) interpretation-plane normals from image segment endpoints
    ((row, col) pixels): n = x1 x x2 in normalised camera coordinates."""
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]

    def back(p):
        x = (p[..., 1] - cx) / fx
        y = (p[..., 0] - cy) / fy
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)

    return _unit(torch.linalg.cross(back(l1), back(l2)))


_RESTART_AXES = np.array(
    [[0, 0, 0], [np.pi / 2, 0, 0], [0, np.pi / 2, 0],
     [0, 0, np.pi / 2], [np.pi, 0, 0], [0, np.pi, 0],
     [0, 0, np.pi], [np.pi / 2, np.pi / 2, 0]], np.float32)


def pose_from_line_correspondences(
        start_points: torch.Tensor, end_points: torch.Tensor,
        img_l1: torch.Tensor, img_l2: torch.Tensor, intr: torch.Tensor, *,
        iters: int = 30, restarts: int = 8, lam: float = 1e-3,
        valid: torch.Tensor | None = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Camera-from-world (R (3, 3), t (3,), residual) from N 3-D line
    segments (world frame) and their observed image segments (pixel
    endpoints): ``restarts`` damped Gauss-Newton solvers from rotations
    spread over SO(3), the lowest-residual one returned."""
    dev = start_points.device
    normals = image_line_normals(img_l1, img_l2, intr)
    n = start_points.shape[0]
    w = (torch.ones((n,), dtype=torch.float32, device=dev) if valid is None
         else valid.to(torch.float32))

    def res(x):                                   # (6,) -> (2N,)
        return (_line_residuals(x[None], start_points, end_points, normals)
                * w[:, None]).reshape(-1)

    jac = vmap(jacfwd(res))
    bres = vmap(res)
    xi = torch.zeros((restarts, 6), dtype=torch.float32, device=dev)
    k = min(restarts, len(_RESTART_AXES))
    xi[:k, :3] = torch.from_numpy(_RESTART_AXES[:k]).to(dev)
    damp = torch.full((restarts,), lam, dtype=torch.float32, device=dev)
    eye = torch.eye(6, dtype=torch.float32, device=dev)
    for _ in range(iters):
        rf = bres(xi)                                        # (R, 2N)
        J = jac(xi)                                          # (R, 2N, 6)
        Jt = J.transpose(1, 2)
        H = Jt @ J + damp[:, None, None] * eye
        g = (Jt @ rf[..., None])[..., 0]
        dx, info = torch.linalg.solve_ex(H, g)
        dx = torch.where((info != 0)[:, None], torch.full_like(dx, math.nan),
                         dx)
        xi_new = xi - dx
        c_old = (rf * rf).sum(-1)
        r2 = bres(xi_new)
        c_new = (r2 * r2).sum(-1)
        accept = c_new < c_old
        xi = torch.where(accept[:, None], xi_new, xi)
        damp = torch.where(accept, torch.clamp(damp * 0.5, min=1e-9),
                           torch.clamp(damp * 5.0, max=1e3))
    r = bres(xi)
    costs = (r * r).sum(-1)
    best = torch.argmin(costs)
    T = se3_exp(xi[best])
    return T[:3, :3], T[:3, 3], costs[best]


# -- vanishing points ---------------------------------------------------------

def vanishing_points(theta: torch.Tensor, rho: torch.Tensor,
                     valid: torch.Tensor, intr: torch.Tensor, *,
                     n_phi: int = 90, n_psi: int = 180, top: int = 3
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dominant vanishing directions from detected (θ, ρ) image lines:
    (directions (top, 3), votes (top,)). Every valid pair of lines votes
    its intersection into a (φ, ψ) spherical accumulator (float32 sums of
    0/1 weights, exact in any order)."""
    dev = theta.device
    nl = theta.shape[0]
    L = torch.stack([torch.cos(theta), torch.sin(theta), -rho], dim=-1)
    a, b = torch.broadcast_tensors(L[:, None, :], L[None, :, :])
    inter = torch.linalg.cross(a, b)                          # (L, L, 3)
    ar = torch.arange(nl, device=dev)
    pair_ok = valid[:, None] & valid[None, :] & (ar[:, None] < ar[None, :])
    wgt = pair_ok.to(torch.float32).reshape(-1)
    x = inter.reshape(-1, 3)
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    zsafe = torch.where(x[:, 2].abs() < 1e-9, torch.full_like(x[:, 2], 1e-9),
                        x[:, 2])
    u = x[:, 0] / zsafe
    v = x[:, 1] / zsafe
    ray = _unit(torch.stack([(u - cx) / fx, (v - cy) / fy,
                             torch.ones_like(u)], dim=-1))
    ray = torch.where(ray[:, 2:3] < 0, -ray, ray)
    phi = torch.arccos(torch.clamp(ray[:, 2], -1, 1))
    psi = torch.arctan2(ray[:, 1], ray[:, 0])
    pi_ = math.pi
    pidx = saturate_cast(phi / (pi_ / 2) * n_phi, torch.int32).clamp(
        0, n_phi - 1)
    sidx = saturate_cast((psi + pi_) / (2 * pi_) * n_psi, torch.int32).clamp(
        0, n_psi - 1)
    acc = torch.zeros((n_phi, n_psi), dtype=torch.float32, device=dev)
    acc.index_put_((pidx.long(), sidx.long()), wgt, accumulate=True)
    votes, flat = top_k(acc.reshape(-1), top)
    pf = (flat // n_psi).to(torch.float32) + 0.5
    sf = (flat % n_psi).to(torch.float32) + 0.5
    phi_c = pf * (pi_ / 2) / n_phi
    psi_c = sf * 2 * pi_ / n_psi - pi_
    dirs = torch.stack([torch.sin(phi_c) * torch.cos(psi_c),
                        torch.sin(phi_c) * torch.sin(psi_c),
                        torch.cos(phi_c)], dim=-1)
    return dirs, votes
