"""Epipolar geometry and multi-view triangulation (port of
``vpp_tpu.algorithms.geometry``): plain batched linear algebra, as the JAX
module computes it with ``jnp.linalg``.

* ``epipole_left`` / ``epipole_right``: the null vectors of F F^T / F^T F
  by symmetric eigen-decomposition (smallest eigenvalue) in float64,
  dehomogenised to float32.
* ``epipolar_line``: l' = F x for homogenised points.
* ``triangulate``: two-view DLT solved by a batched SVD of the four DLT
  rows; ``triangulate_ls``: the same rows as 3x3 normal equations, the SLAM
  keyframe path's batched form.
* ``fundamental_from_projections`` and ``reprojection_error``.

Coordinates are homogeneous (x=col, y=row, 1) here, as in the JAX module.
Inputs are taken as float32 tensors (numpy arrays too), on their device.
An SVD or eigenvector is defined up to sign, so F is defined up to sign;
the epipoles and points are dehomogenised and do not depend on it.
"""

from __future__ import annotations

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _dehomogenise(v: torch.Tensor, eps: float, fill: float) -> torch.Tensor:
    """v[..., :-1] / v[..., -1], the last coordinate replaced by ``fill``
    where its magnitude is below ``eps``."""
    w = v[..., -1:]
    w = torch.where(w.abs() < eps, torch.full_like(w, fill), w)
    return v[..., :-1] / w


def epipole_right(F) -> torch.Tensor:
    """Right epipole e with F e = 0: the null vector of F^T F (eigenvector
    of the smallest eigenvalue), dehomogenised (a last coordinate below
    1e-12 divides by 1), returned in float32. F^T F and its eigenvectors
    are taken in float64: the float32 null vector of F^T F is only as good
    as its eigenvalue gap."""
    F = _f32(F).double()
    _, vecs = torch.linalg.eigh(F.mT @ F)    # ascending eigenvalues
    return _dehomogenise(vecs[..., :, 0], 1e-12, 1.0).float()


def epipole_left(F) -> torch.Tensor:
    """Left epipole e' with e'^T F = 0: the null vector of F F^T."""
    return epipole_right(_f32(F).mT)


def epipolar_line(F, x) -> torch.Tensor:
    """Lines l' = F x for (N, 2) points x (homogenised); returns (N, 3)."""
    x = _f32(x)
    hom = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
    return hom @ _f32(F).to(x.device).mT


def _dlt_rows(P1, P2, x1, x2) -> torch.Tensor:
    """The four DLT rows of each correspondence, (N, 4, 4)."""
    return torch.stack([
        x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :]], dim=-2)


def triangulate(P1, P2, x1, x2) -> torch.Tensor:
    """Triangulate correspondences x1 <-> x2 ((N, 2) pixel coordinates in
    views 1 and 2) from (3, 4) projection matrices: each point the null
    vector of its four DLT rows by a batched SVD, dehomogenised (a last
    coordinate below 1e-12 divides by 1e-12). Returns (N, 3)."""
    x1 = torch.atleast_2d(_f32(x1))
    x2 = torch.atleast_2d(_f32(x2)).to(x1.device)
    P1 = _f32(P1).to(x1.device)
    P2 = _f32(P2).to(x1.device)
    _, _, vh = torch.linalg.svd(_dlt_rows(P1, P2, x1, x2))
    return _dehomogenise(vh[..., -1, :], 1e-12, 1e-12)


def triangulate_ls(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor,
                   x2: torch.Tensor) -> torch.Tensor:
    """Batched 2-view DLT in inhomogeneous form: the four DLT rows solved
    as A[:, :3] X = -A[:, 3] through 3x3 normal equations, inverted with
    ``slam.ba._inv3`` (as the JAX module does, so near-degenerate points
    fail the same gates downstream).

    P1/P2: (N, 3, 4) or (3, 4); x1/x2: (N, 2) pixel (x=col, y=row).
    Returns (N, 3). Leading dimensions are batch dimensions: x (S, N, 2)
    with P broadcastable to (S, N, 3, 4)."""
    from ..slam.ba import _inv3
    lead = x1.shape[:-1]
    rows = _dlt_rows(P1.expand(lead + (3, 4)), P2.expand(lead + (3, 4)),
                     x1, x2)
    A = rows[..., :3]
    b = -rows[..., 3]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    AtA = torch.einsum("...ei,...ej->...ij", A, A) + 1e-9 * eye
    Atb = torch.einsum("...ei,...e->...i", A, b)
    return torch.einsum("...ij,...j->...i", _inv3(AtA), Atb)


def fundamental_from_projections(P1, P2) -> torch.Tensor:
    """F from two projection matrices: F = [e']_x P2 P1^+ with e' = P2 C,
    C the camera centre of P1 (its SVD null vector; F is defined up to
    that vector's sign)."""
    P1 = _f32(P1)
    P2 = _f32(P2).to(P1.device)
    _, _, vh = torch.linalg.svd(P1)
    e2 = P2 @ vh[-1]
    z = torch.zeros_like(e2[0])
    ex = torch.stack([torch.stack([z, -e2[2], e2[1]]),
                      torch.stack([e2[2], z, -e2[0]]),
                      torch.stack([-e2[1], e2[0], z])])
    return ex @ P2 @ torch.linalg.pinv(P1)


def reprojection_error(P, X, x) -> torch.Tensor:
    """(N,) pixel reprojection error of world points X under P (a
    projected depth below 1e-12 divides by 1e-12)."""
    X = torch.atleast_2d(_f32(X))
    x = torch.atleast_2d(_f32(x)).to(X.device)
    hom = torch.cat([X, torch.ones_like(X[:, :1])], dim=1)
    proj = hom @ _f32(P).to(X.device).mT
    return torch.linalg.norm(_dehomogenise(proj, 1e-12, 1e-12) - x, dim=1)
