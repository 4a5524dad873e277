"""Multi-view triangulation (port of part of
``vpp_tpu.algorithms.geometry``).

Only ``triangulate_ls``, the SLAM keyframe path's batched two-view DLT, is
ported so far; the epipoles, ``triangulate`` (SVD) and
``fundamental_from_projections`` follow with the rest of the geometry.
Coordinates are homogeneous (x=col, y=row, 1) here, as in the JAX module.
"""

from __future__ import annotations

import torch


def triangulate_ls(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor,
                   x2: torch.Tensor) -> torch.Tensor:
    """Batched 2-view DLT in inhomogeneous form: the four DLT rows solved
    as A[:, :3] X = -A[:, 3] through 3x3 normal equations, inverted with
    ``slam.ba._inv3`` (as the JAX module does, so near-degenerate points
    fail the same gates downstream).

    P1/P2: (N, 3, 4) or (3, 4); x1/x2: (N, 2) pixel (x=col, y=row).
    Returns (N, 3)."""
    from ..slam.ba import _inv3
    n = x1.shape[0]
    P1 = P1.expand(n, 3, 4)
    P2 = P2.expand(n, 3, 4)
    rows = torch.stack([
        x1[:, 0, None] * P1[:, 2] - P1[:, 0],
        x1[:, 1, None] * P1[:, 2] - P1[:, 1],
        x2[:, 0, None] * P2[:, 2] - P2[:, 0],
        x2[:, 1, None] * P2[:, 2] - P2[:, 1]], dim=1)      # (N, 4, 4)
    A = rows[:, :, :3]
    b = -rows[:, :, 3]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    AtA = torch.einsum("nei,nej->nij", A, A) + 1e-9 * eye
    Atb = torch.einsum("nei,ne->ni", A, b)
    return torch.einsum("nij,nj->ni", _inv3(AtA), Atb)
