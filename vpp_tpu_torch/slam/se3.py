"""SE(3)/SO(3) Lie-group maps (port of ``vpp_tpu.slam.se3``).

Every function broadcasts over leading batch dimensions, in float32 like
the JAX package. The small-angle branches use the same Taylor series and
thresholds, selected with ``torch.where`` so nothing syncs the host.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1)], -2)


def _abc(t2: torch.Tensor):
    """a = sinθ/θ, b = (1-cosθ)/θ², c = (θ-sinθ)/θ³ from t2 = θ², with
    Taylor series below ``_EPS``."""
    small = t2 < _EPS
    t2s = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(th)) / t2s)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (th - torch.sin(th)) / (t2s * th))
    return a, b, c


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        like.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues)."""
    t2 = (w * w).sum(-1)[..., None, None]
    K = _hat(w)
    a, b, _ = _abc(t2)
    return _eye3(K) + a * K + b * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle, stable for small angles."""
    tr = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1) / 2,
                     -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(tr)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    small = theta < _EPS
    s = torch.where(small, 0.5 + theta * theta / 12.0,
                    theta / (2.0 * torch.sin(torch.where(
                        small, torch.ones_like(theta), theta))))
    return v * s[..., None]


def _homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[R | t] over the row (0, 0, 0, 1), built on the device (no host
    copy)."""
    out = torch.nn.functional.pad(torch.cat([R, t[..., None]], dim=-1),
                                  (0, 0, 0, 1))
    out[..., 3, 3].fill_(1.0)
    return out


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) [w | v] -> (..., 4, 4) homogeneous transform."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t2 = (w * w).sum(-1)[..., None, None]
    K = _hat(w)
    _, b, c = _abc(t2)
    V = _eye3(R) + b * K + c * (K @ K)
    t = (V @ v[..., None])[..., 0]
    return _homogeneous(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> twist (..., 6)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]
    K = _hat(w)
    t2 = theta * theta
    small = theta < _EPS
    one = torch.ones_like(theta)
    safe = torch.where(small, one, 2.0 * theta * torch.sin(theta))
    coef = torch.where(small, torch.full_like(theta, 1.0 / 12.0),
                       1.0 / torch.where(small, one, t2)
                       - (1.0 + torch.cos(theta)) / safe)
    Vinv = _eye3(R) - K / 2 + coef * (K @ K)
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return _homogeneous(Rt, -(Rt @ t[..., None])[..., 0])


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def se3_apply(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., 3)."""
    return (T[..., :3, :3] @ X[..., None])[..., 0] + T[..., :3, 3]
