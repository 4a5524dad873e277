"""Unscented Kalman filter, CTRV model (port of ``vpp_tpu.algorithms.ukf``).

State dim 5 [pos1, pos2, v, yaw, yaw-rate], augmented dim 7 (two process
noises), λ = 3 − n_aug; augmented sigma points from a Cholesky factor, the
CTRV process on all 15 points, the predicted mean and covariance, and a
measurement update on an observation of the state. The Hough tracker feeds
(ρ, θ) detections and filters in accumulator space.

Every function is batched over leading dims: ``x`` (..., 5), ``P``
(..., 5, 5), so the tracker advances its whole bank of C filters in one
call, as the JAX package's ``vmap`` does. Float32 throughout, with no host
read: a covariance that is not positive definite gives a NaN factor for
that filter alone (``cholesky_ex``, as ``jnp.linalg.cholesky`` returns
NaN), and the 2x2 innovation covariance is inverted by ``inv_ex``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from .._device import device_constant, resolve_device

N_X = 5
N_AUG = 7
LAMBDA = 3.0 - N_AUG


class UKFState(NamedTuple):
    x: torch.Tensor   # (..., 5) state
    P: torch.Tensor   # (..., 5, 5) covariance


def ukf_init(x0=None, p0: float = 1.0, device="cuda") -> UKFState:
    """One filter at ``x0`` (zeros by default) with covariance p0·I, on
    ``device`` (the card unless asked for the CPU)."""
    dev = resolve_device(device)
    x = (torch.zeros((N_X,), dtype=torch.float32, device=dev) if x0 is None
         else torch.as_tensor(x0, dtype=torch.float32, device=dev))
    return UKFState(x=x, P=torch.eye(N_X, dtype=torch.float32,
                                     device=dev) * p0)


def _weights(device) -> torch.Tensor:
    """(15,) sigma-point weights, the mean's and the covariance's."""
    n = 2 * N_AUG + 1
    return device_constant(
        (LAMBDA / (LAMBDA + N_AUG),) + (0.5 / (LAMBDA + N_AUG),) * (n - 1),
        torch.float32, device)


def _wsum(w: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Σ_i w_i pts_i over the sigma-point axis (-2)."""
    return (w[:, None] * pts).sum(-2)


def _wouter(w: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """Σ_i w_i a_i b_iᵀ over the sigma-point axis (-2)."""
    return (w[:, None] * a).mT @ b


def _with_angle(a: torch.Tensor, dims) -> torch.Tensor:
    """``a`` with its components ``dims`` (last axis) wrapped to (-π, π]."""
    if not dims:
        return a
    cols = list(a.unbind(-1))
    for d in dims:
        cols[d] = _norm_angle(cols[d])
    return torch.stack(cols, dim=-1)


def _augmented_sigma_points(st: UKFState, std_a: float,
                            std_yawdd: float) -> torch.Tensor:
    """(..., 15, 7) augmented sigma points."""
    x, P = st.x, st.P
    lead = x.shape[:-1]
    dev = x.device
    x_aug = torch.cat([x, x.new_zeros(lead + (2,))], dim=-1)
    P_aug = torch.zeros(lead + (N_AUG, N_AUG), dtype=torch.float32,
                        device=dev)
    P_aug[..., :N_X, :N_X] = P
    noise = torch.zeros((N_AUG, N_AUG), dtype=torch.float32, device=dev)
    noise[5, 5].fill_(std_a ** 2)
    noise[6, 6].fill_(std_yawdd ** 2)
    P_aug = P_aug + noise
    eye = torch.eye(N_AUG, dtype=torch.float32, device=dev)
    L, info = torch.linalg.cholesky_ex(P_aug + 1e-9 * eye)
    # jnp.linalg.cholesky: a NaN factor where the matrix is not PD
    L = torch.where((info != 0)[..., None, None],
                    torch.full_like(L, float("nan")), L)
    s = (LAMBDA + N_AUG) ** 0.5
    cols = (s * L).mT                              # row i: s·L[:, i]
    xa = x_aug[..., None, :]
    return torch.cat([xa, xa + cols, xa - cols], dim=-2)


def _ctrv_process(sp: torch.Tensor, dt: float) -> torch.Tensor:
    """CTRV motion model on (..., 7) augmented sigma points; the
    near-zero yaw rate takes the straight-line branch."""
    px, py, v, yaw, yawd, nu_a, nu_yawdd = sp.unbind(-1)
    eps = 1e-3
    straight = yawd.abs() < eps
    yawd_safe = torch.where(straight, torch.ones_like(yawd), yawd)
    px_t = torch.where(
        straight,
        px + v * dt * torch.cos(yaw),
        px + v / yawd_safe * (torch.sin(yaw + yawd * dt) - torch.sin(yaw)))
    py_t = torch.where(
        straight,
        py + v * dt * torch.sin(yaw),
        py + v / yawd_safe * (torch.cos(yaw) - torch.cos(yaw + yawd * dt)))
    px_t = px_t + 0.5 * nu_a * dt * dt * torch.cos(yaw)
    py_t = py_t + 0.5 * nu_a * dt * dt * torch.sin(yaw)
    v_t = v + nu_a * dt
    yaw_t = yaw + yawd * dt + 0.5 * nu_yawdd * dt * dt
    yawd_t = yawd + nu_yawdd * dt
    return torch.stack([px_t, py_t, v_t, yaw_t, yawd_t], dim=-1)


def _norm_angle(a: torch.Tensor) -> torch.Tensor:
    return torch.atan2(torch.sin(a), torch.cos(a))


def _psd(P: torch.Tensor, cap: float = 1e3) -> torch.Tensor:
    """Symmetrise, scale down so the largest variance is at most ``cap``,
    add 1e-6·I: keeps P positive definite through the K S Kᵀ subtraction
    and bounds the spread of the unobservable dims."""
    P = 0.5 * (P + P.mT)
    dmax = P.diagonal(dim1=-2, dim2=-1).amax(-1)
    scale = torch.clamp(cap / dmax.clamp(min=1e-9), max=1.0)
    eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
    return P * scale[..., None, None] + 1e-6 * eye


def ukf_predict(st: UKFState, dt: float, *, std_a: float = 2.0,
                std_yawdd: float = 0.3
                ) -> Tuple[UKFState, torch.Tensor]:
    """Prediction step: the new state and the (..., 15, 5) predicted sigma
    points (kept for the update)."""
    sp = _ctrv_process(_augmented_sigma_points(st, std_a, std_yawdd), dt)
    w = _weights(sp.device)
    x = _wsum(w, sp)
    d = _with_angle(sp - x[..., None, :], (3,))
    P = _wouter(w, d, d)
    return UKFState(x=_with_angle(x, (3,)), P=_psd(P)), sp


def ukf_update(st: UKFState, sp: torch.Tensor, z: torch.Tensor,
               h: Callable[[torch.Tensor], torch.Tensor], Rm: torch.Tensor,
               angle_dims: Tuple[int, ...] = ()) -> UKFState:
    """Measurement update with observation function ``h`` (batched: it
    maps (..., 5) states to (..., nz)) and noise ``Rm`` (nz, nz).
    ``angle_dims`` lists measurement components that wrap."""
    w = _weights(sp.device)
    zsig = h(sp)                                      # (..., 15, nz)
    zpred = _wsum(w, zsig)
    dz = _with_angle(zsig - zpred[..., None, :], angle_dims)
    S = _wouter(w, dz, dz) + Rm
    dx = _with_angle(sp - st.x[..., None, :], (3,))
    Tc = _wouter(w, dx, dz)
    S_inv, _ = torch.linalg.inv_ex(S)
    K = Tc @ S_inv
    innov = _with_angle(z - zpred, angle_dims)
    x = _with_angle(st.x + (K @ innov[..., None])[..., 0], (3,))
    P = st.P - K @ S @ K.mT
    return UKFState(x=x, P=_psd(P))


def rho_theta_measurement(x: torch.Tensor) -> torch.Tensor:
    """Observation: the state's (pos1, pos2) read as (ρ, θ)."""
    return x[..., :2]


def ukf_predict_update_rho_theta(st: UKFState, z: torch.Tensor, dt: float,
                                 *, std_a: float = 0.5,
                                 std_yawdd: float = 0.05,
                                 std_rho: float = 3.0,
                                 std_theta: float = 0.05) -> UKFState:
    """One predict+update cycle on a (ρ, θ) detection (θ wraps)."""
    st2, sp = ukf_predict(st, dt, std_a=std_a, std_yawdd=std_yawdd)
    Rm = device_constant((std_rho ** 2, 0.0, 0.0, std_theta ** 2),
                         torch.float32, sp.device).view(2, 2)
    return ukf_update(st2, sp, z, rho_theta_measurement, Rm,
                      angle_dims=(1,))
