"""Pose-graph optimisation: damped Gauss-Newton over SE(3) relative
constraints (port of ``vpp_tpu.slam.pose_graph``).

Nodes are keyframe poses, edges relative-pose measurements (odometry and
loop closures); the solver minimises sum_e w_e ||log(Z_e^-1 T_i^-1 T_j)||^2
over fixed-capacity masked edge lists. Per edge, the 6-vector residual and
the two 6x6 Jacobian blocks come from one ``torch.func.vmap`` of
``torch.func.jacfwd``, forward mode as in the JAX package: ``se3_log``
selects with ``torch.where`` at theta = 0, where every odometry edge sits at
its measured value, and forward mode drops the untaken branch's NaN tangent
(reverse mode would multiply it into the Jacobian). The dense (6M, 6M)
Hessian is assembled with ``index_put_(accumulate=True)`` and solved with
``torch.linalg.solve_ex`` (NaN where the solve fails, as ``jnp.linalg.solve``
returns); the LM accept and the damping update stay on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import jacfwd, vmap

from .se3 import se3_exp, se3_inverse, se3_log


class PoseGraph(NamedTuple):
    poses: torch.Tensor       # (M, 4, 4) world-from-keyframe (or any frame)
    edge_i: torch.Tensor      # (E,) int32
    edge_j: torch.Tensor      # (E,) int32
    edge_T: torch.Tensor      # (E, 4, 4) measured T_i^-1 T_j
    edge_w: torch.Tensor      # (E,) float32 information weight
    edge_valid: torch.Tensor  # (E,) bool
    fixed: torch.Tensor       # (M,) bool gauge anchors


def _edge_residual(di, dj, Ti, Tj, Z):
    """r = log(Z^-1 (exp(di) Ti)^-1 exp(dj) Tj): the local retraction."""
    Ti_d = se3_exp(di) @ Ti
    Tj_d = se3_exp(dj) @ Tj
    return se3_log(se3_inverse(Z) @ se3_inverse(Ti_d) @ Tj_d)


def _edge_poses(g: PoseGraph) -> Tuple[torch.Tensor, torch.Tensor]:
    return g.poses[g.edge_i.long()], g.poses[g.edge_j.long()]


def pose_graph_residuals(g: PoseGraph) -> torch.Tensor:
    """(E, 6) residuals at zero perturbation; invalid edges give 0."""
    Ti, Tj = _edge_poses(g)
    z6 = torch.zeros((Ti.shape[0], 6), dtype=Ti.dtype, device=Ti.device)
    r = _edge_residual(z6, z6, Ti, Tj, g.edge_T)
    return torch.where(g.edge_valid[:, None], r, torch.zeros_like(r))


def _blocks(Ti, Tj, Z):
    """One edge: (r (6,), Ji (6, 6), Jj (6, 6)) at zero perturbation.

    The edge carries a leading unit dimension through the SE(3) maps: under
    ``jacfwd`` a 0-d tensor times a Python float gets a float64 tangent
    (seen with PyTorch 2.13), which the maps' matrix products refuse."""
    z6 = torch.zeros((1, 6), dtype=Ti.dtype, device=Ti.device)

    def f(di, dj):
        r = _edge_residual(di, dj, Ti[None], Tj[None], Z[None])[0]
        return r, r

    (Ji, Jj), r = jacfwd(f, argnums=(0, 1), has_aux=True)(z6, z6)
    return r, Ji[:, 0], Jj[:, 0]


def pose_graph_solve(g: PoseGraph, *, iters: int = 10,
                     lam0: float = 1e-3) -> Tuple[PoseGraph, torch.Tensor]:
    """Damped Gauss-Newton; returns (optimised graph, (iters,) costs after
    each step's candidate)."""
    m = g.poses.shape[0]
    dev, dt = g.poses.device, g.poses.dtype
    ei, ej = g.edge_i.long(), g.edge_j.long()
    ar6 = torch.arange(6, device=dev)
    r6, c6 = ar6[None, :, None], ar6[None, None, :]
    w = torch.where(g.edge_valid, g.edge_w, torch.zeros_like(g.edge_w))
    wi = w[:, None, None]
    fixed = g.fixed[:, None].expand(m, 6).reshape(-1)
    pin = fixed[:, None] | fixed[None, :]
    eye = torch.eye(m * 6, dtype=dt, device=dev)
    lam = torch.full((), lam0, dtype=dt, device=dev)
    graph, costs = g, []
    for _ in range(iters):
        Ti, Tj = _edge_poses(graph)
        r, Ji, Jj = vmap(_blocks)(Ti, Tj, graph.edge_T)
        cost = (w * (r * r).sum(-1)).sum()

        H = torch.zeros((m, 6, m, 6), dtype=dt, device=dev)
        for a, Ja, b, Jb in ((ei, Ji, ei, Ji), (ej, Jj, ej, Jj),
                             (ei, Ji, ej, Jj), (ej, Jj, ei, Ji)):
            H.index_put_((a[:, None, None], r6, b[:, None, None], c6),
                         wi * torch.einsum("eki,ekj->eij", Ja, Jb),
                         accumulate=True)
        b = torch.zeros((m, 6), dtype=dt, device=dev)
        b.index_put_((ei[:, None], ar6[None]),
                     -w[:, None] * torch.einsum("eki,ek->ei", Ji, r),
                     accumulate=True)
        b.index_put_((ej[:, None], ar6[None]),
                     -w[:, None] * torch.einsum("eki,ek->ei", Jj, r),
                     accumulate=True)

        Hm = torch.where(pin, eye, H.reshape(m * 6, m * 6) + lam * eye)
        rhs = torch.where(fixed, torch.zeros_like(fixed, dtype=dt),
                          b.reshape(m * 6))
        d, info = torch.linalg.solve_ex(Hm, rhs)
        d = torch.where(info != 0, torch.full_like(d, float("nan")), d)

        poses = se3_exp(d.reshape(m, 6)) @ graph.poses
        poses = torch.where(graph.fixed[:, None, None], graph.poses, poses)
        r2 = pose_graph_residuals(graph._replace(poses=poses))
        new_cost = (w * (r2 * r2).sum(-1)).sum()
        accept = new_cost < cost
        graph = graph._replace(poses=torch.where(accept, poses,
                                                 graph.poses))
        lam = torch.where(accept, (lam * 0.3).clamp(min=1e-8),
                          (lam * 4.0).clamp(max=1e4))
        costs.append(new_cost)
    if not costs:
        return graph, torch.zeros((0,), dtype=dt, device=dev)
    return graph, torch.stack(costs)
