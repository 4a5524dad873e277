"""Kernel K6 (``kernels/csrc/ba_tracks.cu``): window-BA assembly,
reduction and back-substitution with the candidate's cost, ring layout.

``ba.ba_solve_tracks`` calls these on CUDA tensors with
``ring_layout=True``; their plain versions are ``ba._tracks_assemble``,
``ba._tracks_backsub`` and ``ba._tracks_cost``. Each LM iteration makes
four launches: ``tracks_assemble`` (launch A, then launch B over its
per-block partials) and ``tracks_backsub_cost`` (launch C, then launch B
over its per-block costs). Every sum is taken in a fixed order, so two
calls on the same inputs give the same bits. M is at most ``MAX_POSES``.
The landmark-local arrays (Hll_inv, bl, U) are float64, as in the plain
versions (see ``slam/ba.py`` on precision).
"""

from __future__ import annotations

import torch

from ..kernels import LAUNCHES, require_cuda, stream_handle
from .ba import BATracks

MAX_POSES = 16
LANDMARKS_PER_BLOCK = 16     # launch A's tile: 37 KB of shared memory at
#                              M = 6, 97 KB at M = 16

def _operands(p: BATracks):
    n, k = p.obs_valid.shape
    m = p.poses.shape[0]
    if k != m:
        raise ValueError(f"K6: ring layout needs K == M, got K={k}, M={m}")
    if not 1 <= m <= MAX_POSES:
        raise ValueError(f"K6: takes 1 to {MAX_POSES} poses, got {m}")
    if tuple(p.obs_uv.shape) != (n, m, 2) or tuple(p.landmarks.shape) != (
            n, 3) or tuple(p.poses.shape[1:]) != (4, 4):
        raise ValueError("K6: poses (M,4,4), landmarks (N,3), obs_uv "
                         "(N,M,2), obs_valid (N,M) expected")
    ops = (p.poses.contiguous(), p.landmarks.contiguous(),
           p.obs_uv.contiguous(), p.obs_valid.contiguous(),
           p.intrinsics.contiguous())
    require_cuda("ba_tracks", *ops, dtypes=(torch.float32,) * 3
                 + (torch.bool, torch.float32))
    return ops, n, m


def _reduce(lib, partials: torch.Tensor, p: int) -> torch.Tensor:
    from ..kernels import _build
    out = torch.empty((p,), dtype=torch.float32, device=partials.device)
    code = lib.vpp_ba_reduce(partials.data_ptr(), partials.shape[0], p,
                             out.data_ptr(), stream_handle(partials))
    LAUNCHES["ba_tracks"] += 1
    _build.check(code, "ba_reduce")
    return out


def tracks_assemble(p: BATracks, lam: torch.Tensor, huber: float,
                    linalg: str):
    """K6 launches A and B: ((S (M,6,M,6), rhs (M,6), cost ()),
    (Hll_inv (N,3,3), bl (N,3), U (N,M,6,3), None, seen (N,)))."""
    from ..kernels import _build
    (poses, lms, uv, valid, intr), n, m = _operands(p)
    lam = lam.reshape(1).to(torch.float32).contiguous()
    require_cuda("ba_tracks", lam, dtypes=(torch.float32,))
    dev = lms.device
    lib = _build.load()
    L = LANDMARKS_PER_BLOCK
    blocks = -(-n // L)
    P = m * m * 36 + m * 6 + 1
    f64 = torch.float64
    hinv = torch.empty((n, 3, 3), dtype=f64, device=dev)
    bl = torch.empty((n, 3), dtype=f64, device=dev)
    U = torch.empty((n, m, 6, 3), dtype=f64, device=dev)
    seen = torch.empty((n,), dtype=torch.bool, device=dev)
    partials = torch.empty((blocks, P), dtype=f64, device=dev)
    code = lib.vpp_ba_assemble(
        poses.data_ptr(), lms.data_ptr(), uv.data_ptr(), valid.data_ptr(),
        intr.data_ptr(), lam.data_ptr(), float(huber), n, m, L,
        1 if linalg == "lu" else 0, hinv.data_ptr(), bl.data_ptr(),
        U.data_ptr(), seen.data_ptr(), partials.data_ptr(),
        stream_handle(lms))
    LAUNCHES["ba_tracks"] += 1
    _build.check(code, "ba_assemble")
    out = _reduce(lib, partials, P)
    S = out[:m * m * 36].view(m, 6, m, 6)
    rhs = out[m * m * 36:m * m * 36 + m * 6].view(m, 6)
    return (S, rhs, out[-1]), (hinv, bl, U, None, seen)


def tracks_backsub_cost(p: BATracks, local, dp: torch.Tensor,
                        cand_poses: torch.Tensor, huber: float):
    """K6 launches C and B: (candidate landmarks (N,3), their Huber cost
    under ``cand_poses`` ())."""
    from ..kernels import _build
    (_, lms, uv, valid, intr), n, m = _operands(p)
    hinv, bl, U, _, seen = (None if t is None else t.contiguous()
                            for t in local)
    dp = dp.to(torch.float32).contiguous()
    cand_poses = cand_poses.contiguous()
    require_cuda("ba_tracks", dp, cand_poses, hinv, bl, U, seen,
                 dtypes=(torch.float32,) * 2 + (torch.float64,) * 3
                 + (torch.bool,))
    lib = _build.load()
    dev = lms.device
    blocks = -(-n // lib.vpp_ba_backsub_threads())
    cand = torch.empty((n, 3), dtype=torch.float32, device=dev)
    partials = torch.empty((blocks, 1), dtype=torch.float64, device=dev)
    code = lib.vpp_ba_backsub_cost(
        cand_poses.data_ptr(), lms.data_ptr(), uv.data_ptr(),
        valid.data_ptr(), intr.data_ptr(), float(huber), hinv.data_ptr(),
        bl.data_ptr(), U.data_ptr(), seen.data_ptr(), dp.data_ptr(), n, m,
        cand.data_ptr(), partials.data_ptr(), stream_handle(lms))
    LAUNCHES["ba_tracks"] += 1
    _build.check(code, "ba_backsub_cost")
    return cand, _reduce(lib, partials, 1)[0]
