"""Kernel K9 (``kernels/csrc/ba_generic.cu``): a whole Levenberg-Marquardt
solve of ``ba_solve_tracks`` on the generic tracks layout, where
``obs_pose[n, k]`` names any pose, in one cooperative launch.

``ba.ba_solve_tracks`` calls ``lm_generic`` on CUDA tensors with
``ring_layout=False`` (and for one ring problem of more poses than K6
takes); its plain version is ``ba._lm_tracks(kernel=False)`` (with
``_tracks_assemble``'s generic branch, ``_tracks_solve_poses``,
``apply_pose_step``, ``_tracks_backsub`` and ``_tracks_cost``). The launch
builds an index once (the slots sorted by pose, the list of non-empty 6x6
blocks of S and S's block half-bandwidth), then runs every iteration
between grid barriers: the landmark blocks; S, rhs and the cost, a warp a
non-empty block; the damped, gauge-fixed, Jacobi-scaled pose solve as the
kernel's own band LU with partial pivoting (``linalg="lu"``) or band
Cholesky (``"chol"``), no library call at any width; the pose step,
back-substitution and candidate cost; and the accept test with the damping
update. Every sum runs in a fixed order, so two calls on the same inputs
give the same bits; nothing reads the host. The landmark blocks are
float64, as in the plain version (see ``slam/ba.py`` on precision).

Sizes. One problem (no stream dimension; ``ValueError`` otherwise), any
number of poses, slots a landmark and landmarks: the slot count bounds only
loops, and every offset that grows with M or N K is 64-bit. What grows
with M is staged in a CTA's shared memory where it fits and read in the
workspace where it does not (``k9_routes``, the same rule as the kernel's
``routes_of``; the launch reports the routes it took in
``GenericTrace.routes``): the index's per-warp counts, the landmark stage's
poses, the step's dp and candidate poses, and the pose solve (CTA 0 with
the band in shared memory, else the grid with the band in the workspace
and each panel in shared memory, else that panel in the workspace too).
The workspace holds S's blocks and the band as (6M)² float32 each: past
~M 16000 on an 80 GB card its allocation is what fails (PyTorch's
out-of-memory error). A ring of S streams with more poses than K6 takes
(``slam_run_streams`` with ``ring > 16``) is S calls, one launch a stream
in stream order (``ba._lm_tracks``).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..kernels import LAUNCHES, require_cuda, stream_handle
from ..utils.profiler import profiling
from .ba import BATracks

_WARPS = 8          # ba_generic.cu kWarps
_HEAD = 128         # ba_generic.cu kHead: the reduction slots before a stage's
SMEM_H100 = 232448  # K9's dynamic shared memory a CTA on the H100
STAGE_RECORDS = 4096  # the launches whose stage stamps are kept
# (iters, stamps) of the latest launches made while a torch.profiler
# session recorded (``k9_stage_records``)
_STAGES: "collections.deque[Tuple[int, torch.Tensor]]" = collections.deque(
    maxlen=STAGE_RECORDS)


def k9_routes(m: int, beta: int, linalg: str, smem: int = SMEM_H100,
              warps: int = _WARPS) -> Dict[str, str]:
    """The routes K9 takes at ``m`` poses and S's block half-bandwidth
    ``beta`` with ``smem`` bytes of dynamic shared memory a CTA
    (``ba_generic.cu:routes_of``): "shared" where a stage stages what grows
    with M in shared memory, "device" where it reads the workspace; the
    pose solve "cta" (CTA 0, the band in shared memory), "grid" (the grid,
    the band in the workspace, each panel in shared memory) or
    "grid_device" (the panel in the workspace too). ``warps``: a CTA's
    warps (the kernel's 8; a test build may take fewer)."""
    budget = smem - _HEAD
    n = 6 * m
    kl = min(6 * beta + 5, n - 1)
    up = min(2 * kl, n - 1) if linalg == "lu" else 0
    ld = n if up + kl + 1 >= n else up + kl + 1
    head = -(-4 * (2 * n + 120 + 6 * min(n, 6 + kl) + 6 * (up + 1) + n)
             // 16) * 16
    side = {True: "shared", False: "device"}
    return dict(
        index=side[4 * ((warps + 1) * m + 1) <= budget],
        landmarks=side[64 * m <= budget], step=side[88 * m <= budget],
        solve="cta" if head + 4 * n * ld <= budget
        else "grid" if 128 + 24 * min(n, 6 + kl) <= budget
        else "grid_device")


def routes_of_trace(tr: "GenericTrace") -> Dict[str, str]:
    """``k9_routes``'s names of the routes a launch reports."""
    code = [int(v) for v in tr.routes.tolist()]
    side = {1: "shared", 0: "device"}
    return dict(index=side[code[0]], landmarks=side[code[1]],
                step=side[code[2]],
                solve={2: "cta", 1: "grid", 0: "grid_device"}[code[3]])


def smem_bytes() -> int:
    """K9's dynamic shared memory a CTA on the current card."""
    from ..kernels import _build
    out = ctypes.c_int(0)
    _build.check(_build.load().vpp_ba_generic_smem(ctypes.byref(out)),
                 "ba_generic shared memory")
    return out.value


class GenericTrace(NamedTuple):
    """What K9 records besides its result: K6's ``LMTrace`` fields (the
    first iteration's reduced system before damping, only where traced,
    and per iteration the pose step, the damping used, the costs of the
    iterate and of the candidate, and the decision), plus the first
    iteration's Jacobi scales and the solution of its scaled system (dp =
    scale x), S's block half-bandwidth and the routes the launch took
    (``routes_of_trace``)."""
    S: Optional[torch.Tensor]  # (M, 6, M, 6) float32, or None
    rhs: torch.Tensor        # (M, 6)
    cost: torch.Tensor       # ()
    dp: torch.Tensor         # (iters, M, 6); NaN where the solve failed
    lam: torch.Tensor        # (iters,)
    cost_before: torch.Tensor  # (iters,)
    cost_after: torch.Tensor   # (iters,) the candidate's cost
    accept: torch.Tensor     # (iters,) 1.0 where accepted, else 0.0
    scale: torch.Tensor      # (6M,) the first iteration's d
    x: torch.Tensor          # (6M,) the first iteration's x
    band: torch.Tensor       # () beta, as a float
    routes: torch.Tensor     # (4,) the index's, landmarks', step's, solve's


def _operands(p: BATracks):
    if p.landmarks.dim() != 2:
        raise ValueError("K9: takes one problem, not streams")
    n, k = p.obs_valid.shape
    m = p.poses.shape[0]
    if m < 1 or k < 1 or n < 1:
        raise ValueError(f"K9: takes at least one pose, slot and landmark, "
                         f"got M={m}, K={k}, N={n}")
    if tuple(p.poses.shape) != (m, 4, 4) or tuple(p.landmarks.shape) != (
            n, 3) or tuple(p.obs_pose.shape) != (n, k) or tuple(
            p.obs_uv.shape) != (n, k, 2) or tuple(
            p.fixed_poses.shape) != (m,) or tuple(
            p.intrinsics.shape) != (4,):
        raise ValueError("K9: poses (M,4,4), landmarks (N,3), obs_pose "
                         "(N,K), obs_uv (N,K,2), obs_valid (N,K), "
                         "fixed_poses (M,) and intrinsics (4,) expected")
    ops = (p.poses.contiguous(), p.landmarks.contiguous(),
           p.obs_pose.contiguous(), p.obs_uv.contiguous(),
           p.obs_valid.contiguous(), p.intrinsics.contiguous(),
           p.fixed_poses.contiguous())
    require_cuda("ba_generic", *ops, dtypes=(
        torch.float32, torch.float32, torch.int32, torch.float32,
        torch.bool, torch.float32, torch.bool))
    return ops, n, k, m


def lm_generic(p: BATracks, iters: int, huber: float, lam0: float,
               linalg: str, trace: bool = False,
               stamps: Optional[torch.Tensor] = None,
               smem: Optional[int] = None):
    """K9: ``iters`` LM iterations of one generic-layout problem in one
    launch. Returns (poses (M,4,4), landmarks (N,3), costs (iters,),
    ``GenericTrace``), the trace's ``S`` written only with ``trace``. Where
    given, ``stamps`` (int64, 8 iters + 3, on the problem's device)
    receives the device clock (ns) at the start, after the index, after
    each iteration's landmark, block, solve and step stages and at the end
    (4 iters + 3), then per iteration the SM cycles of the pose solve's
    system, panel factorisations, trailing updates and back-substitution
    (4 iters). ``iters`` is at least 1: ``ba_solve_tracks(iters=0)``
    returns before it. ``smem`` below the card's (``smem_bytes``) chooses
    the stages' routes (``k9_routes``) for that many bytes instead: the
    same bits on the device-memory routes at small sizes.

    While a ``torch.profiler`` session records and no ``stamps`` is
    given, the launch writes its stamps into a tensor of its own, kept in
    the stage records (``k9_stage_records``) with no read back and no
    wait."""
    from ..kernels import _build
    if iters < 1:
        raise ValueError(f"K9: takes at least one iteration, got {iters}")
    if linalg not in ("lu", "chol"):
        raise ValueError(f"K9: unknown linalg {linalg!r}")
    (poses, lms, opose, uv, valid, intr, fixed), n, k, m = _operands(p)
    dev = lms.device
    lib = _build.load()
    nbytes = ctypes.c_longlong(0)
    limit = 0 if smem is None else int(smem)
    _build.check(lib.vpp_ba_generic_workspace(n, k, m, iters, limit,
                                              ctypes.byref(nbytes)),
                 "ba_generic workspace")
    D = 6 * m
    f32 = torch.float32
    ws = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
    poses_out = torch.empty((m, 4, 4), dtype=f32, device=dev)
    lms_out = torch.empty((n, 3), dtype=f32, device=dev)
    costs = torch.empty(iters, dtype=f32, device=dev)
    per = torch.empty((iters, D + 4), dtype=f32, device=dev)
    # rhs, x, d, cost, beta, the routes
    extra = torch.empty(3 * D + 6, dtype=f32, device=dev)
    S = torch.zeros((D, D), dtype=f32, device=dev) if trace else None
    record = stamps is None and profiling()
    if record:
        stamps = torch.empty(8 * iters + 3, dtype=torch.int64, device=dev)
    elif stamps is not None and (
            stamps.dtype != torch.int64 or stamps.numel() != 8 * iters + 3
            or stamps.device != dev or not stamps.is_contiguous()):
        raise ValueError(f"K9: stamps takes a contiguous int64 tensor of "
                         f"{8 * iters + 3} on {dev}")
    code = lib.vpp_ba_generic_lm(
        poses.data_ptr(), lms.data_ptr(), opose.data_ptr(), uv.data_ptr(),
        valid.data_ptr(), intr.data_ptr(), fixed.data_ptr(), n, k, m, iters,
        1 if linalg == "lu" else 0, limit, float(huber), float(lam0),
        poses_out.data_ptr(), lms_out.data_ptr(), costs.data_ptr(),
        per.data_ptr(), S.data_ptr() if trace else None, extra.data_ptr(),
        extra[3 * D + 2:].data_ptr(),
        None if stamps is None else stamps.data_ptr(), ws.data_ptr(),
        stream_handle(lms))
    LAUNCHES["ba_generic"] += 1
    _build.check(code, "ba_generic")
    if record:
        _STAGES.append((iters, stamps))
    tr = GenericTrace(S=S.view(m, 6, m, 6) if trace else None,
                      rhs=extra[:D].view(m, 6), cost=extra[3 * D],
                      dp=per[:, :D].view(iters, m, 6), lam=per[:, D],
                      cost_before=per[:, D + 1], cost_after=per[:, D + 2],
                      accept=per[:, D + 3], scale=extra[2 * D:3 * D],
                      x=extra[D:2 * D], band=extra[3 * D + 1],
                      routes=extra[3 * D + 2:])
    return poses_out, lms_out, costs, tr


SOLVE_PARTS = ("solve_system", "solve_panels", "solve_trailing",
               "solve_backsub")


def k9_stage_ms(stamps: torch.Tensor, iters: int) -> Dict[str, float]:
    """K9's device ms by stage from one launch's ``stamps``
    (``lm_generic``'s layout, ``iters`` iterations): ``index``; then
    ``landmarks``, ``blocks``, ``solve`` and ``step``, each summed over the
    iterations (``step`` with the last decision, which runs after the last
    iteration's stamp); ``span``, the launch's first stamp to its last,
    which those five add up to; and the solve split into its system,
    panels, trailing updates and back-substitution (``SOLVE_PARTS``) by
    the shares of CTA 0's SM cycles in each iteration."""
    st = stamps.detach().cpu()
    if st.dtype != torch.int64 or st.numel() != 8 * iters + 3:
        raise ValueError(f"k9_stage_ms: takes {8 * iters + 3} int64 "
                         f"stamps for {iters} iterations")
    ns = st[:4 * iters + 3]
    d = (ns[1:] - ns[:-1]).double() / 1e6
    per = d[1:1 + 4 * iters].view(iters, 4)
    cyc = st[4 * iters + 3:].double().view(iters, 4)
    split = per[:, 2:3] * cyc / cyc.sum(1, keepdim=True).clamp(min=1)
    land, blocks, solve, step = per.sum(0).tolist()
    out = dict(index=float(d[0]), landmarks=land, blocks=blocks,
               solve=solve, step=step + float(d[-1]),
               span=float(ns[-1] - ns[0]) / 1e6)
    out.update(zip(SOLVE_PARTS, split.sum(0).tolist()))
    return out


def k9_stage_records() -> List[Tuple[int, torch.Tensor]]:
    """(iters, stamps) of each K9 launch that ``lm_generic`` made while a
    ``torch.profiler`` session recorded, oldest first: the latest
    ``STAGE_RECORDS``, the stamps on the host (``k9_stage_ms`` decodes
    them). The records stay; a read waits for the card and copies the
    stamps that are still on it to the host in one transfer, so a second
    read copies nothing."""
    pending: Dict[torch.device, List[int]] = {}
    for i, (_, st) in enumerate(_STAGES):
        if st.device.type == "cuda":
            pending.setdefault(st.device, []).append(i)
    for dev, idx in pending.items():
        torch.cuda.synchronize(dev)
        parts = [_STAGES[i][1] for i in idx]
        host = torch.cat(parts).cpu().split([t.numel() for t in parts])
        for i, t in zip(idx, host):
            _STAGES[i] = (_STAGES[i][0], t)
    return list(_STAGES)


def reset_k9_stage_records() -> None:
    """Forget every stage record."""
    _STAGES.clear()
