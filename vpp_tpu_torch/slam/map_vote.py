"""One round of the map vote (kernel K8): the translation-consensus vote of
``_map_vote_pnp`` (``vpp_tpu/slam/pipeline.py:369-409``, ``vote_round``),
starting after the projection.

Each of A map entries, projected to ``pred`` (A, 2) at camera depth ``z``
(A,), takes its C = 4 nearest valid detections among Q (repeated argmin and
mask over the (A, Q) squared distances, lowest index first on ties, a NaN
distance first as ``torch.argmin`` and ``jnp.argmin`` take it; a row with
fewer valid detections repeats an index at ``_HUGE``). Each pair within
``r_wide`` of a usable (``base``) entry in front of the camera votes for
the camera-translation correction ``((cand - pred) * z) / f`` in an
``NB`` x ``NB`` histogram over +-``bmax`` (JAX's 33 bins a side); the 3x3-smoothed histogram's first
peak is the round's shift (0 when no pair votes), and ``dd`` is each pair's
squared distance to it (``_HUGE`` for pairs that did not vote).

``vote_round`` on CUDA tensors is K8 (``kernels/csrc/map_vote.cu``): one
launch a round, bit-equal to ``_vote_round_plain``, the JAX body written
out in PyTorch, which a CPU tensor takes.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .._device import device_constant
from ..kernels import LAUNCHES, require_cuda, stream_handle

_HUGE = 1e30
C = 4                 # candidates per map entry
NB = 33               # histogram bins a side (the kernel's kNb)


def vote_step(bmax: float) -> float:
    """The histogram's bin width over +-``bmax``, a Python float as JAX's
    ``step``."""
    return 2.0 * bmax / (NB - 1)


def _vote_steps(bmax: float) -> Tuple[float, float]:
    """(bmax, step) as the float32 values both frameworks compute with:
    the Python floats rounded once (JAX's weak typing)."""
    return (float(torch.tensor(bmax, dtype=torch.float32)),
            float(torch.tensor(vote_step(bmax), dtype=torch.float32)))


def _vote_round_plain(pred: torch.Tensor, z: torch.Tensor,
                      posf: torch.Tensor, valid: torch.Tensor,
                      base: torch.Tensor, intr: torch.Tensor, r_wide: float,
                      bmax: float):
    """Plain version of K8. Returns (txy (2,), js (A, C) int32, ds (A, C),
    cand_uv (A, C, 2), dd (A, C)); ``txy`` = (tx0, ty0) on the device.
    Every division is by a device tensor, so the card divides exactly (a
    Python-float divisor would be a multiplication by its reciprocal)."""
    dev = pred.device
    a_n = pred.shape[0]
    nb = NB
    bmax_f, step_f = _vote_steps(bmax)
    step_t = device_constant((step_f,), torch.float32, dev)
    fx, fy = intr[0], intr[1]
    dr = pred[:, None, 0] - posf[None, :, 0]
    dc = pred[:, None, 1] - posf[None, :, 1]
    d2 = dr * dr + dc * dc
    huge = torch.full_like(d2, _HUGE)
    d2c = torch.where(valid[None], d2, huge)
    js, dss = [], []
    for _ in range(C):
        j = torch.argmin(d2c, dim=1, keepdim=True)
        dss.append(d2c.gather(1, j))
        js.append(j)
        d2c = d2c.scatter(1, j, huge[:, :1])
    js = torch.cat(js, dim=1)
    ds = torch.cat(dss, dim=1)
    cand_uv = posf[js]                                       # (A, C, 2)
    txc = (cand_uv[..., 1] - pred[:, None, 1]) * z[:, None] / fx
    tyc = (cand_uv[..., 0] - pred[:, None, 0]) * z[:, None] / fy
    m = base[:, None] & (ds <= r_wide ** 2) & (z[:, None] > 0.1)
    bx = torch.round((txc + bmax_f) / step_t).to(torch.int32)
    by = torch.round((tyc + bmax_f) / step_t).to(torch.int32)
    bx, by = bx.clamp(0, nb - 1), by.clamp(0, nb - 1)
    nbin = nb * nb
    idx = torch.where(m, by * nb + bx, torch.full_like(bx, nbin))
    votes = torch.zeros((nbin + 1,), dtype=torch.float32, device=dev)
    votes.index_put_((idx.reshape(-1).long(),),
                     torch.ones((a_n * C,), dtype=torch.float32, device=dev),
                     accumulate=True)
    vp = torch.nn.functional.pad(votes[:nbin].view(nb, nb), (1, 1, 1, 1))
    sm = sum(vp[i:i + nb, k:k + nb] for i in range(3) for k in range(3))
    flat = sm.reshape(-1)
    pk = torch.argmax(flat, keepdim=True)
    any_votes = flat.gather(0, pk) > 0
    pxy = torch.cat([pk % nb, pk // nb]).to(torch.float32)
    txy = torch.where(any_votes, pxy * step_f - bmax_f,
                      torch.zeros_like(pxy))
    ex, ey = txc - txy[0], tyc - txy[1]
    dd = torch.where(m, ex * ex + ey * ey, torch.full_like(ex, _HUGE))
    return txy, js.to(torch.int32), ds, cand_uv, dd


_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _counter(dev: torch.device) -> torch.Tensor:
    """K8's arrival counter on ``dev``: one int32, zeroed once; every
    launch's last CTA resets it, so launches on one stream need no memset."""
    buf = _COUNTERS.get(dev)
    if buf is None:
        buf = torch.zeros((1,), dtype=torch.int32, device=dev)
        _COUNTERS[dev] = buf
    return buf


def _outputs(a_n: int, dev: torch.device):
    """K8's outputs (txy, js, ds, cand_uv, dd) as views of one allocation
    (one ``torch.empty``: its host cost is most of a small kernel's)."""
    ac = a_n * C
    out = torch.empty((2 + 5 * ac,), dtype=torch.float32, device=dev)
    return (out[:2], out[2 + 4 * ac:].view(torch.int32).view(a_n, C),
            out[2:2 + ac].view(a_n, C), out[2 + 2 * ac:2 + 4 * ac].view(
                a_n, C, 2), out[2 + ac:2 + 2 * ac].view(a_n, C))


def vote_round(pred: torch.Tensor, z: torch.Tensor, posf: torch.Tensor,
               valid: torch.Tensor, base: torch.Tensor, intr: torch.Tensor,
               r_wide: float, bmax: float):
    """K8: one map-vote round, one launch on CUDA tensors; the plain
    version on CPU tensors. Returns (txy, js, ds, cand_uv, dd) as
    ``_vote_round_plain``. Needs A >= 1 entries and Q >= 1 detections."""
    a_n, q_n = pred.shape[0], posf.shape[0]
    if (pred.shape != (a_n, 2) or z.shape != (a_n,)
            or posf.shape != (q_n, 2) or valid.shape != (q_n,)
            or base.shape != (a_n,) or a_n < 1 or q_n < 1
            or intr.shape != (4,)):
        raise ValueError(
            f"vote_round: needs pred (A, 2), z (A,), base (A,), posf (Q, 2) "
            f"and valid (Q,) with A, Q >= 1, and intr (4,); got "
            f"{tuple(pred.shape)}, {tuple(z.shape)}, {tuple(base.shape)}, "
            f"{tuple(posf.shape)}, {tuple(valid.shape)}, "
            f"{tuple(intr.shape)}")
    if pred.device.type == "cpu":
        return _vote_round_plain(pred, z, posf, valid, base, intr, r_wide,
                                 bmax)
    f32 = torch.float32
    pred, z, posf = (t.to(f32).contiguous() for t in (pred, z, posf))
    valid, base = valid.contiguous(), base.contiguous()
    intr = intr.to(f32).contiguous()
    require_cuda("vote_round", pred, z, posf, valid, base, intr,
                 dtypes=(f32, f32, f32, torch.bool, torch.bool, f32))
    from ..kernels import _build
    dev = pred.device
    bmax_f, step_f = _vote_steps(bmax)
    txy, js, ds, cand_uv, dd = _outputs(a_n, dev)
    code = _build.load().vpp_map_vote(
        pred.data_ptr(), z.data_ptr(), posf.data_ptr(), valid.data_ptr(),
        base.data_ptr(), intr.data_ptr(), a_n, q_n, float(r_wide) ** 2,
        bmax_f, step_f, js.data_ptr(), ds.data_ptr(),
        cand_uv.data_ptr(), dd.data_ptr(), txy.data_ptr(),
        _counter(dev).data_ptr(), stream_handle(pred))
    LAUNCHES["map_vote"] += 1
    _build.check(code, "map_vote")
    return txy, js, ds, cand_uv, dd
