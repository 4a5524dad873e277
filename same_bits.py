#!/usr/bin/env python3
"""Save, or compare, the kernels' outputs on today's routes at the main
paths' sizes, so that two checkouts can be held bit for bit on one card.

    python3 same_bits.py save OUT.npz        # in each checkout's root
    python3 same_bits.py compare A.npz B.npz

``save`` builds this checkout's kernels and runs, on seeded inputs made on
the card: K9 (``ba_generic_cuda.lm_generic``, trace on) at N 10240 x M 128
x K 4 and on a closure over 512 poses, LU and Cholesky, 5 iterations (the
JAX scale test's recipe, as ``chip_smoke.py`` phase 10 makes it); K8
(``map_vote.map_vote_pnp``) at A 1024 x Q 512 x B 2 and Q 4096 and 16384;
K1 (``flow.flow_level``) on the tracker's three 640x480 levels at 2
passes; K4 (``pyramid.pyramid``) on a 640x480 frame, 3 levels. It writes
every output tensor as raw bits. ``compare`` prints, for each saved name,
whether the two files hold the same bits, and exits non-zero if any
differs or either file lacks a name. Needs one CUDA card.
"""

from __future__ import annotations

import importlib
import sys

import numpy as np


def _bits(t) -> np.ndarray:
    """A tensor's bits as numpy: floats as the integers of their width."""
    import torch
    a = t.detach().cpu().contiguous()
    if a.dtype.is_floating_point:
        a = a.view({2: torch.int16, 4: torch.int32,
                    8: torch.int64}[a.element_size()])
    return a.numpy().copy()


def save(path: str) -> None:
    import torch
    sys.path.insert(0, ".")
    cs = importlib.import_module("chip_smoke")
    from vpp_tpu_torch.kernels import _build
    _build.build()
    _build.load()
    BA = importlib.import_module("vpp_tpu_torch.slam.ba")
    BG = importlib.import_module("vpp_tpu_torch.slam.ba_generic_cuda")
    MV = importlib.import_module("vpp_tpu_torch.slam.map_vote")
    FL = importlib.import_module("vpp_tpu_torch.algorithms.flow")
    PY = importlib.import_module("vpp_tpu_torch.algorithms.pyramid")
    from vpp_tpu_torch.core.image import Image2d, from_array
    from vpp_tpu_torch.utils.clips import make_clip
    dev = torch.device("cuda")
    out = {}
    for name, (n, m, case) in {"m128": (10240, 128, "plain"),
                               "closure512": (4096, 512, "closure")}.items():
        p, _ = cs.generic_problem(torch, np, BA, dev, n, m, 4, 5, case,
                                  noise=0.3)
        for linalg in ("lu", "chol"):
            po, lm, co, tr = BG.lm_generic(p, 5, 4.0, 1e-4, linalg,
                                           trace=True)
            fields = dict(poses=po, landmarks=lm, costs=co, S=tr.S,
                          rhs=tr.rhs, dp=tr.dp, x=tr.x, scale=tr.scale)
            for f, t in fields.items():
                out[f"k9_{name}_{linalg}_{f}"] = _bits(t)
    for q in (512, 4096, 16384):
        ops = cs.pnp_inputs(torch, np, dev, 1024, q, 2, "random", q)
        res = MV.map_vote_pnp(*ops, **cs.K8_KW)
        for f, t in res._asdict().items():
            out[f"k8_q{q}_{f}"] = _bits(t)
    clip = make_clip(640, 480, 3, seed=0)
    frames = [from_array(torch.from_numpy(clip[i]).to(dev), border=9,
                         border_mode="mirror") for i in (0, 2)]
    p1, p2 = (PY.pyramid(f, 3, border=9) for f in frames)
    for s in range(3):
        h, w = p1[s].shape
        g = FL.LevelGeometry(b=9, h=h, w=w, ws=9, patch=10,
                             gh=h // 10, gw=w // 10, R=5 if s == 2 else 1,
                             pred_bound=0 if s == 2 else 2 * 2 ** (2 - s))
        pred = torch.zeros((g.gh, g.gw, 2), dtype=torch.int32, device=dev)
        fk, dk = FL.flow_level(p1[s].data, p2[s].data, pred, g, 2)
        out[f"k1_level{s}_flow"] = _bits(fk)
        out[f"k1_level{s}_dist"] = _bits(dk)
    raw = torch.from_numpy(clip[1].astype(np.float32)).to(dev)
    for i, lvl in enumerate(PY.pyramid(Image2d(data=raw, border=0), 3,
                                       border=9).levels):
        out[f"k4_level{i}"] = _bits(lvl.data)
    torch.cuda.synchronize()
    np.savez(path, **out)
    print(f"saved {len(out)} outputs to {path}")


def compare(a: str, b: str) -> int:
    x, y = np.load(a), np.load(b)
    bad = 0
    for name in sorted(set(x.files) | set(y.files)):
        same = (name in x.files and name in y.files
                and x[name].shape == y[name].shape
                and np.array_equal(x[name], y[name]))
        bad += not same
        print(f"{name}: {'same bits' if same else 'DIFFERS'}")
    print(f"{len(set(x.files) | set(y.files)) - bad} of "
          f"{len(set(x.files) | set(y.files))} outputs the same bits")
    return 1 if bad else 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "save":
        save(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    sys.exit(__doc__)
