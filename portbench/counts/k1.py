"""The least work of kernel K1 (the semi-dense flow level, two launches a
level), from the level shapes the tracker's flow asks for: a frozen copy
of ``chip_smoke.py``'s ``k1_level_work`` and of the level geometry of
``algorithms/flow.py:semi_dense_streams``.

Per level: both frames' level buffers read once (float32) and the per-cell
prediction, flow and distance written once; operations: for every
displacement of the (2R + 1)^2 window, the |difference| and its sum over
the rows of the level's window span, the column sums over the windows, and
the argmin over the displacements, then each propagation pass's 8
neighbours a cell (12 operations each).
"""

from __future__ import annotations

from typing import List, Tuple


def level_shapes(shape: Tuple[int, int], nlevels: int):
    out = [tuple(shape)]
    for _ in range(nlevels - 1):
        h, w = out[-1]
        out.append((1 + int(h / 2.0), 1 + int(w / 2.0)))
    return out


def tracker_levels(h: int, w: int, nscales: int, patch: int, ws: int,
                   search_niters: int = 5, refine: int = 1) -> List[dict]:
    """The level geometry of the tracker's flow (coarsest last): per level
    its interior (h, w), its cell grid (gh, gw) and search radius R."""
    shapes = level_shapes((h, w), nscales)
    grids = level_shapes((max(h // patch, 1), max(w // patch, 1)), nscales)
    r_top = max(1, search_niters)
    radii = [max(1, min(refine, r_top)) if s < nscales - 1 else r_top
             for s in range(nscales)]
    return [dict(h=sh[0], w=sh[1], gh=g[0], gw=g[1], R=r, ws=ws,
                 patch=patch) for sh, g, r in zip(shapes, grids, radii)]


def level_work(lv: dict, border: int, props: int,
               streams: int) -> Tuple[float, float]:
    """(bytes, operations) of one level for ``streams`` streams."""
    d2 = (2 * lv["R"] + 1) ** 2
    gh, gw, ws, patch = lv["gh"], lv["gw"], lv["ws"], lv["patch"]
    lr = (gh - 1) * patch + ws
    lc = (gw - 1) * patch + ws
    level_px = (lv["h"] + 2 * border) * (lv["w"] + 2 * border)
    nbytes = level_px * 4 * 2 + gh * gw * (8 + 8 + 4)
    ops = (d2 * (lr * lc * 2 + gh * lc * (ws - 1) + gh * gw * (ws - 1))
           + gh * gw * (d2 - 1) + props * gh * gw * 8 * 12)
    return nbytes * streams, ops * streams
