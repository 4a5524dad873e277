"""Parity of vpp_tpu_torch's distance transforms (kernel K11's plain
version) with vpp_tpu's on the CPU.

Bit-equal: the chamfer doubling method (small integers in float32), and
the Euclidean transform's distances and displacement vectors (exact
float32 sums of squared int32 differences), pass by pass. The sweeps
method is bit-equal wherever JAX's value is below 1e9 (a seed reaches the
pixel); in a row no seed has reached yet both sides add multiples of w to
1e9 in their own order, so there the port is only held to >= 1e9.
Inputs: tests/test_geometry_matcher.py:134,144 and
tests/test_algorithms_basic.py:236.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jdt = importlib.import_module("vpp_tpu.algorithms.distance_transform")
tdt = importlib.import_module("vpp_tpu_torch.algorithms.distance_transform")

torch.set_num_threads(1)

METRICS = ["d4", "d8", "d3_4", "d5_7_11"]


def _mask(shape, p, seed, extra=None):
    rng = np.random.RandomState(seed)
    m = rng.rand(*shape) < p
    if extra is not None:
        m[extra] = True
    if not m.any():
        m[min(3, shape[0] - 1), min(5, shape[1] - 1)] = True
    return m


CHAMFER_CASES = [((20, 33), 0.05, 4, (7, 12)),    # test_geometry_matcher:134
                 ((37, 53), 0.01, 3, None),       # test_algorithms_basic:236
                 ((7, 90), 0.02, 3, None),        # thin: knight moves past it
                 ((64, 40), 0.002, 9, None)]      # sparse: unreached rows


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("case", CHAMFER_CASES)
def test_chamfer_doubling_bit_equal(metric, case):
    shape, p, seed, extra = case
    m = _mask(shape, p, seed, extra)
    j = np.asarray(jdt.chamfer_distance_transform(jnp.asarray(m), metric))
    t = tdt.chamfer_distance_transform(torch.from_numpy(m), metric)
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    np.testing.assert_array_equal(j, t.numpy())


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("case", CHAMFER_CASES)
def test_chamfer_sweeps(metric, case):
    shape, p, seed, extra = case
    m = _mask(shape, p, seed, extra)
    j = np.asarray(jdt.chamfer_distance_transform(jnp.asarray(m), metric,
                                                  method="sweeps"))
    t = tdt.chamfer_distance_transform(torch.from_numpy(m), metric,
                                       method="sweeps").numpy()
    reached = j < 1e9
    np.testing.assert_array_equal(t[reached], j[reached])
    assert (t[~reached] >= 1e9).all()
    # the reference's own recurrence gives the doubling method's result
    np.testing.assert_array_equal(
        t, tdt.chamfer_distance_transform(torch.from_numpy(m), metric)
        .numpy())


def test_named_instances_and_image_seeds():
    from vpp_tpu_torch.core.image import from_array
    m = _mask((20, 33), 0.05, 4)
    img = from_array(torch.from_numpy(m.astype(np.uint8)), border=2)
    for name in METRICS:
        want = jdt.chamfer_distance_transform(jnp.asarray(m), name)
        np.testing.assert_array_equal(
            np.asarray(want), getattr(tdt, name)(img).numpy())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdt.euclidean_distance_transform(m)      # numpy: the card by default
    d, _ = tdt.euclidean_distance_transform(m, device="cpu")
    assert d.device.type == "cpu"


@pytest.mark.parametrize("shape,p,seed,extra", [
    ((40, 40), 0.03, 5, (20, 20)),                # test_geometry_matcher:144
    ((37, 53), 0.01, 3, None),
    ((7, 90), 0.02, 3, None),
    ((96, 128), 0.001, 0, None),
    ((33, 17), 0.0, 1, None),                     # one seed
])
def test_euclidean_bit_equal(shape, p, seed, extra):
    m = _mask(shape, p, seed, extra)
    jd, jv = jdt.euclidean_distance_transform(jnp.asarray(m))
    td, tv = tdt.euclidean_distance_transform(torch.from_numpy(m))
    assert td.dtype == torch.float32 and tv.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    # the exact transform, and vectors that point at seeds
    seeds = np.argwhere(m)
    rr, cc = np.mgrid[0:shape[0], 0:shape[1]]
    brute = ((seeds[:, None, None, 0] - rr) ** 2
             + (seeds[:, None, None, 1] - cc) ** 2).min(0)
    if shape == (40, 40):
        np.testing.assert_array_equal(td.numpy().astype(np.int64), brute)
    tvn = tv.numpy()
    assert m[rr + tvn[..., 0], cc + tvn[..., 1]].all()


def test_euclidean_no_seed():
    m = np.zeros((9, 11), bool)
    jd, jv = jdt.euclidean_distance_transform(jnp.asarray(m))
    td, tv = tdt.euclidean_distance_transform(torch.from_numpy(m))
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def test_jfa_pass_plain_steps():
    """The pass schedule (N/2 ... 1, then 1) and each pass against the JAX
    loop's, on coordinates that hold no-seed entries."""
    assert tdt._steps(540, 960) == (512, 256, 128, 64, 32, 16, 8, 4, 2, 1,
                                    1)
    m = _mask((45, 60), 0.004, 7)
    h, w = m.shape
    rr, cc = np.mgrid[0:h, 0:w].astype(np.int32)
    br = np.where(m, rr, -(1 << 20)).astype(np.int32)
    bc = np.where(m, cc, -(1 << 20)).astype(np.int32)
    tr, tc = torch.from_numpy(br), torch.from_numpy(bc)
    for step in tdt._steps(h, w):
        tr, tc = tdt.jfa_pass(tr, tc, step)
    td, tv = tdt.euclidean_distance_transform(torch.from_numpy(m))
    np.testing.assert_array_equal(tv[..., 0].numpy(), (tr - torch.from_numpy(
        rr)).numpy())


# -- K11's decomposition, emulated -------------------------------------------

def _emulate_k11_pass(br, bc, s, plan):
    """numpy emulation of one K11 pass as ``kernels/csrc/jfa.cu`` cuts it:
    tiles of Lr row residues x Tr lattice rows by Lc column residues x Tc
    lattice columns, each with a halo of 3 lattice points a side clamped to
    the image; in each tile's region the 8 steps in the JAX order, a
    neighbour outside the region or the image no candidate (the image test
    on global coordinates), the state as float32 displacements (-inf for
    none, whose distance is 1e9); only the tile's points are written.
    Returns the planes and how often each pixel was written."""
    h, w = br.shape
    lg_lr, tr, lg_lc, tc = plan
    lr, lc = 1 << lg_lr, 1 << lg_lc
    out_r, out_c = br.copy(), bc.copy()
    writes = np.zeros((h, w), np.int64)
    f32 = np.float32

    def blocks(n, l, t):
        for r0 in range(0, min(s, n), l):
            e = -(-(n - r0) // s)
            for t0 in range(0, e, t):
                lo, hi = max(t0 - 3, 0), min(t0 + t + 3, e)
                idx = (r0 + np.arange(l)[None, :]
                       + (lo + np.arange(hi - lo))[:, None] * s)
                res_ok = (r0 + np.arange(l)[None, :] < s) & (idx < n)
                lat = (lo + np.arange(hi - lo))[:, None]
                own = (lat >= t0) & (lat < min(t0 + t, e))
                yield idx, res_ok, own

    steps = [(a, b) for a in (-1, 0, 1) for b in (-1, 0, 1) if (a, b) != (0, 0)]
    for ri, rok, rown in blocks(h, lr, tr):
        for ci, cok, cown in blocks(w, lc, tc):
            # region arrays (RR, Lr, RC, Lc)
            R = ri[:, :, None, None]
            C = ci[None, None, :, :]
            ok = rok[:, :, None, None] & cok[None, None, :, :]
            Rc, Cc = np.where(ok, R, 0), np.where(ok, C, 0)
            r_in, c_in = br[Rc, Cc], bc[Rc, Cc]
            none = ~ok | (r_in <= -(1 << 20))
            x = np.where(none, -np.inf, r_in - Rc).astype(f32)
            y = np.where(none, 0, c_in - Cc).astype(f32)

            def dist(x, y):
                with np.errstate(over="ignore", invalid="ignore"):
                    d = (x * x + y * y).astype(f32)
                return np.where(np.isinf(d), f32(1e9), d)

            d = dist(x, y)
            nrr, nrc = ri.shape[0], ci.shape[0]
            for a, b in steps:
                # the neighbour (r - a s, c - b s): lattice (i - a, j - b)
                nx = np.full_like(x, -np.inf)
                ny = np.zeros_like(y)
                src = (slice(max(-a, 0), nrr - max(a, 0)), slice(None),
                       slice(max(-b, 0), nrc - max(b, 0)), slice(None))
                dst = (slice(max(a, 0), nrr - max(-a, 0)), slice(None),
                       slice(max(b, 0), nrc - max(-b, 0)), slice(None))
                nx[dst], ny[dst] = x[src], y[src]
                inreg = np.zeros(x.shape, bool)
                inreg[dst] = True
                dom = (ok & inreg & (R - a * s >= 0) & (R - a * s < h)
                       & (C - b * s >= 0) & (C - b * s < w))
                with np.errstate(invalid="ignore"):
                    cx = (nx - f32(a * s)).astype(f32)
                    cy = (ny - f32(b * s)).astype(f32)
                nd = dist(cx, cy)
                take = dom & (nd < d)
                x, y, d = (np.where(take, cx, x), np.where(take, cy, y),
                           np.where(take, nd, d))
            own = ok & rown[:, :, None, None] & cown[None, None, :, :]
            isnone = np.isneginf(x)
            gr = np.where(isnone, -(1 << 20),
                          Rc + np.where(isnone, 0, x).astype(np.int64))
            gc = np.where(isnone, -(1 << 20), Cc + y.astype(np.int64))
            at = (np.broadcast_to(R, own.shape)[own],
                  np.broadcast_to(C, own.shape)[own])
            out_r[at], out_c[at] = gr[own], gc[own]
            np.add.at(writes, at, 1)
    return out_r, out_c, writes


def _subsampled_bench_mask():
    """Phase 12d's 540x960 seed mask (seed 0, rand < 0.001), every 4th row
    and column."""
    return np.random.RandomState(0).rand(540, 960)[::4, ::4] < 0.001


K11_SHAPES = [((45, 60), 0.004, 7), ((7, 90), 0.02, 3), ((33, 17), 0.0, 1),
              ((1, 5), 0.3, 2), ((135, 240), None, 0)]
# the tile shapes the plan keeps to, as jfa.cu's vpp_jfa_shape reports
# them: on the H100 (kRegion, kPadded, 132 SMs x 2 CTAs), and a smaller one
# whose tiles cut every side
K11_TILE_SHAPES = {"plan": (2048, 4096, 264), "plan_small": (256, 512, 16)}


@pytest.mark.parametrize(
    "shape,p,seed,tiles",
    [case + ("plan",) for case in K11_SHAPES]
    + [case + ("plan_small",) for case in K11_SHAPES]
    + [case + ("smaller_than_halo",) for case in K11_SHAPES[:4]])
def test_k11_tile_decomposition_bit_equal(shape, p, seed, tiles):
    """K11's tile-local pass, emulated, at every stride of ``_steps``:
    every pixel written once, bit-equal to ``jfa_pass_plain`` pass by
    pass (on the schedule's state, the seeds alone and random claims), and
    the transform bit-equal to the JAX package's. ``plan`` takes
    the wrapper's tiles for the H100's tile shape, ``plan_small`` for a
    smaller one; ``smaller_than_halo`` one lattice row by two lattice
    columns of one residue (a tile smaller than its halo)."""
    m = (_subsampled_bench_mask() if p is None
         else _mask(shape, p, seed))
    h, w = m.shape
    rr, cc = np.mgrid[0:h, 0:w].astype(np.int32)
    br = np.where(m, rr, -(1 << 20)).astype(np.int32)
    bc = np.where(m, cc, -(1 << 20)).astype(np.int32)
    region, padded, _ = tile_shape = K11_TILE_SHAPES.get(tiles, (0, 0, 0))
    rows = (tdt._jfa_rows(h, w, tdt._steps(h, w), tile_shape)
            if region else None)
    # besides the schedule's own state, each pass from the seeds alone
    # (information crosses 3 lattice points in a pass) and from random
    # claims (every pixel some coordinate in the image, a fifth none)
    rng = np.random.RandomState(seed)
    seeds = (br, bc)
    gone = rng.rand(h, w) < 0.2
    claims = tuple(np.where(gone, -(1 << 20), rng.randint(0, n, (h, w)))
                   .astype(np.int32) for n in (h, w))
    for q, step in enumerate(tdt._steps(h, w)):
        s = min(step, max(h, w))
        if rows is None:
            plan = (0, 1, 0, 2)
        else:
            assert rows[5 * q] == s
            plan = tuple(rows[5 * q + 1:5 * q + 5])
            er, ec = -(-h // s), -(-w // s)
            assert (min(plan[1] + 6, er) << plan[0]) * (
                min(plan[3] + 6, ec) << plan[2]) <= region
            assert ((min(plan[1] + 6, er) + 2) << plan[0]) * (
                (min(plan[3] + 6, ec) + 2) << plan[2]) <= padded
        for state in ((br, bc), seeds, claims):
            got_r, got_c, writes = _emulate_k11_pass(*state, s, plan)
            assert (writes == 1).all()
            want = tdt.jfa_pass_plain(torch.from_numpy(state[0]),
                                      torch.from_numpy(state[1]), step)
            np.testing.assert_array_equal(got_r, want[0].numpy())
            np.testing.assert_array_equal(got_c, want[1].numpy())
            if state[0] is br:
                nxt = got_r.astype(np.int32), got_c.astype(np.int32)
        br, bc = nxt
    jd, jv = jdt.euclidean_distance_transform(jnp.asarray(m))
    none = br <= -(1 << 20)
    d = np.where(none, np.float32(1e9),
                 ((br - rr).astype(np.float32) ** 2
                  + (bc - cc).astype(np.float32) ** 2))
    np.testing.assert_array_equal(np.asarray(jd), d)
    np.testing.assert_array_equal(
        np.asarray(jv), np.where(none[..., None], 0,
                                 np.stack([br - rr, bc - cc], -1)))
