"""Parity of vpp_tpu_torch's semi-dense flow (kernel K1's plain version)
with vpp_tpu's on the CPU.

The flow level is held against ``_flow_level_xla`` with the near-tie rule
of ``chip_smoke.py``: window SADs are float32 sums of bf16 |diffs| taken
in another order, so ``flow`` must be equal in every cell whose best and
second-best SAD differ by more than 1e-5 relative, and ``dist`` is held
there within rtol 1e-5. Integer-valued buffers make every sum exact, and
there the level must be bit-equal.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpp_tpu.core.image import from_array as j_from_array
from vpp_tpu_torch.core.image import from_array as t_from_array
from vpp_tpu_torch.utils.clips import make_clip

jfl = importlib.import_module("vpp_tpu.algorithms.flow")
tfl = importlib.import_module("vpp_tpu_torch.algorithms.flow")

torch.set_num_threads(1)

# (hb, wb, border, winsize, patch, R, pred_bound, prop_iters, extra cells)
LEVELS = [
    (60, 80, 9, 9, 5, 1, 10, 2, 0),     # a finer level with a warp
    (60, 80, 9, 9, 5, 5, 0, 2, 0),      # the top level's dense search
    (51, 73, 9, 9, 5, 1, 22, 2, 1),     # grid outgrows the image: padding
    (40, 50, 3, 7, 5, 3, 6, 1, 0),      # narrow border: edge padding
    (45, 58, 9, 9, 5, 2, 14, 0, 1),     # no propagation
]

# The tracker's three levels of a 640x480 frame (bench config): grids
# (25, 33), (49, 65) and (96, 128), coarsest first.
MAIN_LEVELS = [
    (138, 178, 9, 9, 5, 5, 0, 2, 1),
    (258, 338, 9, 9, 5, 1, 10, 2, 1),
    (498, 658, 9, 9, 5, 1, 22, 2, 0),
]


# The top level's dense search at search_niters 16 and 32 (1089 and 4225
# displacements), on the tracker's coarsest level shape
WIDE_R = [
    (138, 178, 9, 9, 5, 16, 0, 2, 1),
    (138, 178, 9, 9, 5, 32, 0, 2, 1),
]


def _level_inputs(case, integer, seed):
    hb, wb, b, ws, patch, R, pb, props, extra = case
    rng = np.random.RandomState(seed)
    h, w = hb - 2 * b, wb - 2 * b
    gh, gw = max(h // patch, 1) + extra, max(w // patch, 1) + extra
    if integer:
        a1 = rng.randint(0, 256, (hb, wb)).astype(np.float32)
        a2 = (np.roll(a1, (2, -1), (0, 1))
              + rng.randint(0, 3, (hb, wb))).astype(np.float32)
    else:
        a1 = (rng.rand(hb, wb) * 255).astype(np.float32)
        a2 = (np.roll(a1, (1, 2), (0, 1))
              + rng.rand(hb, wb) * 3).astype(np.float32)
    if pb:
        pred = (rng.randint(-pb // 2 - 1, pb // 2 + 2, (gh, gw, 2))
                * 2).astype(np.int32)
    else:
        pred = np.zeros((gh, gw, 2), np.int32)
    g = tfl.LevelGeometry(b=b, h=h, w=w, ws=ws, patch=patch, gh=gh, gw=gw,
                          R=R, pred_bound=pb)
    return a1, a2, pred, g, props


def _clear_cells(vol):
    """Cells whose best and second-best SAD differ by > 1e-5 relative."""
    two = torch.topk(vol, 2, dim=0, largest=False).values
    return ((two[1] - two[0]) > 1e-5 * two[0].abs().clamp(min=1e-30)).numpy()


@pytest.mark.parametrize("case,integer", [
    (LEVELS[0], True), (LEVELS[0], False), (LEVELS[1], False),
    (LEVELS[2], True), (LEVELS[3], False), (LEVELS[4], True)])
def test_flow_level_matches_xla(case, integer):
    a1, a2, pred, g, props = _level_inputs(case, integer, seed=case[0])
    disp, offsets = jfl._displacement_table(g.R)
    jf, jd = jfl._flow_level_xla(
        jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(pred), g.b, g.h, g.w,
        g.ws, g.patch, g.gh, g.gw, g.R, offsets, disp, g.pred_bound, props)
    jf, jd = np.asarray(jf), np.asarray(jd)
    tf, td = tfl.flow_level(torch.from_numpy(a1), torch.from_numpy(a2),
                            torch.from_numpy(pred), g, props)
    assert tf.dtype == torch.int32 and tuple(tf.shape) == jf.shape
    if integer:
        np.testing.assert_array_equal(tf.numpy(), jf)
        np.testing.assert_array_equal(td.numpy(), jd)
        return
    _, _, vol = tfl.flow_match_plain(torch.from_numpy(a1),
                                     torch.from_numpy(a2),
                                     torch.from_numpy(pred), g)
    clear = _clear_cells(vol)
    np.testing.assert_array_equal(tf.numpy()[clear], jf[clear])
    np.testing.assert_allclose(td.numpy()[clear], jd[clear], rtol=1e-5)


@pytest.mark.parametrize("case", MAIN_LEVELS)
def test_main_path_level_matches_xla(case):
    """The plain level at the tracker's three level shapes, on
    integer-valued buffers: bit-equal, ties included."""
    a1, a2, pred, g, props = _level_inputs(case, True, seed=case[0])
    disp, offsets = jfl._displacement_table(g.R)
    jf, jd = jfl._flow_level_xla(
        jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(pred), g.b, g.h, g.w,
        g.ws, g.patch, g.gh, g.gw, g.R, offsets, disp, g.pred_bound, props)
    tf, td = tfl.flow_level(torch.from_numpy(a1), torch.from_numpy(a2),
                            torch.from_numpy(pred), g, props)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def _assert_plan_covers(g, plan):
    """Launch A's blocks cover every (displacement, cell) once and launch
    B's every cell once; shared memory stays within a Hopper block's
    227 KB."""
    d2, t = (2 * g.R + 1) ** 2, plan.a_tile
    seen = np.zeros((d2, g.gh, g.gw), np.int32)
    bx, by, bz = plan.a_grid
    for z in range(bz):
        for y in range(by):
            for x in range(bx):
                seen[z * plan.chunk:(z + 1) * plan.chunk,
                     y * t:(y + 1) * t, x * t:(x + 1) * t] += 1
    assert (seen == 1).all()
    assert bz * plan.chunk >= d2 > (bz - 1) * plan.chunk
    assert 1 <= plan.batch <= min(plan.chunk, 8)
    t = plan.b_tile
    cells = np.zeros((g.gh, g.gw), np.int32)
    for y in range(plan.b_grid[1]):
        for x in range(plan.b_grid[0]):
            cells[y * t:(y + 1) * t, x * t:(x + 1) * t] += 1
    assert (cells == 1).all()
    assert max(plan.a_smem, plan.b_smem) <= 227 * 1024


@pytest.mark.parametrize("shape", tfl._VOLUME_SHAPES)
@pytest.mark.parametrize("case", MAIN_LEVELS + LEVELS + WIDE_R)
def test_k1_plan_covers_each_cell_once(case, shape):
    """K1's tile plan at each of launch A's tile shapes, and the plan it
    chooses: every cell and displacement covered once, shared memory within
    a Hopper block; the finest level fills the H100's 132 SMs."""
    *_, g, props = _level_inputs(case, True, seed=0)
    plan = tfl._k1_plan(g, props, 132, (shape,))
    assert (plan.a_tile, plan.a_threads) == shape
    assert plan.iters == props
    _assert_plan_covers(g, plan)
    chosen = tfl._k1_plan(g, props, 132)
    _assert_plan_covers(g, chosen)
    if case == MAIN_LEVELS[-1]:
        assert chosen.a_grid[0] * chosen.a_grid[1] * chosen.a_grid[2] >= 132


def test_k1_plan_tile_choice():
    """The larger tile where its tiles alone fill the 132 SMs (the finest
    level), the smaller one at the two coarser levels."""
    tiles = [tfl._k1_plan(_level_inputs(case, True, seed=0)[3], case[7],
                          132).a_tile for case in MAIN_LEVELS]
    assert tiles == [4, 4, 8]


# (winsize, patch, R): windows that fit the larger tile only one
# displacement at a time, windows that only the smaller tile takes, and
# windows that fit the smaller tile at a batch of 4
LARGE_WINDOWS = [(31, 16, 5), (31, 16, 10), (41, 24, 5)]


@pytest.mark.parametrize("ws,patch,R", LARGE_WINDOWS)
def test_k1_plan_fits_large_windows(ws, patch, R):
    """Large windows split launch A's chunk into more batches until the
    block's shared memory fits; a tile shape that does not fit at a batch
    of one is passed over, and where no shape fits launch A takes its
    global route (no shared memory), which covers each cell once."""
    g = tfl.LevelGeometry(b=ws, h=240, w=320, ws=ws, patch=patch,
                          gh=240 // patch, gw=320 // patch, R=R,
                          pred_bound=8)
    for tile, threads in tfl._VOLUME_SHAPES:
        plan = tfl._k1_plan(g, 2, 132, ((tile, threads),))
        if plan.a_route == "global":
            assert tfl._volume_smem(g, tile, threads, 1, 1) > tfl._SMEM_MAX
            assert plan.a_smem == 0 and plan.batch == 1
            _assert_plan_covers(g, plan)
            continue
        assert (plan.a_tile, plan.a_threads) == (tile, threads)
        _assert_plan_covers(g, plan)
        nbatch = -(-plan.chunk // plan.batch)
        if nbatch > -(-plan.chunk // 8):     # fewer batches do not fit
            assert tfl._volume_smem(g, tile, threads, plan.chunk,
                                    -(-plan.chunk // (nbatch - 1))) > \
                tfl._SMEM_MAX
    _assert_plan_covers(g, tfl._k1_plan(g, 2, 132))
    huge = dataclasses.replace(g, ws=151, patch=40, gh=6, gw=8)
    plan = tfl._k1_plan(huge, 2, 132)
    assert plan.a_route == "global" and plan.a_smem == 0
    assert all(tfl._volume_smem(huge, t, n, 1, 1) > tfl._SMEM_MAX
               for t, n in tfl._VOLUME_SHAPES)
    _assert_plan_covers(huge, plan)


@pytest.mark.parametrize("props,links", [
    (0, (0,)), (2, (2,)), (38, (38,)), (39, (38, 1)), (48, (38, 10)),
    (80, (38, 38, 4))])
def test_select_links_chain_past_the_halo(props, links):
    """Launch B's passes a launch, where a pass count past what its halo
    fits raised before: one launch while the tile and a halo of its passes
    fit a block's shared memory (38 passes at the 8-cell tile), then a
    chain; every link and the plan fit, the plan's launch B is the first
    link's, and the plans of today's pass counts do not change."""
    links_got = tfl._select_links(tfl._SELECT_TILE, props)
    assert links_got == links and sum(links_got) == props
    for n in links_got:
        assert tfl._select_smem(tfl._SELECT_TILE, n, 0,
                                table=False) <= tfl._SMEM_MAX
    g = tfl.LevelGeometry(b=9, h=120, w=160, ws=9, patch=5, gh=24, gw=32,
                          R=5, pred_bound=0)
    plan = tfl._k1_plan(g, props, 132)
    assert (plan.b_smem, plan.b_table) == tfl._select_plan(
        tfl._SELECT_TILE, links[0], g.R)
    assert plan.b_smem <= tfl._SMEM_MAX


def test_flow_level_48_passes_matches_xla():
    """``prop_iters`` 48 (a chain of two select launches on the card) on
    an integer-valued level, against the JAX package's level: the same
    flow and dist bits."""
    a1, a2, pred, g, _ = _level_inputs(LEVELS[0], True, seed=48)
    disp, offsets = jfl._displacement_table(g.R)
    jf, jd = jfl._flow_level_xla(
        jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(pred), g.b, g.h, g.w,
        g.ws, g.patch, g.gh, g.gw, g.R, offsets, disp, g.pred_bound, 48)
    tf, td = tfl.flow_level(torch.from_numpy(a1), torch.from_numpy(a2),
                            torch.from_numpy(pred), g, 48)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_flow_match_then_propagate_is_the_level():
    a1, a2, pred, g, props = _level_inputs(LEVELS[0], False, seed=7)
    t1, t2, tp = (torch.from_numpy(x) for x in (a1, a2, pred))
    f, d, v = tfl.flow_match(t1, t2, tp, g)
    assert tuple(v.shape) == ((2 * g.R + 1) ** 2, g.gh, g.gw)
    f1, d1 = tfl.flow_propagate(f, d, tp, v, g.R, iters=props)
    for _ in range(props):
        f, d = tfl.flow_propagate(f, d, tp, v, g.R)
    lf, ld = tfl.flow_level(t1, t2, tp, g, props)
    assert torch.equal(f, lf) and torch.equal(d, ld)
    assert torch.equal(f1, lf) and torch.equal(d1, ld)


def test_displacement_tables_match():
    for R in (1, 2, 5):
        jd, jo = jfl._displacement_table(R)
        td, to = tfl._displacement_table(R)
        np.testing.assert_array_equal(jd, td)
        flat = jfl._flat_index_map(R)
        inv = tfl._flat_to_k(R)
        np.testing.assert_array_equal(inv[flat], np.arange(len(to)))
    assert tfl._level_radii(3, 5, 1) == jfl._level_radii(3, 5, 1)
    assert tfl._level_bounds(3, [1, 1, 5]) == jfl._level_bounds(3, [1, 1, 5])


def _images(seed, t2=2, shape=(96, 128)):
    clip = make_clip(shape[1], shape[0], t2 + 1, seed=seed)
    return ([j_from_array(jnp.asarray(clip[i]), border=9,
                          border_mode="mirror") for i in (0, t2)],
            [t_from_array(clip[i], border=9, border_mode="mirror")
             for i in (0, t2)])


@pytest.mark.parametrize("min_scale,search_niters", [
    (0, 5), (0, 16), (0, 20)], ids=["0", "0-niters16", "0-niters20"])
def test_semi_dense_flow_matches(min_scale, search_niters):
    """Keypoint readout over the whole pyramid. At most 1% of the valid
    slots may differ, through SAD near-ties. ``search_niters`` 16 and 20
    search 1089 and 1681 displacements at the top level."""
    (j1, j2), (t1, t2) = _images(seed=min_scale)
    rng = np.random.RandomState(11)
    k = 200
    pos = np.stack([rng.rand(k) * 95, rng.rand(k) * 127], -1).astype(
        np.float32)
    valid = rng.rand(k) > 0.2
    kw = dict(winsize=9, nscales=3, propagation=2, patchsize=5,
              min_scale=min_scale, search_niters=search_niters)
    jm, jd, jok = jax.jit(lambda p, v, a, b: jfl.semi_dense_optical_flow(
        p, v, a, b, **kw))(jnp.asarray(pos), jnp.asarray(valid), j1, j2)
    tm, td, tok = tfl.semi_dense_optical_flow(torch.from_numpy(pos),
                                              torch.from_numpy(valid), t1,
                                              t2, **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    diff = (np.abs(tm.numpy() - np.asarray(jm)).max(-1) > 0) & valid
    assert diff.sum() <= 0.01 * valid.sum()
    same = valid & ~diff & (np.asarray(jd) < 1e29)
    np.testing.assert_allclose(td.numpy()[same], np.asarray(jd)[same],
                               rtol=1e-5)


def test_dense_flow_matches():
    (j1, j2), (t1, t2) = _images(seed=3, t2=1, shape=(64, 96))
    jf, jd = jax.jit(lambda a, b: jfl.dense_optical_flow(
        a, b, winsize=9, nscales=3))(j1, j2)
    tf, td = tfl.dense_optical_flow(t1, t2, winsize=9, nscales=3)
    assert tuple(tf.shape) == np.asarray(jf).shape
    differ = np.abs(tf.numpy() - np.asarray(jf)).max(-1) > 0
    assert differ.sum() <= 0.01 * differ.size


def test_epipolar_branch_not_ported():
    """The epipolar branch, which raised here before it was ported, runs
    and equals JAX on this input (``test_torch_flow_epipolar.py`` holds it
    in full); ``semi_dense_streams`` has no epipolar options, as JAX has no
    streams form of the branch."""
    (j1, j2), (t1, t2) = _images(seed=0, t2=1, shape=(32, 48))
    pos = np.array([[8.0, 8.0], [16.0, 20.0], [20.0, 30.0], [10.0, 40.0]],
                   np.float32)
    F = np.array([[0, 0, 1], [0, 0, 0], [-1, 0, 0]], np.float32)
    kw = dict(nscales=2, epipolar_flow=True, epipolar_filter=2.0)
    j = jfl.semi_dense_optical_flow(jnp.asarray(pos), jnp.ones(4, bool),
                                    j1, j2, fundamental_matrix=jnp.asarray(F),
                                    **kw)
    t = tfl.semi_dense_optical_flow(torch.from_numpy(pos),
                                    torch.ones(4, dtype=torch.bool), t1, t2,
                                    fundamental_matrix=torch.from_numpy(F),
                                    **kw)
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    with pytest.raises(TypeError):
        tfl.semi_dense_streams(torch.from_numpy(pos)[None],
                               torch.ones((1, 4), dtype=torch.bool),
                               (), (), 9, fundamental_matrix=F)
