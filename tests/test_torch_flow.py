"""Parity of vpp_tpu_torch's semi-dense flow (kernel K1's plain version)
with vpp_tpu's on the CPU.

The flow level is held against ``_flow_level_xla`` with the near-tie rule
of ``chip_smoke.py``: window SADs are float32 sums of bf16 |diffs| taken
in another order, so ``flow`` must be equal in every cell whose best and
second-best SAD differ by more than 1e-5 relative, and ``dist`` is held
there within rtol 1e-5. Integer-valued buffers make every sum exact, and
there the level must be bit-equal.
"""

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


def test_flow_match_then_propagate_is_the_level():
    a1, a2, pred, g, props = _level_inputs(LEVELS[0], False, seed=7)
    t1, t2, tp = (torch.from_numpy(x) for x in (a1, a2, pred))
    f, d, v = tfl.flow_match(t1, t2, tp, g)
    assert tuple(v.shape) == ((2 * g.R + 1) ** 2, g.gh, g.gw)
    for _ in range(props):
        f, d = tfl.flow_propagate(f, d, tp, v, g.R)
    lf, ld = tfl.flow_level(t1, t2, tp, g, props)
    assert torch.equal(f, lf) and torch.equal(d, ld)


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


@pytest.mark.parametrize("min_scale", [0])
def test_semi_dense_flow_matches(min_scale):
    """Keypoint readout over the whole pyramid. At most 1% of the valid
    slots may differ, through SAD near-ties."""
    (j1, j2), (t1, t2) = _images(seed=min_scale)
    rng = np.random.RandomState(11)
    k = 200
    pos = np.stack([rng.rand(k) * 95, rng.rand(k) * 127], -1).astype(
        np.float32)
    valid = rng.rand(k) > 0.2
    kw = dict(winsize=9, nscales=3, propagation=2, patchsize=5,
              min_scale=min_scale)
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
    (_, _), (t1, t2) = _images(seed=0, t2=1, shape=(32, 48))
    pos = torch.zeros((4, 2))
    with pytest.raises(NotImplementedError):
        tfl.semi_dense_optical_flow(pos, torch.ones(4, dtype=torch.bool),
                                    t1, t2, fundamental_matrix=torch.eye(3),
                                    epipolar_flow=True)
