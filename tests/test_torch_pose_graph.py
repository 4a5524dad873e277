"""The port's pose graph, map-vote round, detection patches, sub-pixel
refinement, checkpoints and loop scenarios on the CPU.

Against vpp_tpu, on the same seeded numpy inputs:

* ``pose_graph_residuals``, the per-edge Jacobian blocks and
  ``pose_graph_solve`` on tests/test_slam.py's ``_ring_graph`` (all-zero
  residuals, with an invalid edge, with a second fixed node, and the drift
  correction of ``test_pose_graph_corrects_drift``): residuals and poses
  atol 1e-4, Jacobians atol 1e-4 and finite;
* ``_vote_round_plain`` (the vote round of kernel K8's plain version)
  against the JAX round (``vpp_tpu/slam/pipeline.py:369-409``, transcribed
  below from after the projection, run op by op): ``js``, ``tx0``/``ty0``
  and the vote mask equal, ``ds`` and ``cand_uv`` equal, ``dd`` atol 1e-5,
  on random inputs with exact distance ties, with no valid detection, at
  A != Q and with a NaN ``pred`` row;
* ``_det_shift_patches`` bit-equal; ``_refine_obs_subpix`` on
  tests/test_pipeline.py:115's inputs atol 1e-4 (``ok`` equal), and
  ``torch.gradient`` equal to ``jnp.gradient``.

The port alone: ``map_vote_pnp``'s one output allocation and its operand
checks; ``save_state``/``restore_state`` round trips of
``SlamState``, ``BATracks`` and ``PoseGraph``, and the three scenarios of
tests/test_pose_graph_loop.py held to that file's own assertions.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpp_tpu.core.image import from_array as j_from_array
from vpp_tpu.core.interp import extract_patches as j_extract_patches
from vpp_tpu.slam import pose_graph as jpg
from vpp_tpu.slam import se3_exp as j_se3_exp
from vpp_tpu_torch import convert
from vpp_tpu_torch.algorithms.video_extruder import (
    VideoExtruderConfig as TVConfig)
from vpp_tpu_torch.core.image import from_array as t_from_array
from vpp_tpu_torch.slam import map_vote as tmv
from vpp_tpu_torch.slam import pose_graph as tpg
from vpp_tpu_torch.slam.ba import BATracks
from vpp_tpu_torch.slam.checkpoint import restore_state, save_state
from vpp_tpu_torch.utils import synth as tsynth

from test_slam import _ring_graph

jp = importlib.import_module("vpp_tpu.slam.pipeline")
tp = importlib.import_module("vpp_tpu_torch.slam.pipeline")

torch.set_num_threads(1)

H, W = 120, 160
INTR = (160.0, 160.0, 80.0, 60.0)


# --- pose graph ------------------------------------------------------------

def _graph_case(case):
    """A JAX ``PoseGraph`` from ``_ring_graph`` and the ground truth."""
    Ts, g = _ring_graph()
    if case == "invalid_edge":
        g = g._replace(edge_valid=g.edge_valid.at[2].set(False))
    if case == "fixed_node":
        g = g._replace(fixed=g.fixed.at[3].set(True))
    if case != "zero_residual":
        rng = np.random.RandomState(3)
        m = g.poses.shape[0]
        d = jnp.asarray(np.concatenate(
            [np.zeros((1, 6)), rng.randn(m - 1, 6) * 0.05]), jnp.float32)
        g = g._replace(poses=jax.vmap(lambda dd, T: j_se3_exp(dd) @ T)(
            d, g.poses))
    return Ts, g


def _to_port(g):
    return convert.pose_graph_from_numpy(
        {k: np.asarray(v) for k, v in g._asdict().items()}, device="cpu")


GRAPH_CASES = ["zero_residual", "drift", "invalid_edge", "fixed_node"]


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_pose_graph_residuals_and_jacobians_match(case):
    _, g = _graph_case(case)
    tg = _to_port(g)
    np.testing.assert_allclose(tpg.pose_graph_residuals(tg).numpy(),
                               np.asarray(jpg.pose_graph_residuals(g)),
                               atol=1e-4)
    z6 = jnp.zeros((6,), jnp.float32)
    Ti, Tj = g.poses[g.edge_i], g.poses[g.edge_j]
    jJi = jax.vmap(lambda a, b, z: jax.jacfwd(jpg._edge_residual, 0)(
        z6, z6, a, b, z))(Ti, Tj, g.edge_T)
    jJj = jax.vmap(lambda a, b, z: jax.jacfwd(jpg._edge_residual, 1)(
        z6, z6, a, b, z))(Ti, Tj, g.edge_T)
    tTi, tTj = tpg._edge_poses(tg)
    r, Ji, Jj = torch.func.vmap(tpg._blocks)(tTi, tTj, tg.edge_T)
    assert bool(torch.isfinite(Ji).all() and torch.isfinite(Jj).all())
    np.testing.assert_allclose(Ji.numpy(), np.asarray(jJi), atol=1e-4)
    np.testing.assert_allclose(Jj.numpy(), np.asarray(jJj), atol=1e-4)


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_pose_graph_solve_matches(case):
    Ts, g = _graph_case(case)
    js, jc = jpg.pose_graph_solve(g, iters=10)
    ts, tc = tpg.pose_graph_solve(_to_port(g), iters=10)
    assert tc.shape == (10,) and bool(torch.isfinite(ts.poses).all())
    np.testing.assert_allclose(ts.poses.numpy(), np.asarray(js.poses),
                               atol=1e-4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    if case == "drift":       # test_pose_graph_corrects_drift's own gates
        r0 = np.abs(tpg.pose_graph_residuals(_to_port(g)).numpy()).max()
        r1 = np.abs(tpg.pose_graph_residuals(ts).numpy()).max()
        assert r1 < r0 * 1e-2, (r0, r1)
        np.testing.assert_allclose(ts.poses.numpy(), np.asarray(Ts),
                                   atol=1e-3)


# --- the map-vote round (K8's plain version) ---------------------------------

def _jax_vote_round(pred, z, posf, valid, base, fx, fy, R_wide, bmax, NB):
    """``vote_round`` of vpp_tpu/slam/pipeline.py:369-409 from after the
    projection, line by line; returns (tx0, ty0, js, ds, cand_uv, dd, m)."""
    C, _HUGE = 4, 1e30
    step = 2.0 * bmax / (NB - 1)
    rows = jnp.arange(pred.shape[0])
    d2 = jnp.sum((pred[:, None] - posf[None]) ** 2, axis=-1)
    d2 = jnp.where(valid[None], d2, _HUGE)
    js, dss = [], []
    d2c = d2
    for _ in range(C):
        j = jnp.argmin(d2c, axis=1)
        dss.append(jnp.min(d2c, axis=1))
        js.append(j)
        d2c = d2c.at[rows, j].set(_HUGE)
    js = jnp.stack(js, axis=1)
    ds = jnp.stack(dss, axis=1)
    cand_uv = posf[js]
    txc = (cand_uv[..., 1] - pred[:, None, 1]) * z[:, None] / fx
    tyc = (cand_uv[..., 0] - pred[:, None, 0]) * z[:, None] / fy
    m = base[:, None] & (ds <= R_wide ** 2) & (z[:, None] > 0.1)
    bx = jnp.clip(jnp.round((txc + bmax) / step).astype(jnp.int32),
                  0, NB - 1)
    by = jnp.clip(jnp.round((tyc + bmax) / step).astype(jnp.int32),
                  0, NB - 1)
    votes = jnp.zeros((NB * NB,), jnp.float32).at[
        jnp.where(m, by * NB + bx, NB * NB).reshape(-1)].add(
        1.0, mode="drop").reshape(NB, NB)
    vp = jnp.pad(votes, 1)
    sm = sum(vp[i:i + NB, jj:jj + NB] for i in range(3) for jj in range(3))
    pk = jnp.argmax(sm.reshape(-1))
    any_votes = sm.reshape(-1)[pk] > 0
    tx0 = jnp.where(any_votes,
                    (pk % NB).astype(jnp.float32) * step - bmax, 0.0)
    ty0 = jnp.where(any_votes,
                    (pk // NB).astype(jnp.float32) * step - bmax, 0.0)
    dd = jnp.where(m, (txc - tx0) ** 2 + (tyc - ty0) ** 2, _HUGE)
    return tx0, ty0, js, ds, cand_uv, dd, m


def _vote_inputs(case):
    """Seeded (pred, z, posf, valid, base): a 160x120 frame's detections
    and map entries projected near them, shifted by a common offset."""
    rng = np.random.RandomState({"random": 0, "ties": 1, "no_valid": 2,
                                 "odd": 3, "nan_row": 4}[case])
    a_n, q_n = {"odd": (61, 37)}.get(case, (96, 64))
    posf = np.stack([rng.uniform(0, H, q_n), rng.uniform(0, W, q_n)], 1)
    if case == "ties":         # integer positions, duplicated detections
        posf = np.round(posf)
        posf[q_n // 2:] = posf[:q_n - q_n // 2]
    src = rng.randint(0, q_n, a_n)
    pred = posf[src] + rng.normal(0, 2.0, (a_n, 2)) + [3.0, -2.0]
    if case == "ties":
        pred = np.round(pred)
    pred[rng.rand(a_n) < 0.2] = rng.uniform(0, W, 2)   # outliers
    z = rng.uniform(2.0, 8.0, a_n)
    z[:3] = [0.05, -1.0, 0.1]                          # behind / at the gate
    valid = rng.rand(q_n) > 0.15
    if case == "no_valid":
        valid[:] = False
    base = rng.rand(a_n) > 0.1
    if case == "nan_row":
        pred[5] = np.nan
        pred[9, 0] = np.nan
    return (pred.astype(np.float32), z.astype(np.float32),
            posf.astype(np.float32), valid, base)


@pytest.mark.parametrize("case", ["random", "ties", "no_valid", "odd",
                                  "nan_row"])
def test_vote_round_plain_matches_jax(case):
    pred, z, posf, valid, base = _vote_inputs(case)
    r_wide, bmax = 3.0 * 8.0, 1.2
    intr = np.asarray(INTR, np.float32)
    jout = _jax_vote_round(jnp.asarray(pred), jnp.asarray(z),
                           jnp.asarray(posf), jnp.asarray(valid),
                           jnp.asarray(base), jnp.asarray(intr)[0],
                           jnp.asarray(intr)[1], r_wide, bmax, 33)
    tx0, ty0, jjs, jds, jcand, jdd, jm = (np.asarray(v) for v in jout)
    txy, js, ds, cand_uv, dd = tmv._vote_round_plain(
        *(torch.from_numpy(v) for v in (pred, z, posf, valid, base)),
        torch.from_numpy(intr), r_wide, bmax)
    assert tmv.NB == 33 and js.dtype == torch.int32
    np.testing.assert_array_equal(js.numpy(), jjs)
    np.testing.assert_array_equal(ds.numpy(), jds)
    np.testing.assert_array_equal(cand_uv.numpy(), jcand)
    np.testing.assert_array_equal(txy.numpy(), [tx0, ty0])
    np.testing.assert_array_equal(dd.numpy() < 1e29, jm)
    np.testing.assert_allclose(dd.numpy(), jdd, atol=1e-5)
    if case == "no_valid":
        assert not jm.any() and tx0 == 0.0 and ty0 == 0.0
        assert (js.numpy() == 0).all()
    if case == "nan_row":      # NaN rows take their first valid detections
        first = np.flatnonzero(valid)[:4]
        np.testing.assert_array_equal(js.numpy()[5], first)
    if case in ("random", "ties", "odd"):
        assert jm.sum() > 20 and (tx0, ty0) != (0.0, 0.0)


def _pnp_operands(a_n=37, q_n=11, b_n=2, p=3, rounds=2):
    """Seeded ``map_vote_pnp`` operands at a small size (CPU tensors)."""
    rng = np.random.RandomState(5)
    X = np.stack([rng.uniform(-2, 2, a_n), rng.uniform(-1.5, 1.5, a_n),
                  rng.uniform(3, 8, a_n)], 1)
    pos = np.stack([rng.randint(0, H, q_n), rng.randint(0, W, q_n)], 1)
    return (torch.from_numpy(X.astype(np.float32)),
            torch.from_numpy(rng.rand(a_n, p * p).astype(np.float32)),
            torch.from_numpy(rng.rand(b_n, a_n) > 0.3),
            torch.from_numpy(pos.astype(np.int32)),
            torch.from_numpy(rng.rand(q_n) > 0.2),
            torch.from_numpy(rng.rand(9, q_n, p * p).astype(np.float32)),
            torch.eye(4), torch.tensor(INTR))


PNP_ARGS = dict(r_wide=24.0, bmax=1.2, gate=0.35, rounds=2, pnp_iters=6,
                huber=4.0)


def test_vote_round_kernel_outputs_layout():
    """K8's outputs and scratch share one allocation without overlap,
    shaped and typed as the plain version's result."""
    a_n, b_n, rounds = 37, 2, 3
    outs, scratch = tmv._outputs(b_n, a_n, rounds, torch.device("cpu"))
    plain = tmv.map_vote_pnp(*_pnp_operands(a_n, b_n=b_n),
                             **dict(PNP_ARGS, rounds=rounds))
    assert outs._fields == plain._fields
    for o, w in zip(outs, plain):
        assert o.shape == w.shape and o.dtype == w.dtype and o.is_contiguous()
    assert outs.txy.shape == (b_n, rounds, 2)
    assert scratch[0].shape == (b_n * a_n * 4,)
    assert scratch[1].shape == (b_n * a_n * 8,)
    tensors = list(outs) + list(scratch)
    for t in tensors:
        t.view(-1).zero_()
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                   for t in tensors)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    words = (16 + 1 + 1 + 2 * rounds) * b_n + 3 * a_n * b_n \
        + -(-a_n * b_n // 4) + 12 * a_n * b_n
    assert spans[-1][1] - outs.T.data_ptr() == words * 4


def test_vote_round_checks_its_operands():
    """``map_vote_pnp`` refuses operands of the wrong shape, empty sets and
    no vote round, before it reaches a kernel."""
    X, desc, base, pos, valid, det, T0, intr = _pnp_operands()
    bad = [
        dict(pos=pos[:0], valid=valid[:0], det_patches=det[:, :0]),
        dict(X=X[:-1]),
        dict(base=base[:, :-1]),
        dict(base=base[:0]),
        dict(intr=intr[:2]),
        dict(det_patches=det[:8]),
        dict(T_prior=T0[:3]),
    ]
    ops = dict(X=X, desc=desc, base=base, pos=pos, valid=valid,
               det_patches=det, T_prior=T0, intr=intr)
    for b in bad:
        with pytest.raises(ValueError):
            tmv.map_vote_pnp(**dict(ops, **b), **PNP_ARGS)
    with pytest.raises(ValueError):
        tmv.map_vote_pnp(**ops, **dict(PNP_ARGS, rounds=0))
    out = tmv.map_vote_pnp(**ops, **PNP_ARGS)
    assert out.T.shape == (2, 4, 4) and out.n.dtype == torch.int32


# --- detection patches and sub-pixel refinement ----------------------------

def _frames(n=2, seed=3, n_points=60, step=(0.04, 0.0, 0.0)):
    pts = tsynth.make_cloud(n_points, seed=seed, extent=(6.0, 4.0, 3.0),
                            center=(0.8, 0.0, 5.0))
    poses = tsynth.camera_path(n, step=step)
    return pts, poses, tsynth.render_frames(pts, poses, INTR, (H, W),
                                            seed=seed)


def test_det_shift_patches_bit_equal():
    _, _, frames = _frames()
    rng = np.random.RandomState(5)
    pos = np.stack([rng.randint(-3, H + 3, 50), rng.randint(-3, W + 3, 50)],
                   1).astype(np.int32)
    jf = j_from_array(jnp.asarray(frames[1]), border=9, border_mode="mirror")
    tf = t_from_array(torch.from_numpy(frames[1]), border=9,
                      border_mode="mirror")
    want = np.asarray(jp._det_shift_patches(jf, jnp.asarray(pos), 7))
    got = tp._det_shift_patches(tf, torch.from_numpy(pos), 7)
    assert got.shape == (9, 50, 49)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gradient_matches_jnp_gradient():
    a = np.random.RandomState(0).rand(13, 17).astype(np.float32) * 255
    gr, gc = torch.gradient(torch.from_numpy(a), dim=(0, 1))
    np.testing.assert_array_equal(gr.numpy(),
                                  np.asarray(jnp.gradient(a, axis=0)))
    np.testing.assert_array_equal(gc.numpy(),
                                  np.asarray(jnp.gradient(a, axis=1)))


def test_refine_obs_subpix_matches():
    """tests/test_pipeline.py:115's inputs through both refiners."""
    pts, poses, frames = _frames()
    b, P = 9, 7
    intr = np.asarray(INTR)

    def proj(T, X):
        pc = (np.c_[X, np.ones(len(X))] @ T.T)[:, :3]
        u = intr[0] * pc[:, 0] / pc[:, 2] + intr[2]
        v = intr[1] * pc[:, 1] / pc[:, 2] + intr[3]
        return np.stack([v, u], 1)

    uv0, uv1 = proj(poses[0], pts), proj(poses[1], pts)
    ok = ((uv0 > 10) & (uv0 < [H - 10, W - 10])).all(1) & (
        (uv1 > 10) & (uv1 < [H - 10, W - 10])).all(1)
    uv0, uv1 = uv0[ok], uv1[ok]
    f0 = j_from_array(jnp.asarray(frames[0]), border=b, border_mode="mirror")
    ctr = np.round(uv0).astype(np.int32) + b
    templ = np.asarray(j_extract_patches(f0.data, jnp.asarray(ctr), P)
                       ).reshape(len(uv0), -1)
    start = np.round(uv1).astype(np.float32)
    valid = np.ones((len(uv0),), bool)
    valid[::7] = False
    jr, jok = jp._refine_obs_subpix(
        j_from_array(jnp.asarray(frames[1]), border=b, border_mode="mirror"),
        jnp.asarray(start), jnp.asarray(templ), jnp.asarray(valid), P)
    tr, tok = tp._refine_obs_subpix(
        t_from_array(torch.from_numpy(frames[1]), border=b,
                     border_mode="mirror"),
        torch.from_numpy(start), torch.from_numpy(templ),
        torch.from_numpy(valid), P)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4)
    # the JAX test's own gates, on the port
    expected = uv1 + (np.round(uv0) - uv0)
    err_before = np.abs(start - expected)[valid].mean()
    err_after = np.abs(tr.numpy() - expected)[valid].mean()
    assert tok.numpy()[valid].mean() > 0.8
    assert err_after < err_before * 0.7, (err_before, err_after)


# --- checkpoints ------------------------------------------------------------

def _assert_same(a, b):
    names = ([f.name for f in dataclasses.fields(a)]
             if dataclasses.is_dataclass(a) else a._fields)
    assert type(a) is type(b)
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device, name
            assert torch.equal(x, y), name
        elif dataclasses.is_dataclass(x):
            _assert_same(x, y)
        else:
            assert type(x) is type(y) and x == y, name


def _zeroed(obj):
    if isinstance(obj, torch.Tensor):
        return torch.zeros_like(obj)
    if isinstance(obj, int):
        return 0
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _zeroed(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return type(obj)(*(_zeroed(v) for v in obj))


def _slam_state():
    pts, poses, frames = _frames(n=9, seed=0, n_points=220,
                                 step=(0.06, 0.0, 0.0))
    cfg = tp.SlamConfig(
        intrinsics=INTR, keyframe_period=4, ring=6, ba_iters=3,
        min_parallax=2.0, max_reproj=2.0, history=16,
        tracker=TVConfig(capacity=256, detect_k=128, nscales=3, winsize=9,
                         keypoint_spacing=8, detector_period=1,
                         detector_th=8))
    return tp.slam_run(frames, cfg, bootstrap_poses=poses[[0, 4]],
                       device="cpu")


@pytest.mark.parametrize("kind", ["SlamState", "BATracks", "PoseGraph"])
def test_checkpoint_round_trip(tmp_path, kind):
    if kind == "SlamState":
        state = _slam_state()
        assert state.n_keyframes == 3 and state.tracker.frame_id == 8
    elif kind == "BATracks":
        rng = np.random.RandomState(1)
        state = BATracks(
            poses=torch.from_numpy(rng.randn(3, 4, 4).astype(np.float32)),
            landmarks=torch.from_numpy(rng.randn(8, 3).astype(np.float32)),
            obs_pose=torch.from_numpy(rng.randint(0, 3, (8, 3)).astype(
                np.int32)),
            obs_uv=torch.from_numpy(rng.rand(8, 3, 2).astype(np.float32)),
            obs_valid=torch.from_numpy(rng.rand(8, 3) > 0.5),
            intrinsics=torch.tensor(INTR),
            fixed_poses=torch.tensor([True, False, False]))
    else:
        state = _to_port(_graph_case("drift")[1])
    path = str(tmp_path / "ckpt" / "state.pt")
    save_state(path, state)
    restored = restore_state(path, _zeroed(state))
    _assert_same(restored, state)
    with pytest.raises(ValueError):
        restore_state(path, _zeroed(state)._replace(poses=torch.zeros(1))
                      if kind != "SlamState" else dataclasses.replace(
                          _zeroed(state), lm_X=torch.zeros(1)))


def test_convert_pose_graph_round_trip():
    _, g = _graph_case("fixed_node")
    m = {k: np.asarray(v) for k, v in g._asdict().items()}
    back = convert.pose_graph_to_numpy(_to_port(g))
    assert set(back) == set(m)
    for k in m:
        np.testing.assert_array_equal(back[k], m[k], k)
        assert back[k].dtype == m[k].dtype, k


# --- the loop and blackout scenarios, on the port ----------------------------

def _loop_cfg(**kw):
    base = dict(
        intrinsics=INTR, keyframe_period=4, ring=6, ba_iters=3,
        min_parallax=2.0, max_reproj=2.0, history=16,
        lc_min_gap=10, lc_min_inliers=10, lc_max_err=1.5,
        tracker=TVConfig(capacity=256, detect_k=128, nscales=3, winsize=9,
                         keypoint_spacing=8, detector_period=1,
                         detector_th=8))
    base.update(kw)
    return tp.SlamConfig(**base)


def _loop_run(frames, poses_gt, cfg):
    state = tp.slam_run(frames, cfg,
                        bootstrap_poses=poses_gt[[0, cfg.keyframe_period]],
                        device="cpu")
    est, fids = tp.keyframe_trajectory(state)
    return state, float(tp.ate_rmse(est, torch.from_numpy(
        poses_gt[fids.numpy()])))


def _out_and_back(legs):
    """Camera-from-world poses along x through the positions ``legs``."""
    poses = np.tile(np.eye(4, dtype=np.float32), (len(legs), 1, 1))
    poses[:, 0, 3] = -np.asarray(legs)
    return poses


def test_loop_closure_improves_ate():
    """tests/test_pose_graph_loop.py:59 on the port."""
    pts = tsynth.make_cloud(220, seed=0, extent=(6.0, 4.0, 3.0),
                            center=(0.4, 0.0, 5.0))
    xs = list(np.arange(20) * 0.06)
    poses_gt = _out_and_back(xs + list(xs[-1] - np.arange(1, 21) * 0.06))
    frames = tsynth.render_frames(pts, poses_gt, INTR, (H, W), seed=0,
                                  sigma=(1.0, 1.8)).copy()
    frames[10:13] = 0.0
    state_on, ate_on = _loop_run(frames, poses_gt, _loop_cfg(
        history=24, lc_max_err=4.5, lc_min_gap=8))
    state_off, ate_off = _loop_run(frames, poses_gt, _loop_cfg(
        history=24, lc_min_inliers=10 ** 6))
    assert int(state_off.lc_ptr) == 0
    assert int(state_on.lc_ptr) >= 1
    assert ate_on < ate_off, (ate_on, ate_off)


def test_blackout_recovery():
    """tests/test_pose_graph_loop.py:83 on the port."""
    pts = tsynth.make_cloud(220, seed=1, extent=(6.0, 4.0, 3.0),
                            center=(0.6, 0.0, 5.0))
    poses_gt = tsynth.camera_path(26, step=(0.05, 0.0, 0.0))
    frames = tsynth.render_frames(pts, poses_gt, INTR, (H, W), seed=1,
                                  sigma=(1.0, 1.8)).copy()
    frames[13:15] = 0.0
    state, ate = _loop_run(frames, poses_gt,
                           _loop_cfg(lc_min_gap=6, min_tracked=10))
    est, fids = tp.keyframe_trajectory(state)
    fids = fids.numpy()
    assert fids[-1] >= 20, fids
    assert int(state.lm_valid.sum()) > 30

    def centre(T):
        return -T[:3, :3].T @ T[:3, 3]

    k16 = int(np.where(fids == 16)[0][0])
    err16 = np.linalg.norm(centre(est[k16].numpy()) - centre(poses_gt[16]))
    assert err16 < 0.45, err16
    assert ate < 0.8, ate


def test_two_loops_with_mid_drift_spike():
    """tests/test_pose_graph_loop.py:120 on the port."""
    pts = tsynth.make_cloud(220, seed=2, extent=(6.0, 4.0, 3.0),
                            center=(0.3, 0.0, 5.0))
    n, step = 12, 0.06
    xs = []
    for _ in range(2):
        xs += list(np.arange(n) * step)
        xs += list((n - 1) * step - np.arange(1, n + 1) * step)
    poses_gt = _out_and_back(xs)
    frames = tsynth.render_frames(pts, poses_gt, INTR, (H, W), seed=2,
                                  sigma=(1.0, 1.8)).copy()
    frames[6:9] = 0.0
    state_on, ate_on = _loop_run(frames, poses_gt, _loop_cfg(
        history=24, lc_max_err=4.5, lc_min_gap=8))
    _, ate_off = _loop_run(frames, poses_gt, _loop_cfg(
        history=24, lc_min_inliers=10 ** 6))
    assert int(state_on.lc_ptr) >= 2, int(state_on.lc_ptr)
    assert ate_on < ate_off, (ate_on, ate_off)
