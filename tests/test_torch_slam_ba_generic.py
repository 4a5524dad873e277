"""Parity of the port's flat BA layout, ``tracks_from_flat``, the generic
tracks layout (kernel K9's plain version) and their index rule with
vpp_tpu's on the CPU, and the JAX package's production-scale gates on the
port.

Tolerances, each for float32 arithmetic in another order (the port sums the
landmark blocks in float64): LM costs rtol 1e-4 above float32's noise
floor (1e-6 of the first cost), poses atol 1e-4, landmarks atol 1e-3 (a
landmark's depth along a short baseline moves by more than its
reprojection); residuals and Jacobians within 1e-5 of their largest
magnitude (the port's analytic Jacobians against JAX's ``jacfwd``);
``tracks_from_flat`` bit-equal; the flat and tracks solvers against each
other at the JAX test's own rtol 1e-3 / atol 1e-5 (costs) and atol 1e-3
(states)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jse3 = importlib.import_module("vpp_tpu.slam.se3")
jba = importlib.import_module("vpp_tpu.slam.ba")
tba = importlib.import_module("vpp_tpu_torch.slam.ba")
tbg = importlib.import_module("vpp_tpu_torch.slam.ba_generic_cuda")
convert = importlib.import_module("vpp_tpu_torch.convert")

torch.set_num_threads(1)

INTR = np.array([300.0, 300.0, 160.0, 120.0], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(cls, j):
    return cls(*(_t(x) for x in j))


def _flat(m=4, n=60, seed=0, perturb=True):
    """tests/test_slam.py:25-70: m poses 0.3 apart, every pose observes
    every landmark, poses 0 and 1 fixed; ``perturb`` moves the free poses
    and every landmark as test_ba_recovers_from_perturbation does."""
    rng = np.random.RandomState(seed)
    xis = np.zeros((m, 6), np.float32)
    xis[:, 3] = -0.3 * np.arange(m)
    xis[:, :3] = rng.randn(m, 3) * 0.02
    poses = jse3.se3_exp(jnp.asarray(xis))
    lms = jnp.asarray(rng.rand(n, 3) * [2.0, 1.5, 1.0] + [-1.0, -0.75, 3.0],
                      jnp.float32)
    op = jnp.repeat(jnp.arange(m), n).astype(jnp.int32)
    ol = jnp.tile(jnp.arange(n), m).astype(jnp.int32)
    uv = jba.project(poses[op], lms[ol], jnp.asarray(INTR))
    fixed = jnp.zeros((m,), bool).at[0].set(True).at[1].set(True)
    if perturb:
        rng = np.random.RandomState(1)
        d = jnp.asarray(np.concatenate([np.zeros((2, 6)),
                                        rng.randn(m - 2, 6) * 0.02]),
                        jnp.float32)
        poses = jse3.se3_exp(d) @ poses
        lms = lms + jnp.asarray(rng.randn(n, 3) * 0.05, jnp.float32)
    return jba.BAProblem(poses=poses, landmarks=lms, obs_pose=op,
                         obs_lm=ol, obs_uv=uv,
                         obs_valid=jnp.ones((m * n,), bool),
                         intrinsics=jnp.asarray(INTR), fixed_poses=fixed)


def _tracks(m, n, k, seed=0, noise=0.0):
    """tests/test_slam_scale.py:13-40: each landmark observed by k
    consecutive poses of a rig stepping 0.1 in x, poses 0 and 1 fixed."""
    rng = np.random.RandomState(seed)
    xis = np.zeros((m, 6), np.float32)
    xis[:, 3] = -0.1
    xis[0] = 0.0
    for i in range(1, m):
        xis[i, :3] = rng.randn(3) * 0.01
    steps = np.asarray(jse3.se3_exp(jnp.asarray(xis)))
    poses = [np.eye(4, dtype=np.float32)]
    for i in range(1, m):
        poses.append(steps[i] @ poses[-1])
    poses = jnp.asarray(np.stack(poses))
    start = rng.randint(0, m - k + 1, size=n)
    lms = rng.rand(n, 3) * [2.0, 1.5, 1.0] + [-1.0, -0.75, 3.0]
    lms[:, 0] += 0.1 * start
    lms = jnp.asarray(lms, jnp.float32)
    obs_pose = jnp.asarray(start[:, None] + np.arange(k)[None], jnp.int32)
    uv = jba.project(poses[obs_pose], lms[:, None], jnp.asarray(INTR))
    uv = uv + jnp.asarray(rng.randn(n, k, 2) * noise, jnp.float32)
    fixed = jnp.zeros((m,), bool).at[0].set(True).at[1].set(True)
    return poses, lms, jba.BATracks(
        poses=poses, landmarks=lms, obs_pose=obs_pose, obs_uv=uv,
        obs_valid=jnp.ones((n, k), bool), intrinsics=jnp.asarray(INTR),
        fixed_poses=fixed)


def _same_lm(t, j, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol)


def _costs(tc, jc):
    jc = np.asarray(jc)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-4,
                               atol=1e-6 * float(np.nanmax(np.abs(jc))))


@pytest.mark.parametrize("case", ["perturbed", "masked", "landmarks"])
def test_flat_ba_solve_matches_jax(case):
    """tests/test_slam.py:51 (12 iterations from a perturbation), :72 (half
    the observations corrupted and masked) and :89's landmark-only
    perturbation."""
    if case == "masked":
        p = _flat(perturb=False)
        p = p._replace(obs_uv=p.obs_uv.at[::2].add(500.0),
                       obs_valid=p.obs_valid.at[::2].set(False))
        iters = 3
    elif case == "landmarks":
        p = _flat(n=64, perturb=False)
        rng = np.random.RandomState(2)
        p = p._replace(landmarks=p.landmarks + jnp.asarray(
            rng.randn(64, 3) * 0.05, jnp.float32))
        iters = 4
    else:
        p = _flat()
        iters = 12
    js, jc = jax.jit(lambda q: jba.ba_solve(q, iters=iters))(p)
    ts, tc = tba.ba_solve(_port(tba.BAProblem, p), iters=iters)
    if case == "masked":      # JAX's costs are 0, the port's float32 noise
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    else:
        _costs(tc, jc)
        assert float(tc[-1]) < float(tc[0]) * 1e-4
    np.testing.assert_allclose(ts.poses.numpy(), np.asarray(js.poses),
                               atol=1e-4)
    _same_lm(ts.landmarks, js.landmarks, 1e-3)


def test_flat_residuals_and_jacobians():
    p = _flat()
    tp = _port(tba.BAProblem, p)
    p2 = p._replace(obs_valid=p.obs_valid.at[::3].set(False))
    np.testing.assert_allclose(
        tba.reprojection_residuals(_port(tba.BAProblem, p2)).numpy(),
        np.asarray(jba.reprojection_residuals(p2)),
        atol=1e-5 * float(jnp.abs(jba.reprojection_residuals(p2)).max()))
    for t, j in zip(tba._obs_jacobians(tp), jba._obs_jacobians(p)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j,
                                   atol=1e-5 * float(np.abs(j).max()))
    r = np.asarray(jba.reprojection_residuals(p2))
    np.testing.assert_allclose(
        tba._huber_weight(_t(r), 4.0).numpy(),
        np.asarray(jba._huber_weight(jnp.asarray(r), 4.0)), rtol=1e-6)


def test_flat_guards():
    """The JAX package's 4 GB guard on the coupling tensor (checked before
    anything is allocated), the observation-sharded route (``mesh``: on a
    one-rank mesh the same bits as without one, O not divisible by the
    axis size refused), and ``iters=0``."""
    from vpp_tpu_torch.parallel import make_mesh
    m, n = 128, 2_000_000
    p = tba.BAProblem(
        poses=torch.eye(4).expand(m, 4, 4), landmarks=torch.zeros(n, 3),
        obs_pose=torch.zeros(1, dtype=torch.int32),
        obs_lm=torch.zeros(1, dtype=torch.int32), obs_uv=torch.zeros(1, 2),
        obs_valid=torch.ones(1, dtype=torch.bool),
        intrinsics=torch.from_numpy(INTR),
        fixed_poses=torch.zeros(m, dtype=torch.bool))
    with pytest.raises(ValueError, match="coupling"):
        tba.ba_solve(p, iters=1)
    tp = _port(tba.BAProblem, _flat())
    s0, c0 = tba.ba_solve(tp, iters=2)
    s1, c1 = tba.ba_solve(tp, iters=2, mesh=make_mesh((1,), ("obs",)))
    assert torch.equal(c0, c1) and torch.equal(s0.poses, s1.poses)
    assert torch.equal(s0.landmarks, s1.landmarks)

    class Axis:           # an axis of O + 1 ranks, seen from rank 0
        def size(self, name):
            return tp.obs_pose.shape[0] + 1

        def get_local_rank(self, name):
            return 0

    with pytest.raises(ValueError, match="shard"):
        tba.ba_solve(tp, iters=1, mesh=Axis())
    s, c = tba.ba_solve(tp, iters=0)
    assert tuple(c.shape) == (0,) and s is tp


@pytest.mark.parametrize("k_max", [None, 2, 7])
def test_tracks_from_flat_bit_equal(k_max):
    """Observations in a shuffled flat order with a quarter invalid, a cut
    at ``k_max``, landmarks with no observation: bit-equal to JAX."""
    rng = np.random.RandomState(11)
    p = _flat(m=5, n=40)
    o = p.obs_pose.shape[0]
    perm = rng.permutation(o)
    valid = rng.rand(o) > 0.25
    valid[np.asarray(p.obs_lm)[perm] == 7] = False       # an empty track
    p = p._replace(obs_pose=p.obs_pose[perm], obs_lm=p.obs_lm[perm],
                   obs_uv=p.obs_uv[perm] + jnp.asarray(
                       rng.randn(o, 2), jnp.float32),
                   obs_valid=jnp.asarray(valid))
    jt = jba.tracks_from_flat(p, k_max)
    tt = tba.tracks_from_flat(_port(tba.BAProblem, p), k_max)
    for name, j, t in zip(jt._fields, jt, tt):
        j = np.asarray(j)
        assert t.dtype == _t(j).dtype and tuple(t.shape) == j.shape, name
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)


def test_tracks_from_flat_index_rules():
    p = _flat(m=3, n=6)
    tp = _port(tba.BAProblem, p)
    neg = tp._replace(obs_lm=torch.where(tp.obs_lm == 5, -1, tp.obs_lm))
    jneg = p._replace(obs_lm=jnp.where(p.obs_lm == 5, -1, p.obs_lm))
    for j, t in zip(jba.tracks_from_flat(jneg, 3),
                    tba.tracks_from_flat(neg, 3)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    with pytest.raises(ValueError):
        tba.tracks_from_flat(neg)
    with pytest.raises(IndexError):
        tba.tracks_from_flat(tp._replace(obs_lm=tp.obs_lm + 1), 3)


def test_tracks_matches_flat_solver():
    """tests/test_slam_scale.py:42: the flat solver against the tracks
    solver on the converted problem, in the port and in JAX, and each port
    solver against its JAX counterpart."""
    rng = np.random.RandomState(1)
    m, n = 4, 48
    xis = np.zeros((m, 6), np.float32)
    xis[1:, 3] = -0.3
    steps = np.asarray(jse3.se3_exp(jnp.asarray(xis)))
    poses = [np.eye(4, dtype=np.float32)]
    for i in range(1, m):
        poses.append(steps[i] @ poses[-1])
    poses = jnp.asarray(np.stack(poses))
    lms = jnp.asarray(rng.rand(n, 3) + [-0.5, -0.5, 3.0], jnp.float32)
    op = jnp.repeat(jnp.arange(m), n).astype(jnp.int32)
    ol = jnp.tile(jnp.arange(n), m).astype(jnp.int32)
    uv = jba.project(poses[op], lms[ol], jnp.asarray(INTR))
    flat = jba.BAProblem(
        poses=poses, landmarks=lms + jnp.asarray(rng.randn(n, 3) * 0.03,
                                                 jnp.float32),
        obs_pose=op, obs_lm=ol, obs_uv=uv,
        obs_valid=jnp.ones((m * n,), bool), intrinsics=jnp.asarray(INTR),
        fixed_poses=jnp.zeros((m,), bool).at[0].set(True).at[1].set(True))
    tflat = _port(tba.BAProblem, flat)
    s1, c1 = tba.ba_solve(tflat, iters=5)
    s2, c2 = tba.ba_solve_tracks(tba.tracks_from_flat(tflat), iters=5)
    np.testing.assert_allclose(c1.numpy(), c2.numpy(), rtol=1e-3, atol=1e-5)
    for a, b in ((s1.landmarks, s2.landmarks), (s1.poses, s2.poses)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-3)
    j1, jc1 = jba.ba_solve(flat, iters=5)
    j2, jc2 = jba.ba_solve_tracks(jba.tracks_from_flat(flat), iters=5)
    for t, j in ((c1, jc1), (c2, jc2)):
        _costs(t, j)
    for t, j in ((s1, j1), (s2, j2)):
        np.testing.assert_allclose(t.poses.numpy(), np.asarray(j.poses),
                                   atol=1e-4)
        _same_lm(t.landmarks, j.landmarks, 1e-3)


def _generic(case, k=5, m=5, n=80, seed=3):
    """A generic-layout window: m poses 0.3 apart as in tests/test_slam.py,
    each landmark seen by k of them in a random order (obs_pose a random
    k-subset of the poses per row), 0.3 px of noise, the free poses and
    the landmarks perturbed. Cases: ``masked`` (slot 1 of every row thrown
    500 px and masked, test_slam_scale.py:122), ``repeated`` (slot 1 of
    every 3rd row names slot 0's pose: the pair lands on a diagonal block),
    ``unseen`` (four landmarks with no valid slot), ``nan_masked`` (a NaN
    measurement in a masked slot: the plain arithmetic's 0 * NaN makes the
    first cost NaN, so every step is rejected), ``subset`` (K < M)."""
    rng = np.random.RandomState(seed)
    xis = np.zeros((m, 6), np.float32)
    xis[:, 3] = -0.3 * np.arange(m)
    xis[:, :3] = rng.randn(m, 3) * 0.02
    poses = np.asarray(jse3.se3_exp(jnp.asarray(xis)))
    lms = (rng.rand(n, 3) * [2.0, 1.5, 1.0] + [-1.0, -0.75, 3.0]).astype(
        np.float32)
    op = np.stack([rng.permutation(m)[:k] for _ in range(n)]).astype(
        np.int32)
    valid = np.ones((n, k), bool)
    if case == "repeated":
        op[::3, 1] = op[::3, 0]
    uv = np.asarray(jba.project(jnp.asarray(poses)[op],
                                jnp.asarray(lms)[:, None],
                                jnp.asarray(INTR)))
    uv = (uv + rng.randn(n, k, 2) * 0.3).astype(np.float32)
    if case == "masked":
        uv[:, 1] += 500.0
        valid[:, 1] = False
    elif case == "unseen":
        valid[10:14] = False
    elif case == "nan_masked":
        uv[5, 1] = np.nan
        valid[5, 1] = False
    fixed = np.zeros(m, bool)
    fixed[:2] = True
    d = np.concatenate([np.zeros((2, 6)), rng.randn(m - 2, 6) * 0.02])
    poses = np.asarray(jse3.se3_exp(jnp.asarray(d, jnp.float32))) @ poses
    lms = (lms + rng.randn(n, 3) * 0.05).astype(np.float32)
    return jba.BATracks(
        poses=jnp.asarray(poses), landmarks=jnp.asarray(lms),
        obs_pose=jnp.asarray(op), obs_uv=jnp.asarray(uv),
        obs_valid=jnp.asarray(valid), intrinsics=jnp.asarray(INTR),
        fixed_poses=jnp.asarray(fixed))


@pytest.mark.parametrize("linalg", ["lu", "chol"])
@pytest.mark.parametrize("case", ["masked", "repeated", "unseen",
                                  "nan_masked", "subset"])
def test_generic_layout_matches_jax(case, linalg):
    p = _generic(case, k=3 if case in ("unseen", "subset") else 5)
    js, jc = jax.jit(lambda q: jba.ba_solve_tracks(
        q, iters=4, linalg=linalg))(p)
    ts, tc = tba.ba_solve_tracks(_port(tba.BATracks, p), iters=4,
                                 linalg=linalg)
    if case == "nan_masked":
        assert bool(torch.isnan(tc).all()) and bool(np.isnan(jc).all())
        np.testing.assert_array_equal(ts.poses.numpy(), np.asarray(p.poses))
        np.testing.assert_array_equal(ts.landmarks.numpy(),
                                      np.asarray(p.landmarks))
        return
    _costs(tc, jc)
    assert float(tc[-1]) < float(tc[0])
    np.testing.assert_allclose(ts.poses.numpy(), np.asarray(js.poses),
                               atol=1e-4)
    _same_lm(ts.landmarks, js.landmarks, 1e-3)


@pytest.mark.parametrize("layout", ["tracks", "flat"])
def test_out_of_range_pose_index_matches_jax(layout):
    """One valid slot names pose M and one pose -1: JAX's gather clamps M
    to M - 1 and wraps -1 to M - 1; its scatter-adds drop M and wrap -1.
    The port follows both rules on both layouts (and drops an obs_lm of N
    in the flat scatters while its gather clamps it)."""
    p = _generic("plain")
    m = 5
    if layout == "tracks":
        p = p._replace(obs_pose=p.obs_pose.at[3, 0].set(m)
                       .at[9, 2].set(-1))
        js, jc = jba.ba_solve_tracks(p, iters=3)
        ts, tc = tba.ba_solve_tracks(_port(tba.BATracks, p), iters=3)
    else:
        n, k = p.obs_pose.shape
        flat = jba.BAProblem(
            poses=p.poses, landmarks=p.landmarks,
            obs_pose=p.obs_pose.reshape(-1).at[7].set(m).at[40].set(-1),
            obs_lm=jnp.repeat(jnp.arange(n, dtype=jnp.int32), k)
            .at[17].set(n), obs_uv=p.obs_uv.reshape(-1, 2),
            obs_valid=p.obs_valid.reshape(-1), intrinsics=p.intrinsics,
            fixed_poses=p.fixed_poses)
        js, jc = jba.ba_solve(flat, iters=3)
        ts, tc = tba.ba_solve(_port(tba.BAProblem, flat), iters=3)
    _costs(tc, jc)
    np.testing.assert_allclose(ts.poses.numpy(), np.asarray(js.poses),
                               atol=1e-4)
    _same_lm(ts.landmarks, js.landmarks, 1e-3)


@pytest.mark.parametrize("linalg", ["lu", "chol"])
def test_generic_layout_production_scale_gates(linalg):
    """tests/test_slam_scale.py:78's recipe (N 10240, M 128, K 4, 5
    iterations, lam0 1e-4) through the port's plain path, held to that
    test's own gates: the JAX package misses them (its float32 landmark
    algebra), the port's float64 landmark blocks meet them."""
    rng = np.random.RandomState(2)
    m, n, k = 128, 10240, 4
    _, lms_gt, p = _tracks(m, n, k)
    p = p._replace(landmarks=p.landmarks + jnp.asarray(
        rng.randn(n, 3) * 0.03, jnp.float32))
    ts, tc = tba.ba_solve_tracks(_port(tba.BATracks, p), iters=5, lam0=1e-4,
                                 linalg=linalg)
    costs = tc.numpy()
    assert costs[-1] < costs[0] * 1e-4, costs
    err = np.abs(ts.landmarks.numpy() - np.asarray(lms_gt))
    assert np.median(err) < 1e-2, np.median(err)


def test_generic_layout_guards():
    _, _, p = _tracks(8, 16, 3)
    tp = _port(tba.BATracks, p)
    streams = tba.BATracks(*(t if i == 5 else t[None].expand(
        (2,) + t.shape) for i, t in enumerate(tp)))
    with pytest.raises(NotImplementedError):
        tba.ba_solve_tracks(streams, iters=1)
    s, c = tba.ba_solve_tracks(tp, iters=0)
    assert tuple(c.shape) == (0,) and s is tp


@pytest.mark.parametrize("linalg", ["lu", "chol"])
def test_ring_of_twenty_down_the_generic_layout(linalg):
    """A ring problem of M = 20 poses (more than K6's 16), the route the
    card takes for it: ``ring_layout=False`` with ``obs_pose = arange(M)``
    on every row against ``ring_layout=True``, both on the plain path and
    held to JAX's ring solve, at this file's tolerances."""
    m, n = 20, 160
    rng = np.random.RandomState(6)
    p = _generic("plain", k=m, m=m, n=n, seed=6)
    valid = rng.rand(n, m) > 0.4
    ring = p._replace(obs_pose=jnp.broadcast_to(
        jnp.arange(m, dtype=jnp.int32), (n, m)),
        obs_uv=jba.project(p.poses[None], p.landmarks[:, None],
                           p.intrinsics) + jnp.asarray(
                               rng.randn(n, m, 2) * 0.3, jnp.float32),
        obs_valid=jnp.asarray(valid))
    tp = _port(tba.BATracks, ring)
    ts, tc = tba.ba_solve_tracks(tp, iters=4, lam0=1e-4, ring_layout=True,
                                 linalg=linalg)
    gs, gc = tba.ba_solve_tracks(tp, iters=4, lam0=1e-4, ring_layout=False,
                                 linalg=linalg)
    _costs(gc, tc.numpy())
    assert float(gc[-1]) < float(gc[0])
    np.testing.assert_allclose(gs.poses.numpy(), ts.poses.numpy(),
                               atol=1e-4)
    _same_lm(gs.landmarks, ts.landmarks, 1e-3)
    js, jc = jax.jit(lambda q: jba.ba_solve_tracks(
        q, iters=4, lam0=1e-4, ring_layout=True, linalg=linalg))(ring)
    _costs(tc, jc)
    np.testing.assert_allclose(ts.poses.numpy(), np.asarray(js.poses),
                               atol=1e-4)
    _same_lm(ts.landmarks, js.landmarks, 1e-3)


def test_slam_run_ring_of_twenty_matches_jax():
    """``SlamConfig(ring=20)`` (a BA window of more poses than K6 takes,
    which the card sends to K9) on tests/test_pipeline.py's 120x160 scene,
    25 frames, the port on the CPU against the JAX package: the same
    keyframes, ATE within 0.01 of each other
    (tests/test_torch_slam_pipeline.py's tolerance; that test's bound of
    0.065 is for ring 6, and the JAX package reads 0.078 here), the
    keyframe poses within 1e-3 and live landmark counts within 5%."""
    from vpp_tpu.algorithms.video_extruder import VideoExtruderConfig as JV
    from vpp_tpu_torch.algorithms.video_extruder import (
        VideoExtruderConfig as TV)
    from vpp_tpu_torch.utils import synth as tsynth
    jp = importlib.import_module("vpp_tpu.slam.pipeline")
    tpl = importlib.import_module("vpp_tpu_torch.slam.pipeline")
    intr = (160.0, 160.0, 80.0, 60.0)
    tracker = dict(capacity=256, detect_k=128, nscales=3, winsize=9,
                   keypoint_spacing=8, detector_period=1, detector_th=8)
    back = dict(intrinsics=intr, keyframe_period=4, ring=20, ba_iters=3,
                min_parallax=2.0, max_reproj=2.0, history=16,
                enable_recovery=False)
    pts = tsynth.make_cloud(220, seed=0, extent=(6.0, 4.0, 3.0),
                            center=(0.8, 0.0, 5.0))
    poses = tsynth.camera_path(25, step=(0.06, 0.0, 0.0))
    frames = tsynth.render_frames(pts, poses, intr, (120, 160), seed=0)
    boot = poses[[0, 4]]
    jcfg = jp.SlamConfig(tracker=JV(**tracker), **back)
    tcfg = tpl.SlamConfig(tracker=TV(**tracker), **back)
    js = jax.jit(lambda f, b: jp.slam_run(f, jcfg, bootstrap_poses=b))(
        jnp.asarray(frames), jnp.asarray(boot))
    ts = tpl.slam_run(frames, tcfg, bootstrap_poses=boot, device="cpu")
    je, jf = jp.keyframe_trajectory(js)
    te, tf = tpl.keyframe_trajectory(ts)
    assert ts.n_keyframes == int(js.n_keyframes) == 7
    assert tuple(ts.kf_pose.shape) == (20, 4, 4)
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    ate_j = float(jp.ate_rmse(je, jnp.asarray(poses[np.asarray(jf)])))
    ate_t = float(tpl.ate_rmse(te, torch.from_numpy(poses[tf.numpy()])))
    assert abs(ate_j - ate_t) < 0.01, (ate_j, ate_t)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-3)
    lj, lt = int(np.asarray(js.lm_valid).sum()), int(ts.lm_valid.sum())
    assert abs(lj - lt) <= 0.05 * lj, (lj, lt)


# (m, beta, linalg, smem, routes): today's sizes on the H100 keep their
# routes; past 512 poses and at a full band the stages leave shared memory
# one by one; a budget of 256 bytes sends every stage to the workspace
K9_ROUTES = [
    (128, 3, "lu", None, ("shared", "shared", "shared", "cta")),
    (128, 3, "chol", None, ("shared", "shared", "shared", "cta")),
    (512, 3, "lu", None, ("shared", "shared", "shared", "grid")),
    (512, 511, "chol", None, ("shared", "shared", "shared", "grid")),
    (40, 32, "lu", None, ("shared", "shared", "shared", "grid")),
    (1024, 47, "lu", None, ("shared", "shared", "shared", "grid")),
    (1612, 1611, "lu", None, ("shared", "shared", "shared", "grid")),
    (2048, 2047, "chol", None, ("shared", "shared", "shared",
                                "grid_device")),
    (3072, 3, "lu", None, ("shared", "shared", "device", "grid")),
    (4000, 3, "chol", None, ("shared", "device", "device", "grid")),
    (7000, 3, "lu", None, ("device", "device", "device", "grid")),
    (24, 3, "lu", 128 + 256, ("device", "device", "device", "grid_device")),
    (24, 3, "lu", 128 + 2048, ("shared", "shared", "device", "grid")),
]


@pytest.mark.parametrize("m,beta,linalg,smem,want", K9_ROUTES)
def test_k9_routes_by_size(m, beta, linalg, smem, want):
    """The route of each K9 stage at a pose count, where the card's
    512-pose cap raised before (``ba_generic_cuda.k9_routes``, the
    kernel's ``routes_of``): the index's counts, the landmark stage's
    poses and the step's dp and candidates in shared memory while they fit
    a CTA's budget, the pose solve by CTA 0 while the band fits, else by
    the grid with its panel in shared memory, else in the workspace."""
    kw = {} if smem is None else {"smem": smem}
    got = tbg.k9_routes(m, beta, linalg, **kw)
    assert tuple(got[s] for s in ("index", "landmarks", "step",
                                  "solve")) == want


def test_slam_run_ring_of_48_matches_jax():
    """``SlamConfig(ring=48)`` (a BA window past K9's old 32 slots a
    landmark, which the card now runs on K9) on the 120x160 scene of
    ``test_slam_run_ring_of_twenty_matches_jax``, 25 frames, the port on the
    CPU against the JAX package at that test's tolerances: the same
    keyframes, ATE within 0.01 of each other, the keyframe poses within
    1e-3 and live landmark counts within 5%."""
    from vpp_tpu.algorithms.video_extruder import VideoExtruderConfig as JV
    from vpp_tpu_torch.algorithms.video_extruder import (
        VideoExtruderConfig as TV)
    from vpp_tpu_torch.utils import synth as tsynth
    jp = importlib.import_module("vpp_tpu.slam.pipeline")
    tpl = importlib.import_module("vpp_tpu_torch.slam.pipeline")
    intr = (160.0, 160.0, 80.0, 60.0)
    tracker = dict(capacity=256, detect_k=128, nscales=3, winsize=9,
                   keypoint_spacing=8, detector_period=1, detector_th=8)
    back = dict(intrinsics=intr, keyframe_period=4, ring=48, ba_iters=3,
                min_parallax=2.0, max_reproj=2.0, history=16,
                enable_recovery=False)
    pts = tsynth.make_cloud(220, seed=0, extent=(6.0, 4.0, 3.0),
                            center=(0.8, 0.0, 5.0))
    poses = tsynth.camera_path(25, step=(0.06, 0.0, 0.0))
    frames = tsynth.render_frames(pts, poses, intr, (120, 160), seed=0)
    boot = poses[[0, 4]]
    jcfg = jp.SlamConfig(tracker=JV(**tracker), **back)
    tcfg = tpl.SlamConfig(tracker=TV(**tracker), **back)
    js = jax.jit(lambda f, b: jp.slam_run(f, jcfg, bootstrap_poses=b))(
        jnp.asarray(frames), jnp.asarray(boot))
    ts = tpl.slam_run(frames, tcfg, bootstrap_poses=boot, device="cpu")
    je, jf = jp.keyframe_trajectory(js)
    te, tf = tpl.keyframe_trajectory(ts)
    assert ts.n_keyframes == int(js.n_keyframes) == 7
    assert tuple(ts.kf_pose.shape) == (48, 4, 4)
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    ate_j = float(jp.ate_rmse(je, jnp.asarray(poses[np.asarray(jf)])))
    ate_t = float(tpl.ate_rmse(te, torch.from_numpy(poses[tf.numpy()])))
    assert abs(ate_j - ate_t) < 0.01, (ate_j, ate_t)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-3)
    lj, lt = int(np.asarray(js.lm_valid).sum()), int(ts.lm_valid.sum())
    assert abs(lj - lt) <= 0.05 * lj, (lj, lt)


@pytest.mark.parametrize("kind", ["flat", "tracks"])
def test_convert_ba_problems_round_trip(kind):
    """A JAX ``BAProblem``/``BATracks`` crosses over through numpy
    mappings and back, bit-equal, dtypes kept."""
    if kind == "flat":
        j, cls = _flat(), tba.BAProblem
        got = convert.ba_problem_from_numpy(
            {f: np.asarray(getattr(j, f)) for f in j._fields}, device="cpu")
    else:
        j, cls = _tracks(8, 16, 3)[2], tba.BATracks
        got = convert.ba_tracks_from_numpy(
            {f: np.asarray(getattr(j, f)) for f in j._fields}, device="cpu")
    assert isinstance(got, cls)
    back = convert.state_to_numpy(got)
    for f in j._fields:
        want = np.asarray(getattr(j, f))
        assert back[f].dtype == want.dtype
        np.testing.assert_array_equal(back[f], want)
