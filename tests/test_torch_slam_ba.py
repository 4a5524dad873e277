"""Parity of the port's SE(3) maps, window BA (kernel K6's plain
versions), triangulation and PnP with vpp_tpu's on the CPU.

Tolerances, each for float32 arithmetic in another order: SE(3) maps atol
1e-5; projection Jacobians rtol 1e-5; the Schur assembly's S and cost rtol
1e-4 of their largest magnitude, rhs within 1e-4 of the magnitude of its
terms (rhs = bp - sum W bl cancels two sums far larger than itself), the
landmark-local Hll_inv, bl and U rtol 1e-5 of their largest magnitude; LM
solves poses atol 1e-4 and costs rtol 1e-4 above float32's noise floor
(1e-6 of the first cost); triangulation rtol 1e-4; PnP atol 1e-4."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jse3 = importlib.import_module("vpp_tpu.slam.se3")
tse3 = importlib.import_module("vpp_tpu_torch.slam.se3")
jba = importlib.import_module("vpp_tpu.slam.ba")
tba = importlib.import_module("vpp_tpu_torch.slam.ba")
jgeo = importlib.import_module("vpp_tpu.algorithms.geometry")
tgeo = importlib.import_module("vpp_tpu_torch.algorithms.geometry")
jpipe = importlib.import_module("vpp_tpu.slam.pipeline")
tpipe = importlib.import_module("vpp_tpu_torch.slam.pipeline")

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close_rel(t, j, rtol):
    t, j = t.numpy(), np.asarray(j)
    scale = max(float(np.abs(j).max()), 1e-30)
    assert float(np.abs(t - j).max()) <= rtol * scale, (
        float(np.abs(t - j).max()) / scale)


@pytest.mark.parametrize("scale", [1e-5, 0.02, 0.5, 1.0])
def test_se3_maps(scale):
    rng = np.random.RandomState(int(scale * 100))
    xi = (rng.randn(16, 6) * scale).astype(np.float32)
    jT = jse3.se3_exp(jnp.asarray(xi))
    tT = tse3.se3_exp(_t(xi))
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-5)
    np.testing.assert_allclose(tse3.se3_log(tT).numpy(),
                               np.asarray(jse3.se3_log(jT)), atol=1e-5)
    np.testing.assert_allclose(tse3.se3_inverse(tT).numpy(),
                               np.asarray(jse3.se3_inverse(jT)), atol=1e-5)
    w = xi[:, :3]
    np.testing.assert_allclose(tse3.so3_exp(_t(w)).numpy(),
                               np.asarray(jse3.so3_exp(jnp.asarray(w))),
                               atol=1e-5)
    np.testing.assert_allclose(
        tse3.so3_log(tT[:, :3, :3]).numpy(),
        np.asarray(jse3.so3_log(jT[:, :3, :3])), atol=1e-5)
    X = rng.randn(16, 3).astype(np.float32)
    np.testing.assert_allclose(
        tse3.se3_apply(tT, _t(X)).numpy(),
        np.asarray(jse3.se3_apply(jT, jnp.asarray(X))), atol=1e-5)
    np.testing.assert_allclose(
        tse3.se3_compose(tT, tT).numpy(),
        np.asarray(jse3.se3_compose(jT, jT)), atol=1e-5)


def test_proj_jacobians_and_project():
    rng = np.random.RandomState(3)
    xi = (rng.randn(8, 6) * 0.1).astype(np.float32)
    T = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    X = (rng.rand(8, 3) * [2, 2, 1] + [-1, -1, 3]).astype(np.float32)
    X[0, 2] = -T[0, 2, 3] - 1e-8            # the |z| < 1e-6 clamp
    intr = np.array([300.0, 310.0, 160.0, 120.0], np.float32)
    for j, t in zip(jba.proj_jacobians(jnp.asarray(T), jnp.asarray(X),
                                       jnp.asarray(intr)),
                    tba.proj_jacobians(_t(T), _t(X), _t(intr))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(j).max()))
    np.testing.assert_allclose(
        tba.project(_t(T), _t(X), _t(intr)).numpy(),
        np.asarray(jba.project(jnp.asarray(T), jnp.asarray(X),
                               jnp.asarray(intr))), rtol=1e-5)


def _synthetic_tracks(m=4, n=60, noise=0.0, seed=0, perturb="all"):
    """tests/test_slam.py:25-98: m poses 0.3 apart, n landmarks, every pose
    observes every landmark (obs_pose[l, j] == j), poses 0 and 1 fixed;
    ``perturb="all"`` moves the free poses and all landmarks as
    test_ba_recovers_from_perturbation does, ``"landmarks"`` only the
    landmarks, as test_ba_sharded_matches_single_device does."""
    rng = np.random.RandomState(seed)
    intr = np.array([300.0, 300.0, 160.0, 120.0], np.float32)
    xis = np.zeros((m, 6), np.float32)
    xis[:, 3] = -0.3 * np.arange(m)
    xis[:, :3] = rng.randn(m, 3) * 0.02
    poses = np.asarray(jse3.se3_exp(jnp.asarray(xis)))
    lms = (rng.rand(n, 3) * [2.0, 1.5, 1.0] + [-1.0, -0.75, 3.0]).astype(
        np.float32)
    uv = np.asarray(jba.project(jnp.asarray(poses)[None],
                                jnp.asarray(lms)[:, None],
                                jnp.asarray(intr)))
    uv = (uv + rng.randn(n, m, 2) * noise).astype(np.float32)
    fixed = np.zeros(m, bool)
    fixed[:2] = True
    if perturb == "all":
        rng = np.random.RandomState(1)
        d = np.concatenate([np.zeros((2, 6)),
                            rng.randn(m - 2, 6) * 0.02]).astype(np.float32)
        poses = np.asarray(jse3.se3_exp(jnp.asarray(d))) @ poses
        lms = (lms + rng.randn(n, 3) * 0.05).astype(np.float32)
    elif perturb == "landmarks":
        rng = np.random.RandomState(2)
        lms = (lms + rng.randn(n, 3) * 0.05).astype(np.float32)
    valid = np.ones((n, m), bool)
    valid[::7, 1] = False
    return dict(poses=poses.astype(np.float32), landmarks=lms,
                obs_pose=np.tile(np.arange(m, dtype=np.int32), (n, 1)),
                obs_uv=uv, obs_valid=valid, intrinsics=intr,
                fixed_poses=fixed)


def _both(prob):
    return (jba.BATracks(**{k: jnp.asarray(v) for k, v in prob.items()}),
            tba.BATracks(**{k: _t(v) for k, v in prob.items()}))


@pytest.mark.parametrize("linalg", ["chol", "lu"])
@pytest.mark.parametrize("ring", [True, False])
def test_tracks_assemble(linalg, ring):
    prob = _synthetic_tracks(m=5, n=80, noise=0.8, seed=2)
    jp, tp = _both(prob)
    (jS, jr, jc), jloc = jba._tracks_assemble(jp, 1e-3, 4.0, ring, linalg)
    (tS, tr, tc), tloc = tba._tracks_assemble(tp, torch.tensor(1e-3), 4.0,
                                              ring, linalg)
    _close_rel(tS, jS, 1e-4)
    _close_rel(tc, jc, 1e-4)
    assert float((tr - _t(jr)).abs().max()) <= 1e-4 * tba.rhs_term_scale(
        tp, 4.0, True)
    for t, j in zip(tloc[:3], jloc[:3]):
        _close_rel(t, j, 1e-5)
    np.testing.assert_array_equal(tloc[4].numpy(), np.asarray(jloc[4]))


@pytest.mark.parametrize("linalg", ["chol", "lu"])
@pytest.mark.parametrize("case", ["perturbed", "landmarks", "masked",
                                  "ring16", "rejected", "failed"])
def test_ba_solve_tracks(linalg, case):
    """The problems of tests/test_slam.py:51-98 in the tracks layout, a
    ring of M = 16 poses (the card's ``MAX_POSES``), and the LM loop's two
    other branches: every step rejected (landmarks thrown 2 units off, some
    behind the cameras: each candidate's cost is larger), and the pose
    factorisation failing (no damping and no observation of free pose 2:
    S has a zero row and column, so dp is NaN and the step is rejected).
    Costs are compared down to float32's noise floor of the first cost."""
    iters, lam0 = 6, 1e-3
    if case == "landmarks":
        prob = _synthetic_tracks(n=64, perturb="landmarks")
    elif case == "ring16":
        prob = _synthetic_tracks(m=16, n=96)
    else:
        prob = _synthetic_tracks()
    if case == "masked":
        prob["obs_uv"][::2, 2] += 500.0
        prob["obs_valid"][::2, 2] = False
    elif case == "rejected":
        rng = np.random.RandomState(5)
        prob["landmarks"] = (prob["landmarks"] + rng.randn(
            *prob["landmarks"].shape) * 2.0).astype(np.float32)
        iters = 3
    elif case == "failed":
        prob["obs_valid"][:, 2] = False
        iters, lam0 = 3, 0.0
    jp, tp = _both(prob)
    js, jc = jax.jit(lambda p: jba.ba_solve_tracks(
        p, iters=iters, lam0=lam0, ring_layout=True, linalg=linalg))(jp)
    ts, tc = tba.ba_solve_tracks(tp, iters=iters, lam0=lam0,
                                 ring_layout=True, linalg=linalg)
    np.testing.assert_allclose(ts.poses.numpy(), np.asarray(js.poses),
                               atol=1e-4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-6 * float(jc[0]))
    if case in ("perturbed", "ring16"):
        assert float(tc[-1]) < float(tc[0]) * 1e-3
    if case in ("rejected", "failed"):
        # every step rejected: the costs hold the first cost, nothing moves
        c0 = float(tba._tracks_cost(tp, 4.0, True))
        np.testing.assert_allclose(tc.numpy(), c0, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(jc), c0, rtol=1e-6)
        assert torch.equal(ts.poses, tp.poses)
        assert torch.equal(ts.landmarks, tp.landmarks)
        lam = torch.full((), lam0)
        (S, rhs, _), _ = tba._tracks_assemble(tp, lam, 4.0, True, linalg)
        dp = tba._tracks_solve_poses(S, rhs, tp.fixed_poses, lam, linalg)
        assert bool(torch.isnan(dp).all()) == (case == "failed")
    # the generic layout takes the same steps
    gs, gc = tba.ba_solve_tracks(tp, iters=iters, lam0=lam0, linalg=linalg)
    np.testing.assert_allclose(gs.poses.numpy(), ts.poses.numpy(), atol=1e-4)


@pytest.mark.parametrize("ring", [True, False])
def test_ba_solve_tracks_zero_iterations(ring):
    """``iters=0``: the JAX package's ``lax.scan(length=0)`` returns the
    problem unchanged and costs of shape (0,); so does the port, on the
    ring and on the generic layout (observation columns reversed)."""
    prob = _synthetic_tracks()
    if not ring:
        for k in ("obs_pose", "obs_uv", "obs_valid"):
            prob[k] = np.ascontiguousarray(prob[k][:, ::-1])
    jp, tp = _both(prob)
    js, jc = jax.jit(lambda p: jba.ba_solve_tracks(
        p, iters=0, ring_layout=ring))(jp)
    ts, tc = tba.ba_solve_tracks(tp, iters=0, ring_layout=ring)
    assert tuple(tc.shape) == np.asarray(jc).shape == (0,)
    assert tc.dtype == torch.float32
    for name in ("poses", "landmarks"):
        assert torch.equal(getattr(ts, name), getattr(tp, name))
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))


def test_ba_solve_tracks_guards():
    _, tp = _both(_synthetic_tracks())
    with pytest.raises(NotImplementedError):
        tba.ba_solve_tracks(tp, iters=1, mesh=object())
    with pytest.raises(ValueError):
        tba.ba_solve_tracks(tp._replace(obs_pose=tp.obs_pose[:, :3],
                                        obs_uv=tp.obs_uv[:, :3],
                                        obs_valid=tp.obs_valid[:, :3]),
                            iters=1, ring_layout=True)


def test_triangulate_ls():
    rng = np.random.RandomState(4)
    n = 50
    X = (rng.rand(n, 3) * [4, 3, 2] + [-2, -1.5, 4]).astype(np.float32)
    intr = jnp.asarray([320.0, 320.0, 160.0, 120.0])
    T1 = np.asarray(jse3.se3_exp(jnp.asarray(
        rng.randn(n, 6).astype(np.float32) * 0.02)))
    T2 = np.asarray(jse3.se3_exp(jnp.asarray([0.01, 0.02, 0.0, -0.6, 0.1,
                                              0.0], jnp.float32)))
    P1 = np.asarray(jax.vmap(lambda T: jpipe._projection_matrix(T, intr))(
        jnp.asarray(T1)))
    P2 = np.asarray(jpipe._projection_matrix(jnp.asarray(T2), intr))
    x1 = np.asarray(jba.project(jnp.asarray(T1), jnp.asarray(X), intr))[
        :, ::-1] + rng.randn(n, 2).astype(np.float32) * 0.1
    x2 = np.asarray(jba.project(jnp.asarray(T2)[None], jnp.asarray(X),
                                intr))[:, ::-1]
    x1 = np.ascontiguousarray(x1, np.float32)
    x2 = np.ascontiguousarray(x2, np.float32)
    j = jgeo.triangulate_ls(jnp.asarray(P1), jnp.asarray(P2),
                            jnp.asarray(x1), jnp.asarray(x2))
    t = tgeo.triangulate_ls(_t(P1), _t(P2), _t(x1), _t(x2))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4)
    tP = tpipe._projection_matrix(_t(T1), _t(np.asarray(intr)))
    np.testing.assert_allclose(tP.numpy(), P1, rtol=1e-6)


def test_pnp_gn_recovers_pose():
    """tests/test_pipeline.py:40."""
    rng = np.random.RandomState(0)
    intr = np.asarray([160.0, 160.0, 80.0, 60.0], np.float32)
    X = (rng.rand(64, 3) * [2, 2, 1] + [-1, -1, 4]).astype(np.float32)
    xi = np.asarray([0.02, -0.03, 0.01, 0.1, -0.05, 0.02], np.float32)
    T_gt = jse3.se3_exp(jnp.asarray(xi))
    uv = np.asarray(jba.project(T_gt[None], jnp.asarray(X),
                                jnp.asarray(intr)))
    valid = np.ones(64, bool)
    valid[::5] = False
    jT, jerr = jpipe.pnp_gn(jnp.eye(4), jnp.asarray(X), jnp.asarray(uv),
                            jnp.asarray(valid), jnp.asarray(intr), iters=8)
    tT, terr = tpipe.pnp_gn(torch.eye(4), _t(X), _t(uv), _t(valid),
                            _t(intr), iters=8)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-4)
    np.testing.assert_allclose(tT.numpy(), np.asarray(T_gt), atol=1e-4)
    assert float(terr) < 1e-3 and abs(float(terr) - float(jerr)) < 1e-4


def test_chol_solve_nan_where_not_positive_definite():
    A = torch.tensor([[[4.0, 1.0], [1.0, 3.0]], [[1.0, 2.0], [2.0, 1.0]]])
    x = tba.chol_solve(A, torch.ones(2, 2))
    assert bool(torch.isfinite(x[0]).all()) and bool(torch.isnan(x[1]).all())
    np.testing.assert_allclose((A[0] @ x[0]).numpy(), [1.0, 1.0], rtol=1e-6)
