"""The port's sharded BA and ``slam_run(mesh=)`` on an 8-rank gloo group on
the CPU, against the port's single-device solves and the JAX package's
sharded ones on its 8-device CPU mesh.

Problems are the JAX tests': tests/test_slam.py:82's flat problem over 4
"obs" ranks; tests/test_slam_scale.py:100's generic tracks problem (M 16, N
1024, K 4) over 8 "lm" ranks, with both ``linalg`` choices, and
the flat problem's recipe in the ring layout (M 4, N 64); and
``__graft_entry__.dryrun_multichip``'s small ``slam_run`` with its window BA
over 4 "lm" ranks. Tolerances are the JAX package's own for its sharded BA
(test_slam_scale.py:114-119): costs rtol 1e-3 with atol 1e-5, poses and
landmarks atol 1e-3. Every rank returns the same bits.

The tracks BA's costs are held to JAX's sharded solve run in float64
(``jax.enable_x64``): on the generic problem JAX's float32 first cost moves
by ~4e-3 relative with the rounding of its landmark inverses (4.3842 sharded,
4.3988 with LU), while the float64 solve and the port, whose landmark blocks
are float64, agree to ~1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import torch_spmd as S
import torch_spmd_slam as C
from test_slam import _synthetic_ba
from test_slam_scale import _synthetic_tracks
from test_torch_slam_ba import _synthetic_tracks as _ring_tracks

jba = importlib.import_module("vpp_tpu.slam.ba")
jpipe = importlib.import_module("vpp_tpu.slam.pipeline")
jve = importlib.import_module("vpp_tpu.algorithms.video_extruder")
tba = importlib.import_module("vpp_tpu_torch.slam.ba")
tpipe = importlib.import_module("vpp_tpu_torch.slam.pipeline")

TOL = dict(cost_rtol=1e-3, cost_atol=1e-5, atol=1e-3)


def _np(prob):
    return {k: np.asarray(v) for k, v in prob._asdict().items()}


def _flat_problem():
    rng = np.random.RandomState(2)
    _, _, prob = _synthetic_ba(m=4, n=64)
    lms0 = prob.landmarks + jnp.asarray(
        rng.randn(*prob.landmarks.shape) * 0.05, jnp.float32)
    return prob._replace(landmarks=lms0)


def _generic_problem():
    rng = np.random.RandomState(3)
    _, _, prob = _synthetic_tracks(16, 1024, 4, seed=4)
    return prob._replace(landmarks=prob.landmarks + jnp.asarray(
        rng.randn(1024, 3) * 0.03, jnp.float32))


def _ring_problem():
    """tests/test_slam.py:82's problem in the ring layout (every pose sees
    every landmark; test_torch_slam_ba.py's recipe), N 64 for 8 ranks."""
    return jba.BATracks(**{k: jnp.asarray(v) for k, v in _ring_tracks(
        m=4, n=64, perturb="landmarks").items()})


@pytest.fixture(scope="module")
def problems():
    return {"flat": _flat_problem(), "generic": _generic_problem(),
            "ring": _ring_problem()}


@pytest.fixture(scope="module")
def ranks(problems):
    payload = {k: _np(v) for k, v in problems.items()}
    return S.run_group(8, "torch_spmd_slam", ["flat", "tracks", "slam"],
                       payload=payload)


def _same_on_ranks(ranks, name, n):
    """Rank 0's result, after checking ranks 1..n-1 return the same bits and
    the ranks past n (outside the case's mesh) None."""
    def flat(x):
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in flat(x[k])]
        return [np.asarray(x)]
    first = flat(ranks[0][name])
    for r in range(1, len(ranks)):
        if r >= n:
            assert ranks[r][name] is None
            continue
        for a, b in zip(first, flat(ranks[r][name])):
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, r)
    return ranks[0][name]


def _close(got, poses, landmarks, costs):
    np.testing.assert_allclose(got["costs"], np.asarray(costs),
                               rtol=TOL["cost_rtol"], atol=TOL["cost_atol"])
    np.testing.assert_allclose(got["landmarks"], np.asarray(landmarks),
                               atol=TOL["atol"])
    np.testing.assert_allclose(got["poses"], np.asarray(poses),
                               atol=TOL["atol"])


def _jax_costs_x64(prob, mesh, **kw):
    """JAX's sharded ``ba_solve_tracks`` on float64 copies of ``prob`` on
    ``mesh``: its costs, as numpy. x64 is on only inside the call."""
    with jax.enable_x64(True):
        p64 = prob._replace(**{
            k: jnp.asarray(np.asarray(v, np.float64)
                           if np.asarray(v).dtype == np.float32
                           else np.asarray(v))
            for k, v in prob._asdict().items()})
        _, c = jax.jit(lambda p: jba.ba_solve_tracks(
            p, mesh=mesh, axis="lm", **kw))(p64)
        return np.asarray(c)


def _port(cls, prob):
    return cls(**{k: torch.from_numpy(np.array(v))
                  for k, v in prob._asdict().items()})


def test_flat_ba_sharded(ranks, problems):
    """``ba_solve`` over 4 "obs" ranks (a 4-rank mesh of the 8) against the
    port's single-device solve and JAX's sharded solve."""
    got = _same_on_ranks(ranks, "flat", 4)
    prob = problems["flat"]
    s1, c1 = tba.ba_solve(_port(tba.BAProblem, prob), iters=4)
    _close(got, s1.poses.numpy(), s1.landmarks.numpy(), c1.numpy())
    mesh = JMesh(np.array(jax.devices()[:4]), ("obs",))
    s2, c2 = jba.ba_solve(prob, iters=4, mesh=mesh, axis="obs")
    _close(got, s2.poses, s2.landmarks, c2)
    assert got["costs"][-1] < got["costs"][0]


@pytest.mark.parametrize("layout", ["generic", "ring"])
@pytest.mark.parametrize("linalg", ["lu", "chol"])
def test_tracks_ba_sharded(ranks, problems, layout, linalg):
    """``ba_solve_tracks`` over 8 "lm" ranks: pose-sized all-reduces only,
    each rank's landmark block back-substituted locally and gathered at the
    end; against the port's single-device solve, and JAX's sharded one: its
    float32 poses and landmarks, and the costs of the same solve in float64
    (module doc)."""
    got = _same_on_ranks(ranks, "tracks", 8)[f"{layout}_{linalg}"]
    prob = problems[layout]
    kw = dict(iters=4, ring_layout=layout == "ring", linalg=linalg)
    s1, c1 = tba.ba_solve_tracks(_port(tba.BATracks, prob), **kw)
    _close(got, s1.poses.numpy(), s1.landmarks.numpy(), c1.numpy())
    mesh = JMesh(np.array(jax.devices()[:8]), ("lm",))
    s2, _ = jax.jit(lambda p: jba.ba_solve_tracks(
        p, mesh=mesh, axis="lm", **kw))(prob)
    _close(got, s2.poses, s2.landmarks, _jax_costs_x64(prob, mesh, **kw))
    assert got["costs"][-1] < got["costs"][0] * 1e-2
    assert not jax.config.jax_enable_x64


def test_slam_run_sharded(ranks):
    """``slam_run`` with the window BA over 4 "lm" ranks (recovery on, the
    JAX default): the tracker the same bits as the port's single-device
    run (the BA does not feed it), the keyframe poses and history within
    1e-3 and the same keyframes and landmark slots; against JAX's
    ``slam_run(mesh=...)`` the same keyframes and landmark slots, and the
    poses within 1e-3."""
    got = _same_on_ranks(ranks, "slam", C.SLAM_RANKS)
    clip, boot = C.slam_clip()
    one = C._state_arrays(tpipe.slam_run(clip, C.slam_cfg(),
                                         bootstrap_poses=boot,
                                         device="cpu"))
    assert got["n_keyframes"] == one["n_keyframes"] == 4
    for key in ("position", "age", "lm_valid"):
        assert np.array_equal(got[key], one[key]), key
    for key in ("kf_pose", "hist_pose"):
        np.testing.assert_allclose(got[key], one[key], atol=1e-3)
    valid = got["lm_valid"]
    np.testing.assert_allclose(got["lm_X"][valid], one["lm_X"][valid],
                               atol=1e-3)

    jcfg = jpipe.SlamConfig(
        intrinsics=C.SLAM_INTR, keyframe_period=2, ring=4, ba_iters=2,
        min_parallax=1.0, history=8,
        tracker=jve.VideoExtruderConfig(
            capacity=8 * C.SLAM_RANKS, detect_k=32, nscales=2, winsize=7,
            keypoint_spacing=8, detector_period=1, detector_th=8))
    mesh = JMesh(np.array(jax.devices()[:C.SLAM_RANKS]), ("lm",))
    js = jax.jit(lambda f, b: jpipe.slam_run(f, jcfg, bootstrap_poses=b,
                                             mesh=mesh, axis="lm"))(
        jnp.asarray(clip), jnp.asarray(boot))
    assert int(js.n_keyframes) == got["n_keyframes"]
    np.testing.assert_allclose(got["kf_pose"], np.asarray(js.kf_pose),
                               atol=1e-3)
    assert np.array_equal(got["lm_valid"], np.asarray(js.lm_valid))
