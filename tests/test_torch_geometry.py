"""Parity of the port's epipolar geometry and triangulation
(``vpp_tpu_torch.algorithms.geometry``) with vpp_tpu's on the CPU, at the
inputs of tests/test_geometry_matcher.py:29,44 and on random cameras.

Tolerances: an SVD or eigenvector is defined up to sign, so F is compared
up to sign, within 1e-4 of its largest magnitude (its entry F[2, 2] is a
cancellation of terms ~400x that magnitude: ~2e-5 of float32 rounding);
the triangulated points are
dehomogenised and compared directly, rtol 1e-4 and atol 1e-4 (float32 SVDs
of LAPACK against XLA); the epipoles at test_geometry_matcher.py's pair the
same, and on every pair within twice the JAX package's own distance from a
float64 evaluation of the same algorithm (plus 1e-4 of the epipole's
magnitude): the float32 null vector of F^T F is only as good as the
eigenvalue gap, in both packages; epipolar lines and
reprojection errors rtol 1e-5 (atol 1e-4 px for the errors, which are
float32 rounding at the round trip)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jgeo = importlib.import_module("vpp_tpu.algorithms.geometry")
tgeo = importlib.import_module("vpp_tpu_torch.algorithms.geometry")

torch.set_num_threads(1)


def _projections(seed):
    """Seed 0: tests/test_geometry_matcher.py:18's pair (identity rotation,
    a translation with a z component, so the epipoles are finite); other
    seeds: that pair moved by a small random rotation and translation
    (far from it the float32 null vectors of F^T F are rounding noise in
    both packages)."""
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    if seed == 0:
        R, t2 = np.eye(3), np.array([0.5, 0.2, 1.0])
    else:
        rng = np.random.RandomState(seed)
        w = rng.randn(3) * 0.02
        th = np.linalg.norm(w)
        k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        R = np.eye(3) + np.sin(th) / th * k + (1 - np.cos(th)) / th ** 2 \
            * k @ k
        t2 = rng.randn(3) * 0.1 + [0.5, 0.2, 1.0]
    P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K @ np.hstack([R, -(R @ t2)[:, None]])
    return P1, P2


def _points(P1, P2, seed, n=32):
    """tests/test_geometry_matcher.py:29's points and their projections."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 3) * [2, 2, 2] + [-1, -1, 4]
    hom = np.hstack([X, np.ones((n, 1))])
    x1 = hom @ P1.T
    x2 = hom @ P2.T
    return X, x1[:, :2] / x1[:, 2:3], x2[:, :2] / x2[:, 2:3]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triangulate_and_reprojection_error(seed):
    P1, P2 = _projections(seed)
    X, x1, x2 = _points(P1, P2, seed)
    j = np.asarray(jgeo.triangulate(P1, P2, x1, x2))
    t = tgeo.triangulate(P1, P2, x1, x2)
    assert t.dtype == torch.float32 and tuple(t.shape) == (32, 3)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t.numpy(), X, atol=1e-2)
    je = np.asarray(jgeo.reprojection_error(P1, j, x1))
    te = tgeo.reprojection_error(P1, torch.from_numpy(j), x1)
    np.testing.assert_allclose(te.numpy(), je, rtol=1e-5, atol=1e-4)
    assert float(te.max()) < 0.5
    # one point, as a (2,) correspondence
    t1 = tgeo.triangulate(P1, P2, x1[0], x2[0])
    np.testing.assert_allclose(t1.numpy(), j[:1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fundamental_and_epipoles(seed):
    P1, P2 = _projections(seed)
    jF = np.asarray(jgeo.fundamental_from_projections(P1, P2))
    tF = tgeo.fundamental_from_projections(P1, P2).numpy()
    scale = np.abs(jF).max()
    sign = 1.0 if np.abs(tF - jF).max() <= np.abs(tF + jF).max() else -1.0
    np.testing.assert_allclose(sign * tF, jF, atol=1e-4 * scale)
    for name in ("epipole_left", "epipole_right"):
        j = np.asarray(getattr(jgeo, name)(jF))
        t = getattr(tgeo, name)(torch.from_numpy(jF)).numpy()
        # the same algorithm in float64: the float32 null vector of F^T F
        # is only as good as its eigenvalue gap, in both packages
        M = jF.astype(np.float64)
        M = M if name == "epipole_right" else M.T
        e = np.linalg.eigh(M.T @ M)[1][:, 0]
        ref = e[:2] / e[2]
        assert np.abs(t - ref).max() <= 2 * np.abs(j - ref).max() \
            + 1e-4 * np.abs(ref).max(), (name, t, j, ref)
        if seed == 0:
            np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)
            # the port's F gives the same epipoles (F's sign drops out)
            np.testing.assert_allclose(
                getattr(tgeo, name)(torch.from_numpy(tF)).numpy(), j,
                rtol=1e-4, atol=1e-4)
    # test_geometry_matcher.py:44's null-vector property
    el = tgeo.epipole_left(torch.from_numpy(jF)).numpy()
    assert np.abs(np.array([el[0], el[1], 1.0]) @ jF).max() < 1e-2 * max(
        1, scale * 1e3)


def test_epipolar_line():
    P1, P2 = _projections(0)
    _, x1, _ = _points(P1, P2, 0)
    F = np.asarray(jgeo.fundamental_from_projections(P1, P2))
    j = np.asarray(jgeo.epipolar_line(F, x1))
    t = tgeo.epipolar_line(torch.from_numpy(F), torch.from_numpy(x1))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5,
                               atol=1e-6 * np.abs(j).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_epipoles_at_the_float64_null_vector(seed):
    """The port's epipoles lie within 1e-3 px of the float64 null vectors of
    F^T F and F F^T (the float32 eigenvector of a float32 F^T F does not:
    its error depends on the host's LAPACK path and reached 215 px)."""
    P1, P2 = _projections(seed)
    F = np.asarray(jgeo.fundamental_from_projections(P1, P2))
    for name, M in (("epipole_right", F), ("epipole_left", F.T)):
        M = M.astype(np.float64)
        e = np.linalg.eigh(M.T @ M)[1][:, 0]
        t = getattr(tgeo, name)(torch.from_numpy(F))
        assert t.dtype == torch.float32 and tuple(t.shape) == (2,)
        np.testing.assert_allclose(t.numpy(), e[:2] / e[2], rtol=0,
                                   atol=1e-3, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flow_epipole_at_the_float64_null_vector(seed):
    """The epipolar flow branch's own epipole (the null vector of F F^T,
    ``flow._epipole_and_scales``) within 1e-3 px of the float64 one."""
    tfl = importlib.import_module("vpp_tpu_torch.algorithms.flow")
    P1, P2 = _projections(seed)
    F = np.asarray(jgeo.fundamental_from_projections(P1, P2))
    M = F.astype(np.float64)
    e = np.linalg.eigh(M @ M.T)[1][:, 0]
    t, _ = tfl._epipole_and_scales(torch.from_numpy(F), 3)
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), e[:2] / e[2], rtol=0, atol=1e-3)
