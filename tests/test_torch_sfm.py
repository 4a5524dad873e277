"""Parity of vpp_tpu_torch's SfM from line correspondences with vpp_tpu's
on the CPU.

R and t of ``pose_from_line_correspondences`` within 1e-3 of the JAX
package's (both run the same 8-restart damped Gauss-Newton bank in float32;
the Jacobians and solves round in another order), the residual within
1e-6; the Plücker algebra and the line normals within 1e-5; the
vanishing-point votes equal (float32 sums of 0/1 weights) and the
directions within 1e-5. Inputs: tests/test_sfm.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jsf = importlib.import_module("vpp_tpu.slam.sfm")
tsf = importlib.import_module("vpp_tpu_torch.slam.sfm")
jse = importlib.import_module("vpp_tpu.slam.se3")
jba = importlib.import_module("vpp_tpu.slam.ba")

torch.set_num_threads(1)

INTR = np.array([300.0, 300.0, 160.0, 120.0], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _line_scene(m=8, seed=0):
    """tests/test_sfm.py:39."""
    rng = np.random.RandomState(seed)
    p1 = rng.rand(m, 3) * [2, 1.5, 1] + [-1, -0.75, 3]
    d = rng.randn(m, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p2 = p1 + d * 0.8
    return p1.astype(np.float32), p2.astype(np.float32)


def test_plucker_bit_close():
    rng = np.random.RandomState(0)                    # tests/test_sfm.py:19
    p1 = rng.randn(8, 3).astype(np.float32)
    p2 = rng.randn(8, 3).astype(np.float32)
    jL = jsf.plucker_from_points(jnp.asarray(p1), jnp.asarray(p2))
    tL = tsf.plucker_from_points(_t(p1), _t(p2))
    np.testing.assert_allclose(tL.numpy(), np.asarray(jL), atol=1e-5)
    T = np.asarray(jse.se3_exp(jnp.asarray(rng.randn(6) * 0.3, jnp.float32)))
    np.testing.assert_allclose(
        tsf.plucker_transform(tL, _t(T)).numpy(),
        np.asarray(jsf.plucker_transform(jL, jnp.asarray(T))), atol=1e-5)
    X = (0.3 * p1 + 0.7 * p2 + rng.randn(8, 3) * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        tsf.plucker_point_distance(tL, _t(X)).numpy(),
        np.asarray(jsf.plucker_point_distance(jL, jnp.asarray(X))),
        atol=1e-5)
    mid = 0.3 * _t(p1) + 0.7 * _t(p2)
    assert float(tsf.plucker_point_distance(tL, mid).max()) < 1e-4


def test_image_line_normals():
    p1, p2 = _line_scene()
    T = np.asarray(jse.se3_exp(jnp.asarray([0.1, -0.15, 0.05, 0.2, -0.1,
                                            0.15], jnp.float32)))
    uv1 = np.asarray(jba.project(jnp.asarray(T), jnp.asarray(p1),
                                 jnp.asarray(INTR)))
    uv2 = np.asarray(jba.project(jnp.asarray(T), jnp.asarray(p2),
                                 jnp.asarray(INTR)))
    j = np.asarray(jsf.image_line_normals(jnp.asarray(uv1), jnp.asarray(uv2),
                                          jnp.asarray(INTR)))
    t = tsf.image_line_normals(_t(uv1), _t(uv2), _t(INTR)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-5)


@pytest.mark.parametrize("xi,m,seed,valid", [
    ([0.1, -0.15, 0.05, 0.2, -0.1, 0.15], 8, 0, None),  # test_sfm.py:48
    ([0.4, 0.2, -0.3, -0.2, 0.1, 0.3], 12, 1, None),
    ([-0.2, 0.1, 0.25, 0.1, 0.2, -0.1], 10, 2, "mask"),
])
def test_pose_from_line_correspondences(xi, m, seed, valid):
    p1, p2 = _line_scene(m, seed)
    T_gt = jse.se3_exp(jnp.asarray(xi, jnp.float32))
    uv1 = np.array(jba.project(T_gt, jnp.asarray(p1), jnp.asarray(INTR)))
    uv2 = np.asarray(jba.project(T_gt, jnp.asarray(p2), jnp.asarray(INTR)))
    vm = None
    if valid:
        vm = np.ones(m, bool)
        vm[[1, 4]] = False
        uv1[[1, 4]] += 40.0                # outliers, masked out
    jR, jt, jc = jsf.pose_from_line_correspondences(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(uv1), jnp.asarray(uv2),
        jnp.asarray(INTR), valid=None if vm is None else jnp.asarray(vm))
    tR, tt, tc = tsf.pose_from_line_correspondences(
        _t(p1), _t(p2), _t(uv1), _t(uv2), _t(INTR),
        valid=None if vm is None else _t(vm))
    assert tR.shape == (3, 3) and tt.shape == (3,) and tc.shape == ()
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-3)
    assert abs(float(tc) - float(jc)) <= 1e-6
    assert float(tc) < 1e-6                 # tests/test_sfm.py:56's gate
    np.testing.assert_allclose(tR.numpy(), np.asarray(T_gt[:3, :3]),
                               atol=2e-2)


@pytest.mark.parametrize("case", ["family", "two_families", "masked"])
def test_vanishing_points(case):
    """tests/test_sfm.py:80's family of lines through one image point, a
    second family, and masked lines."""
    x0, y0 = 260.0, 160.0
    th = np.linspace(0.3, 1.2, 10).astype(np.float32)
    rho = (x0 * np.cos(th) + y0 * np.sin(th)).astype(np.float32)
    valid = np.ones(10, bool)
    if case != "family":
        th2 = np.linspace(1.6, 2.6, 8).astype(np.float32)
        rho2 = (40.0 * np.cos(th2) + 90.0 * np.sin(th2)).astype(np.float32)
        th, rho = np.concatenate([th, th2]), np.concatenate([rho, rho2])
        valid = np.ones(18, bool)
    if case == "masked":
        valid[::3] = False
    jd, jv = jsf.vanishing_points(jnp.asarray(th), jnp.asarray(rho),
                                  jnp.asarray(valid), jnp.asarray(INTR),
                                  top=4)
    td, tv = tsf.vanishing_points(_t(th), _t(rho), _t(valid), _t(INTR),
                                  top=4)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    if case == "family":
        exp = np.array([(x0 - 160.0) / 300.0, (y0 - 120.0) / 300.0, 1.0])
        assert abs(float(td[0].numpy() @ (exp / np.linalg.norm(exp)))) > 0.99
