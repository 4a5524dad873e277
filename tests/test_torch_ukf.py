"""Parity of vpp_tpu_torch's unscented Kalman filter and the Kalman Hough
tracker with vpp_tpu's on the CPU.

One predict or update from the same state: within 1e-5 relative (another
libm's sin/cos/atan2, another LAPACK's Cholesky and sum orders). The
60-step convergence of ``tests/test_hough.py:74``: JAX's gates, and the
port's x within 1e-3 of JAX's for the first 10 steps; past them the
filter is chaotic in the reference itself (one float32 ulp on one initial
component moves JAX's own x by up to 0.1 at step 60, in the unobservable
yaw), so at every step the port is held within that one-ulp spread of
JAX's x plus 1e-3. A bank of filters batched over leading dims equals the
filters one by one. A covariance that is not positive definite gives NaN,
as JAX's Cholesky does. The Kalman tracker on ``tests/test_hough.py``'s
frames: ages and frames without update equal, θ and ρ within 1e-3; and a
JAX Kalman tracker state after 8 frames goes to the port and back bit
for bit.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpp_tpu.core.image import from_array as j_from_array
from vpp_tpu_torch import convert
from vpp_tpu_torch.core.image import from_array as t_from_array
from vpp_tpu_torch.utils.clips import synthetic_line_clip

ju = importlib.import_module("vpp_tpu.algorithms.ukf")
tu = importlib.import_module("vpp_tpu_torch.algorithms.ukf")
jht = importlib.import_module("vpp_tpu.algorithms.hough_tracker")
tht = importlib.import_module("vpp_tpu_torch.algorithms.hough_tracker")

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, rel=1e-5):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rel,
                               atol=rel * max(1.0, np.abs(j).max()))


def _random_state(rng):
    x = (rng.randn(5) * [20, 1, 2, 1, 0.2]).astype(np.float32)
    a = rng.randn(5, 5).astype(np.float32)
    P = (a @ a.T * 0.3 + np.eye(5, dtype=np.float32)).astype(np.float32)
    return x, P


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_predict_and_update_one_step(seed):
    rng = np.random.RandomState(seed)
    x, P = _random_state(rng)
    js = ju.UKFState(x=jnp.asarray(x), P=jnp.asarray(P))
    ts = tu.UKFState(x=_t(x), P=_t(P))
    for kw in (dict(), dict(std_a=0.5, std_yawdd=0.05)):
        j1, jsp = ju.ukf_predict(js, 1.0, **kw)
        t1, tsp = tu.ukf_predict(ts, 1.0, **kw)
        _close(tsp, jsp)
        _close(t1.x, j1.x)
        _close(t1.P, j1.P)
    z = np.array([x[0] + 2.0, x[1] - 0.3], np.float32)
    Rm = np.diag([9.0, 2.0]).astype(np.float32)
    for dims in ((), (1,)):
        j2 = ju.ukf_update(j1, jsp, jnp.asarray(z),
                           ju.rho_theta_measurement, jnp.asarray(Rm),
                           angle_dims=dims)
        # the same predicted state into both updates
        t2 = tu.ukf_update(tu.UKFState(_t(j1.x), _t(j1.P)), _t(jsp), _t(z),
                           tu.rho_theta_measurement, _t(Rm),
                           angle_dims=dims)
        _close(t2.x, j2.x)
        _close(t2.P, j2.P)


def test_bank_equals_filters_one_by_one():
    """A (2, 3) bank of filters in one call: each equal to its filter run
    alone, through predict and update."""
    rng = np.random.RandomState(5)
    xs, Ps = zip(*[_random_state(rng) for _ in range(6)])
    X = _t(np.stack(xs)).view(2, 3, 5)
    Pm = _t(np.stack(Ps)).view(2, 3, 5, 5)
    z = _t(np.stack([x[:2] + 1 for x in xs])).view(2, 3, 2)
    bank = tu.ukf_predict_update_rho_theta(tu.UKFState(X, Pm), z, 1.0)
    for i in range(2):
        for j in range(3):
            one = tu.ukf_predict_update_rho_theta(
                tu.UKFState(X[i, j], Pm[i, j]), z[i, j], 1.0)
            torch.testing.assert_close(bank.x[i, j], one.x, rtol=1e-6,
                                       atol=1e-6)
            torch.testing.assert_close(bank.P[i, j], one.P, rtol=1e-6,
                                       atol=1e-6)


def test_converges_to_static_measurement():
    """test_hough.py:74: 60 predict+update cycles toward a constant (ρ, θ)
    measurement, JAX's gates, and the port against JAX (the module
    docstring says why past step 10 the bound is JAX's own spread)."""
    z = jnp.array([20.0, 1.0])
    step = jax.jit(lambda s: ju.ukf_predict_update_rho_theta(s, z, 1.0))

    def jax_run(x0):
        st, xs = ju.ukf_init(jnp.asarray(x0)), []
        for _ in range(60):
            st = step(st)
            xs.append(np.asarray(st.x))
        return np.array(xs), st

    x0 = np.array([10.0, 0.5, 0, 0, 0], np.float32)
    want, jst = jax_run(x0)
    spread = np.zeros_like(want)
    for k in range(2):
        for toward in (100.0, -100.0):
            x = x0.copy()
            x[k] = np.nextafter(x[k], np.float32(toward))
            spread = np.maximum(spread, np.abs(jax_run(x)[0] - want))
    st = tu.ukf_init(x0, device="cpu")
    assert st.x.dtype == torch.float32 and st.P.dtype == torch.float32
    zt = torch.tensor([20.0, 1.0])
    got = []
    for _ in range(60):
        st = tu.ukf_predict_update_rho_theta(st, zt, 1.0)
        got.append(st.x.numpy())
    got = np.array(got)
    assert abs(float(st.x[0]) - 20.0) < 1.5
    assert abs(float(st.x[1]) - 1.0) < 0.15
    P = st.P.numpy()
    assert np.allclose(P, P.T, atol=1e-3)
    np.testing.assert_allclose(got[:10], want[:10], rtol=0, atol=1e-3)
    assert (np.abs(got - want) <= spread + 1e-3).all(), \
        np.abs(got - want) - spread


def test_not_positive_definite_gives_nan():
    """A covariance with a negative eigenvalue: JAX's Cholesky returns
    NaN and the port writes NaN for that filter alone, with no raise."""
    bad = -np.eye(5, dtype=np.float32)
    good = np.eye(5, dtype=np.float32)
    x = np.zeros(5, np.float32)
    j1, _ = ju.ukf_predict(ju.UKFState(jnp.asarray(x), jnp.asarray(bad)),
                           1.0)
    t1, _ = tu.ukf_predict(tu.UKFState(_t(np.stack([x, x])),
                                       _t(np.stack([bad, good]))), 1.0)
    assert np.isnan(np.asarray(j1.x)).all() and np.isnan(np.asarray(j1.P)).all()
    assert torch.isnan(t1.x[0]).all() and torch.isnan(t1.P[0]).all()
    assert torch.isfinite(t1.x[1]).all() and torch.isfinite(t1.P[1]).all()


def _line(row, h=96, w=128):
    a = np.zeros((h, w), np.float32)
    a[row:row + 2] = 200.0
    return a


def _pair(a, border=3, mode="mirror"):
    return (j_from_array(jnp.asarray(a), border=border, border_mode=mode),
            t_from_array(a, border=border, border_mode=mode))


def _check_tracks(jst, tst):
    for name in ("age", "fwu", "traj_n"):
        np.testing.assert_array_equal(np.asarray(getattr(jst, name)),
                                      getattr(tst, name).numpy(),
                                      err_msg=name)
    live = tst.age.numpy() > 0
    for name in ("theta", "rho"):
        np.testing.assert_allclose(getattr(tst, name).numpy()[live],
                                   np.asarray(getattr(jst, name))[live],
                                   rtol=0, atol=1e-3, err_msg=name)
    np.testing.assert_allclose(tst.ukf_x.numpy()[live][:, :2],
                               np.asarray(jst.ukf_x)[live][:, :2], rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("case", ["moving", "coasting"])
def test_kalman_tracker_matches(case):
    """test_hough.py:87 (a moving line, 4 frames) and :106 (a line, then
    blank frames: the tracks coast on the filter's prediction and die)."""
    if case == "moving":
        kw = dict(t_theta=181, m_first_lines=4, capacity=8,
                  acc_threshold=10.0)
        frames = [_line(r) for r in (40, 42, 44, 46)]
    else:
        kw = dict(t_theta=181, m_first_lines=2, capacity=4,
                  acc_threshold=10.0, max_frames_without_update=2)
        frames = [_line(40)] + [np.zeros((96, 128), np.float32)] * 3
    jcfg = jht.HoughTrackerConfig(with_kalman_filter=True, **kw)
    tcfg = tht.HoughTrackerConfig(with_kalman_filter=True, **kw)
    jst, tst = jht.hough_tracker_init(jcfg), tht.hough_tracker_init(
        tcfg, device="cpu")
    ages = []
    for f in frames:
        ji, ti = _pair(f, mode="mirror" if case == "moving" else "zero")
        jst, _ = jht.hough_tracker_update(jst, ji, jcfg)
        tst, _ = tht.hough_tracker_update(tst, ti, tcfg)
        _check_tracks(jst, tst)
        ages.append(int(tst.age.max()))
    if case == "moving":
        assert ages[-1] >= 4
    else:
        assert ages == [1, 2, 3, 0]


def _mapping(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def test_kalman_tracker_state_round_trip():
    """A JAX Kalman tracker after 8 frames of the two-line clip (its
    ukf_x and ukf_P moved by the run) goes to the port and back bit for
    bit; so does a UKFState. The port then steps on from it as JAX does."""
    frames = synthetic_line_clip(128, 96, 10)
    kw = dict(m_first_lines=8, acc_threshold=10.0, with_kalman_filter=True)
    jcfg, tcfg = jht.HoughTrackerConfig(**kw), tht.HoughTrackerConfig(**kw)
    jst = jht.hough_tracker_init(jcfg)
    for f in frames[:8]:
        jst, _ = jht.hough_tracker_update(jst, _pair(f)[0], jcfg)
    m = _mapping(jst)
    assert not np.array_equal(m["ukf_P"],
                              np.tile(np.eye(5, dtype=np.float32),
                                      (32, 1, 1)))
    tst = convert.hough_tracker_state_from_numpy(m, device="cpu")
    back = convert.hough_tracker_state_to_numpy(tst)
    for name, v in m.items():
        np.testing.assert_array_equal(np.asarray(back[name]), v,
                                      err_msg=name)
        assert np.asarray(back[name]).dtype == v.dtype, name
    us = ju.UKFState(x=jst.ukf_x[3], P=jst.ukf_P[3])
    tus = convert.ukf_state_from_numpy(
        {"x": np.asarray(us.x), "P": np.asarray(us.P)}, device="cpu")
    assert isinstance(tus, tu.UKFState)
    ub = convert.ukf_state_to_numpy(tus)
    np.testing.assert_array_equal(ub["P"], np.asarray(us.P))
    for f in frames[8:]:
        ji, ti = _pair(f)
        jst, _ = jht.hough_tracker_update(jst, ji, jcfg)
        tst, _ = tht.hough_tracker_update(tst, ti, tcfg)
        _check_tracks(jst, tst)
