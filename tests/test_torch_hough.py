"""Parity of vpp_tpu_torch's Hough path (kernel K7's plain version, peaks
and the line tracker) with vpp_tpu's on the CPU.

The accumulator is held within 1e-3 * max of the JAX float32 scatter (the
vote bins go through another libm's atan2/cos/sin, and K7 takes them as
continuous coordinates t0 + ft, ρ0 + fr), and within 5e-3 * max of the
Pallas kernel in interpret mode, whose bf16 operands set that bound
(``tests/test_hough.py``). Peaks on equal accumulators, and the tracker
over the synthetic two-line clip (against the JAX step run op by op), must
be equal.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpp_tpu.core.image import from_array as j_from_array
from vpp_tpu_torch import convert
from vpp_tpu_torch.core.image import from_array as t_from_array
from vpp_tpu_torch.utils.clips import synthetic_line_clip

jh = importlib.import_module("vpp_tpu.algorithms.hough")
th = importlib.import_module("vpp_tpu_torch.algorithms.hough")
jhp = importlib.import_module("vpp_tpu.algorithms.hough_pallas")
thc = importlib.import_module("vpp_tpu_torch.algorithms.hough_cuda")
jht = importlib.import_module("vpp_tpu.algorithms.hough_tracker")
tht = importlib.import_module("vpp_tpu_torch.algorithms.hough_tracker")

torch.set_num_threads(1)


def _pair(a, border=3):
    return (j_from_array(jnp.asarray(a), border=border, border_mode="mirror"),
            t_from_array(a, border=border, border_mode="mirror"))


def _noise(seed, shape=(64, 96)):
    return (np.random.RandomState(seed).rand(*shape) * 255).astype(np.float32)


def test_sobel_and_vote_bins_close():
    ji, ti = _pair(_noise(0))
    for j, t in zip(jh.sobel_gradients(ji), th.sobel_gradients(ti)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    jb = jh._vote_bins(ji, 63, None, 40.0, "binary", None)
    tb = th._vote_bins(ti, 63, None, 40.0, "binary", None)
    assert jb[5] == tb[5]
    np.testing.assert_array_equal(np.asarray(jb[4]), tb[4].numpy())
    jt = np.asarray(jb[0]) + np.asarray(jb[2])
    tt = tb[0].numpy() + tb[2].numpy()
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-3)


@pytest.mark.parametrize("vote_weight", ["binary", "magnitude"])
@pytest.mark.parametrize("masked", [False, True])
def test_accumulator_matches_scatter(vote_weight, masked):
    ji, ti = _pair(_noise(1, (96, 128)))
    mask = None
    if masked:
        mask = np.zeros((96, 128), np.uint8)
        mask[20:70, 30:100] = 1
    a = np.asarray(jh.hough_accumulator(
        ji, t_theta=63, vote_weight=vote_weight,
        pixel_mask=None if mask is None else jnp.asarray(mask)))
    b = th.hough_accumulator(
        ti, t_theta=63, vote_weight=vote_weight,
        pixel_mask=None if mask is None else torch.from_numpy(mask))
    assert tuple(b.shape) == a.shape and b.dtype == torch.float32
    assert np.abs(a - b.numpy()).max() / a.max() < 1e-3


def test_accumulator_matches_pallas_interpret():
    ji, ti = _pair(_noise(4))
    a = np.asarray(jhp.hough_accumulator_pallas(ji, t_theta=63,
                                                interpret=True))
    b = th.hough_accumulator(ti, t_theta=63).numpy()
    assert np.abs(a - b).max() / a.max() < 5e-3


def test_k7_plain_votes_clip_at_the_last_bins():
    """θ_n and ρ_n at the last bins and below the first: the four votes
    clip like the JAX scatter; padding entries (weight 0) cast nothing."""
    th_n = torch.tensor([0.0, 62.0, 61.5, 10.25, 3.0])
    rho_n = torch.tensor([-0.25, 99.0, 98.5, 40.75, -2.0])
    w = torch.tensor([1.0, 2.0, 1.0, 0.5, 0.0])
    acc = thc.hough_acc(th_n, rho_n, w, 63, 100)
    assert torch.equal(acc, thc.hough_acc_plain(th_n, rho_n, w, 63, 100))
    assert abs(float(acc.sum()) - 4.5) < 1e-6
    assert float(acc[62, 99]) == pytest.approx(2.25)
    assert float(acc[10, 40]) == pytest.approx(0.5 * 0.75 * 0.25)
    with pytest.raises(ValueError):
        thc.hough_acc(th_n, rho_n[:3], w, 63, 100)


@pytest.mark.parametrize("m", [4, 10])
def test_hough_peaks_equal_on_equal_accumulators(m):
    rng = np.random.RandomState(m)
    acc = np.round(rng.rand(63, 120) * 20).astype(np.float32)  # many ties
    jp = jh.hough_peaks(jnp.asarray(acc), m, exclusion_theta=3,
                        exclusion_rho=5, acc_threshold=18.0)
    tp = th.hough_peaks(torch.from_numpy(acc), m, exclusion_theta=3,
                        exclusion_rho=5, acc_threshold=18.0)
    for name in jp._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jp, name)),
                                      getattr(tp, name).numpy())


def test_appearance_helpers_match():
    rng = np.random.RandomState(7)
    acc = rng.rand(63, 80).astype(np.float32)
    ti = np.array([0, 5, 62, 30], np.int32)
    ri = np.array([0, 79, 3, 40], np.int32)
    jpat = jht._acc_patches(jnp.asarray(acc), jnp.asarray(ti),
                            jnp.asarray(ri), 4)
    tpat = tht._acc_patches(torch.from_numpy(acc), torch.from_numpy(ti),
                            torch.from_numpy(ri), 4)
    np.testing.assert_array_equal(np.asarray(jpat), tpat.numpy())
    np.testing.assert_allclose(
        tht._pearson(tpat, tpat.flip(0)).numpy(),
        np.asarray(jht._pearson(jpat, jpat[::-1])), rtol=1e-5, atol=1e-6)


def _state_mapping(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def _assert_same_tracks(jst, tst):
    for name in ("age", "fwu", "rho", "theta", "traj", "traj_n"):
        np.testing.assert_array_equal(np.asarray(getattr(jst, name)),
                                      getattr(tst, name).numpy())
    np.testing.assert_allclose(tst.votes.numpy(), np.asarray(jst.votes),
                               rtol=1e-4)


def test_hough_tracker_matches_with_handover():
    """The tracker frame by frame over the two-line clip, both packages
    from empty; then the JAX state crosses over through ``convert`` and
    both continue. Peaks, ages and (θ, ρ) stay equal."""
    frames = synthetic_line_clip(128, 96, 8)
    kw = dict(m_first_lines=8, acc_threshold=10.0)
    jcfg, tcfg = jht.HoughTrackerConfig(**kw), tht.HoughTrackerConfig(**kw)
    jst = jht.hough_tracker_init(jcfg)
    tst = tht.hough_tracker_init(tcfg, device="cpu")
    for t, f in enumerate(frames):
        ji, ti = _pair(f)
        jst, jpk = jht.hough_tracker_update(jst, ji, jcfg)
        tst, tpk = tht.hough_tracker_update(tst, ti, tcfg)
        for name in ("theta_idx", "rho_idx", "valid"):
            np.testing.assert_array_equal(np.asarray(getattr(jpk, name)),
                                          getattr(tpk, name).numpy())
        _assert_same_tracks(jst, tst)
        if t == 4:
            tst = convert.hough_tracker_state_from_numpy(
                _state_mapping(jst), device="cpu")
            back = convert.hough_tracker_state_to_numpy(tst)
            assert int(back["frame_id"]) == int(jst.frame_id)
    assert int((tst.age > 0).sum()) >= 2


def test_hough_tracker_config_and_kalman():
    assert tht.HoughTrackerConfig() == tht.HoughTrackerConfig(
        **dataclasses.asdict(jht.HoughTrackerConfig()))
    cfg = tht.HoughTrackerConfig(with_kalman_filter=True)
    st = tht.hough_tracker_init(cfg, device="cpu")
    _, ti = _pair(synthetic_line_clip(64, 48, 1)[0])
    with pytest.raises(NotImplementedError):
        tht.hough_tracker_update(st, ti, cfg)
