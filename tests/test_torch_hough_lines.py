"""Parity of vpp_tpu_torch's one-shot Hough line detection with vpp_tpu's
on the CPU: the seam fold and local-maxima mask, the clustered peaks, the
adaptive threshold, the sparse revote, top-k, line conversion and
``hough_lines``, on the inputs of ``tests/test_hough.py``.

Where both packages work on the same accumulator (given as numpy) the
results must be equal, indices, votes and masks alike, the invalid
slots of a top-k included: ``lax.top_k`` puts the lower flat index first
on a tie, and the port copies that rule. Where each builds its own
accumulator from the image, the accumulators agree within 1e-3 * max
(``tests/test_torch_hough.py``), and the peaks must be equal. The port's
``hough_accumulator_mxu`` is K7 (float32 votes), held within 1e-3 * max of
JAX's float32 scatter of the same votes and within 5e-3 * max of JAX's
``hough_accumulator_mxu``, whose bf16 bilinear weights set that bound
(``tests/test_hough.py:178-200``; on those inputs the bf16 version sits
1.2e-3 and 2.0e-3 * max from the float32 votes).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpp_tpu.core.image import from_array as j_from_array
from vpp_tpu_torch.core.image import from_array as t_from_array

jh = importlib.import_module("vpp_tpu.algorithms.hough")
th = importlib.import_module("vpp_tpu_torch.algorithms.hough")

torch.set_num_threads(1)


def _pair(a, border=3, mode="mirror"):
    return (j_from_array(jnp.asarray(a), border=border, border_mode=mode),
            t_from_array(a, border=border, border_mode=mode))


def _bands(rows=(30, 70), h=96, w=128):
    a = np.zeros((h, w), np.float32)
    for r in rows:
        a[r:r + 2] = 200.0
    return a


def _two_equal_lines(h=96, w=128):
    """Two horizontal lines of equal length: every vote of one has an equal
    vote in the other, so the peaks tie."""
    a = np.zeros((h, w), np.float32)
    a[20, :] = 200.0
    a[60, :] = 200.0
    return a


def _eq_lines(j, t):
    for name in j._fields:
        np.testing.assert_array_equal(np.asarray(getattr(j, name)),
                                      getattr(t, name).numpy(), err_msg=name)


def _accs(a, **kw):
    ji, ti = _pair(a)
    return (jh.hough_accumulator(ji, **kw), th.hough_accumulator(ti, **kw))


def test_fold_seam_and_maxima_mask_equal():
    rng = np.random.RandomState(0)
    acc = np.round(rng.rand(63, 90) * 30).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jh._fold_seam(jnp.asarray(acc))),
        th._fold_seam(torch.from_numpy(acc)).numpy())
    for nt, nr, thr in ((4, 4, 10.0), (15, 12, 0.0), (0, 3, 5.0),
                        (1, 0, 20.0)):
        np.testing.assert_array_equal(
            np.asarray(jh._local_maxima_mask(jnp.asarray(acc), nt, nr,
                                             jnp.float32(thr))),
            th._local_maxima_mask(torch.from_numpy(acc), nt, nr,
                                  thr).numpy(), err_msg=str((nt, nr)))


@pytest.mark.parametrize("tail", [False, True])
def test_peaks_clustered_on_equal_accumulators(tail):
    """Random accumulators of small integers (many ties): the same maxima,
    order and invalid slots; with ``tail`` k runs 15 past the maxima into
    zero cells."""
    rng = np.random.RandomState(int(tail))
    acc = np.round(rng.rand(63, 90) * 12).astype(np.float32)
    n = int(th._local_maxima_mask(torch.from_numpy(acc), 3, 4, 3.0).sum())
    k = n + 15 if tail else 6
    j = jh.hough_peaks_clustered(jnp.asarray(acc), k, nms_theta=3,
                                 nms_rho=4, threshold=3.0)
    t = th.hough_peaks_clustered(torch.from_numpy(acc), k, nms_theta=3,
                                 nms_rho=4, threshold=3.0)
    _eq_lines(j, t)
    assert int((~t.valid).sum()) == (15 if tail else 0)


def test_two_equal_lines_tie_rule():
    """Equal-length lines tie in votes: the clustered peaks and top-k list
    them lower flat index first, and the slots past the maxima (vote 0)
    carry JAX's indices too."""
    ja, ta = _accs(_two_equal_lines(), t_theta=181)
    acc = np.asarray(ja)
    # same accumulator for both: the tie rule alone decides the order
    for k in (4, 12):
        _eq_lines(jh.hough_peaks_clustered(jnp.asarray(acc), k,
                                           threshold=10.0),
                  th.hough_peaks_clustered(torch.from_numpy(acc), k,
                                           threshold=10.0))
        _eq_lines(jh.hough_top_k(jnp.asarray(acc), k),
                  th.hough_top_k(torch.from_numpy(acc), k))
    tk = th.hough_top_k(torch.from_numpy(acc), 12)
    v = tk.votes.numpy()
    tied = np.flatnonzero(v[:-1] == v[1:])
    assert tied.size, "the two lines give no tied votes"
    flat = tk.theta_idx.numpy() * acc.shape[1] + tk.rho_idx.numpy()
    assert (flat[tied] < flat[tied + 1]).all()
    # each package on its own accumulator: the same two lines
    _eq_lines(jh.hough_peaks_clustered(ja, 4, threshold=10.0),
              th.hough_peaks_clustered(ta, 4, threshold=10.0))


def test_top_k_zero_tail_and_negative_values():
    """Past the non-zero cells the top-k fills with zero cells in index
    order; negative and -0.0 values sort as lax.top_k sorts them."""
    acc = np.zeros((7, 9), np.float32)
    acc[2, 3] = 5.0
    acc[6, 1] = 5.0
    acc[0, 8] = -1.0
    acc[4, 4] = -0.0
    for k in (2, 10, 63):
        _eq_lines(jh.hough_top_k(jnp.asarray(acc), k),
                  th.hough_top_k(torch.from_numpy(acc), k))


def test_hough_lines_horizontal_and_two_lines():
    """test_hough.py:36-61: one horizontal line, then two lines with the ρ
    exclusion; peaks, (θ, ρ) and the top-k of each package's own
    accumulator equal."""
    a = np.zeros((96, 128), np.float32)
    a[40:42] = 200.0
    for img, kw in ((a, dict(m=2)), (_bands(), dict(m=2, exclusion_rho=15))):
        ji, ti = _pair(img)
        jp, jt, jr, jacc = jh.hough_lines(ji, t_theta=181, **kw)
        tp, tt, tr, tacc = th.hough_lines(ti, t_theta=181, **kw)
        _eq_lines(jp, tp)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                                   atol=1e-4)
        jacc = np.asarray(jacc)
        assert np.abs(tacc.numpy() - jacc).max() <= 1e-3 * jacc.max()
        _eq_lines(jh.hough_top_k(jnp.asarray(jacc), 2),
                  th.hough_top_k(torch.from_numpy(jacc), 2))
    rhos = sorted(float(r) for r in tr)
    assert abs(rhos[0] - 31) < 4 and abs(rhos[1] - 71) < 4


def test_line_endpoints_and_to_lines():
    theta = np.array([np.pi / 2, 0.3, 2.9, 0.0], np.float32)
    rho = np.array([40.0, -12.5, 77.0, 5.0], np.float32)
    for length in (None, 50.0):
        jp = jh.line_endpoints(jnp.asarray(theta), jnp.asarray(rho),
                               (96, 128), length)
        tp = th.line_endpoints(torch.from_numpy(theta),
                               torch.from_numpy(rho), (96, 128), length)
        for j, t in zip(jp, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                       atol=1e-4)
    lines = jh.HoughLines(theta_idx=jnp.asarray([0, 90, 180], jnp.int32),
                          rho_idx=jnp.asarray([0, 80, 159], jnp.int32),
                          votes=jnp.zeros(3), valid=jnp.ones(3, bool))
    tl = th.HoughLines(*(torch.from_numpy(np.asarray(x)) for x in lines))
    for j, t in zip(jh.accumulator_to_lines(lines, (181, 160), (96, 128)),
                    th.accumulator_to_lines(tl, (181, 160), (96, 128))):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_peaks_clustered_two_lines_from_images():
    """test_hough.py:121: both bands found, from each package's own
    accumulator, the same peaks."""
    ja, ta = _accs(_bands(), t_theta=181, grad_threshold=40.0)
    j = jh.hough_peaks_clustered(ja, 6, threshold=10.0)
    t = th.hough_peaks_clustered(ta, 6, threshold=10.0)
    for name in ("theta_idx", "rho_idx", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(j, name)),
                                      getattr(t, name).numpy())
    np.testing.assert_allclose(t.votes.numpy(), np.asarray(j.votes),
                               rtol=1e-5)
    theta, rho = th.accumulator_to_lines(t, tuple(ta.shape), (96, 128))
    got = sorted(float(r) for r, v in zip(rho, t.valid) if v)
    assert any(abs(g - 30.5) < 4 for g in got), got
    assert any(abs(g - 70.5) < 4 for g in got), got


def test_sparse_revote_masks_other_lines():
    """test_hough.py:143: the revote around the row-30 line, with its band
    mask equal to JAX's, the accumulator within 1e-3 * max and the peaks
    equal."""
    ji, ti = _pair(_bands())
    theta = np.asarray([np.pi / 2, 0.4], np.float32)
    rho = np.asarray([30.5, 10.0], np.float32)
    valid = np.asarray([True, False])
    tmask = th._near_lines((96, 128), torch.from_numpy(theta),
                           torch.from_numpy(rho), torch.from_numpy(valid),
                           5.0)
    assert int(tmask.sum()) == 10 * 128          # rows 26-35
    ja = np.asarray(jh.hough_sparse_revote(
        ji, jnp.asarray(theta), jnp.asarray(rho), jnp.asarray(valid),
        band=5.0, t_theta=181))
    ta = th.hough_sparse_revote(
        ti, torch.from_numpy(theta), torch.from_numpy(rho),
        torch.from_numpy(valid), band=5.0, t_theta=181)
    assert np.abs(ta.numpy() - ja).max() <= 1e-3 * ja.max()
    jp = jh.hough_peaks_clustered(jnp.asarray(ja), 4, threshold=10.0)
    tp = th.hough_peaks_clustered(ta, 4, threshold=10.0)
    for name in ("theta_idx", "rho_idx", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, name)),
                                      getattr(tp, name).numpy())
    _, rho2 = th.accumulator_to_lines(tp, tuple(ta.shape), (96, 128))
    got = [float(r) for r, v in zip(rho2, tp.valid) if v]
    assert got and all(abs(g - 30.5) < 6 for g in got), got


@pytest.mark.parametrize("lo,hi,th0,calls", [(5, 40, 1.0, 5),
                                             (50, 100, 50.0, 5),
                                             (1, 3, 200.0, 3)])
def test_adaptive_threshold_and_count(lo, hi, th0, calls):
    """test_hough.py:162's noisy accumulator: the same threshold and
    count, as 0-d tensors, and the threshold feeds the clustered peaks."""
    rng = np.random.RandomState(0)
    acc = rng.rand(181, 160).astype(np.float32) * 100
    jt, jn = jh.hough_adaptive_threshold(
        jnp.asarray(acc), target_lo=lo, target_hi=hi, th0=th0,
        max_calls=calls, nms_theta=4, nms_rho=4)
    tt, tn = th.hough_adaptive_threshold(
        torch.from_numpy(acc), target_lo=lo, target_hi=hi, th0=th0,
        max_calls=calls, nms_theta=4, nms_rho=4)
    assert tt.dim() == 0 and tn.dim() == 0
    assert tt.dtype == torch.float32 and tn.dtype == torch.int32
    assert float(tt) == float(jt) and int(tn) == int(jn)
    _eq_lines(jh.hough_peaks_clustered(jnp.asarray(acc), 16, nms_theta=4,
                                       nms_rho=4, threshold=jt),
              th.hough_peaks_clustered(torch.from_numpy(acc), 16,
                                       nms_theta=4, nms_rho=4,
                                       threshold=tt))


@pytest.mark.parametrize("vote_weight", ["binary", "magnitude"])
def test_accumulator_mxu_against_jax_bf16(vote_weight):
    """test_hough.py:178-200's inputs: the port's ``hough_accumulator_mxu``
    (K7, float32 votes) within 1e-3 * max of JAX's float32 scatter and
    within 5e-3 * max (test_hough.py's bound) of JAX's bf16 one-hot
    version, and equal to the port's ``hough_accumulator``; ``chunk`` is
    checked but does not change the result."""
    rng = np.random.RandomState(3)
    ji, ti = _pair(rng.rand(96, 128).astype(np.float32) * 255)
    mask = None
    if vote_weight == "magnitude":
        mask = np.zeros((96, 128), np.uint8)
        mask[20:70, 30:100] = 1
    kw = dict(t_theta=63, vote_weight=vote_weight)
    a = np.asarray(jh.hough_accumulator_mxu(
        ji, chunk=512, pixel_mask=None if mask is None else jnp.asarray(mask),
        **kw))
    tm = None if mask is None else torch.from_numpy(mask)
    b = th.hough_accumulator_mxu(ti, chunk=512, pixel_mask=tm, **kw)
    assert np.abs(b.numpy() - a).max() <= 5e-3 * a.max()
    f = np.asarray(jh.hough_accumulator(
        ji, pixel_mask=None if mask is None else jnp.asarray(mask), **kw))
    assert np.abs(b.numpy() - f).max() <= 1e-3 * f.max()
    assert torch.equal(b, th.hough_accumulator(ti, pixel_mask=tm, **kw))
    assert torch.equal(b, th.hough_accumulator_mxu(ti, pixel_mask=tm, **kw))
    for bad in (0, -5, 2.5, True):
        with pytest.raises(ValueError):
            th.hough_accumulator_mxu(ti, chunk=bad)
