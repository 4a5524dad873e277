"""Parity of vpp_tpu_torch's epipolar flow branch with vpp_tpu's on the CPU.

``semi_dense_optical_flow`` with a fundamental matrix: ``epipolar_filter``
alone (the cost-volume route, then the residual filter) on
``tests/test_flow.py:145``'s case, and ``epipolar_flow=True`` (the line
search at every level) with a finite epipole (forward motion, F from
``fundamental_from_projections``), with and without the filter, from
level 0 and from level 1, some keypoints invalid. ``matched`` must be
equal, and the match positions equal where matched; ``distance`` within
1e-4 relative (float32 SADs summed in another order). The same F goes to
both packages as numpy.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpp_tpu.core.image import from_array as j_from_array
from vpp_tpu_torch.core.image import from_array as t_from_array

jfl = importlib.import_module("vpp_tpu.algorithms.flow")
tfl = importlib.import_module("vpp_tpu_torch.algorithms.flow")
jgeo = importlib.import_module("vpp_tpu.algorithms.geometry")

torch.set_num_threads(1)


def _texture(h=96, w=128, seed=0):
    """A 3x3 box-smoothed random texture, as tests/test_flow.py makes."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (h * 2, w * 2)).astype(np.float32)
    p = np.pad(base, 1, mode="wrap")
    sm = sum(p[r:r + 2 * h, c:c + 2 * w] for r in range(3) for c in range(3))
    return (sm / 9.0).astype(np.float32)


def _frames(tex, dr, dc, h=96, w=128, border=9):
    out = []
    for r, c in ((0, 0), (dr, dc)):
        a = np.ascontiguousarray(tex[32 + r:32 + r + h, 32 + c:32 + c + w])
        out.append((j_from_array(jnp.asarray(a), border=border,
                                 border_mode="mirror"),
                    t_from_array(a, border=border, border_mode="mirror")))
    return out


def _run(pts, valid, frames, F, **kw):
    (j1, t1), (j2, t2) = frames
    j = jfl.semi_dense_optical_flow(jnp.asarray(pts), jnp.asarray(valid),
                                    j1, j2, fundamental_matrix=jnp.asarray(F),
                                    **kw)
    t = tfl.semi_dense_optical_flow(torch.from_numpy(pts),
                                    torch.from_numpy(valid), t1, t2,
                                    fundamental_matrix=torch.from_numpy(F),
                                    **kw)
    jm, jd, jok = (np.asarray(x) for x in j)
    tm, td, tok = (x.numpy() for x in t)
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(tm[jok], jm[jok])
    both = jok & (jd < 1e29)
    np.testing.assert_allclose(td[both], jd[both], rtol=1e-4, atol=0)
    return tm, td, tok


def _points(n, seed=1):
    rng = np.random.RandomState(seed)
    return np.stack([rng.randint(20, 76, n),
                     rng.randint(20, 108, n)], axis=-1).astype(np.float32)


def test_epipolar_filter_kills_off_line_matches():
    """test_flow.py:145: F's epipolar lines are rows; column motion keeps
    the matches, row motion of 3 px kills them."""
    pts = _points(30)
    valid = np.ones(30, bool)
    F = np.array([[0, 0, 1], [0, 0, 0], [-1, 0, 0]], np.float32)
    kw = dict(winsize=7, nscales=3, propagation=2, patchsize=5,
              epipolar_filter=2.0)
    tex = _texture()
    _, _, ok_along = _run(pts, valid, _frames(tex, 0, 2), F, **kw)
    assert ok_along.mean() > 0.9
    _, _, ok_across = _run(pts, valid, _frames(tex, 3, 0), F, **kw)
    assert ok_across.mean() < 0.2


def _forward_F():
    """F of two cameras 100 px focal, the second moved mostly forward:
    the epipole lies near the image centre (finite)."""
    K = np.array([[100, 0, 64], [0, 100, 48], [0, 0, 1]], np.float32)
    P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K @ np.hstack([np.eye(3), np.array([[0.05], [0.02], [-1.0]])])
    return np.asarray(jgeo.fundamental_from_projections(
        jnp.asarray(P1, jnp.float32), jnp.asarray(P2, jnp.float32)))


@pytest.mark.parametrize("min_scale,filt,steps", [(0, None, 8),
                                                  (0, 2.0, 8),
                                                  (1, None, 4)])
def test_epipolar_flow_forward_motion(min_scale, filt, steps):
    F = _forward_F()
    pts = _points(60, seed=2)
    valid = np.ones(60, bool)
    valid[::7] = False
    kw = dict(winsize=7, nscales=3, propagation=2, patchsize=5,
              epipolar_flow=True, epipolar_steps=steps,
              epipolar_filter=filt, min_scale=min_scale)
    _, td, tok = _run(pts, valid, _frames(_texture(seed=3), 1, 1), F, **kw)
    assert not tok[::7].any()
    # the 1 px diagonal shift is not the forward motion F describes: the
    # filter keeps few matches, the search alone most
    assert tok.sum() > (5 if filt else 30) and np.isfinite(td[tok]).all()


def test_epipole_and_level_matrices():
    """The epipole against a float64 eigendecomposition of F Fᵀ, and the
    per-level F (the finest is F times the factor twice at 3 levels)."""
    F = _forward_F()
    e, fs = tfl._epipole_and_scales(torch.from_numpy(F), 3)
    _, vecs = np.linalg.eigh(F.astype(np.float64) @ F.T.astype(np.float64))
    want = vecs[:2, 0] / vecs[2, 0]
    np.testing.assert_allclose(e.numpy(), want, rtol=1e-3)
    down = np.array([[2, 2, 1], [2, 2, 1], [1, 1, 0.5]], np.float32)
    np.testing.assert_array_equal(fs[2].numpy(), F)
    np.testing.assert_array_equal(fs[0].numpy(), F * down * down)
