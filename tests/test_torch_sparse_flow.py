"""Parity of vpp_tpu_torch's sparse optical flow with vpp_tpu's on the CPU.

FAST detection, the blockwise top-K and the patch descriptors are exact,
so ``pos1``, ``valid``, the descriptor distances (integer-valued frames:
exact SAD sums) and the matched train index are bit-equal. The refined
``pos2`` comes from Lucas-Kanade, whose stop rule (a step below 0.1 px)
makes the last position depend on float32 ulps of the pyramid for a few
keypoints (tests/test_torch_lk.py): within 1e-2 px on >= 99% of valid
matches (``chip_smoke.py``'s card-against-CPU gate; ~9% of them differ by
more than 1e-3 px on the first input set), and the median flow is the
translation.
Inputs: tests/test_flow.py:131 (the texture moved by (2, 2) at 128x160,
detector_th 8, k 256, search radius 12), rounded to integers.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpp_tpu.core.image import from_array as j_from_array
from vpp_tpu_torch.core.image import from_array as t_from_array

jsf = importlib.import_module("vpp_tpu.algorithms.sparse_flow")
tsf = importlib.import_module("vpp_tpu_torch.algorithms.sparse_flow")

torch.set_num_threads(1)


def _texture(h=160, w=192, seed=0):
    """tests/test_flow.py:17's texture."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (h * 2, w * 2)).astype(np.float32)
    from numpy.lib.stride_tricks import sliding_window_view
    sm = sliding_window_view(np.pad(base, 1, mode="wrap"), (3, 3))
    return (sm * (np.ones((3, 3)) / 9.0)).sum(axis=(2, 3)).astype(np.float32)


def _frames(dr, dc, h=128, w=160, border=9):
    tex = np.round(_texture())
    a = np.ascontiguousarray(tex[32:32 + h, 32:32 + w])
    b = tex[32 + dr:32 + dr + h, 32 + dc:32 + dc + w]
    return [(j_from_array(jnp.asarray(x), border=border,
                          border_mode="mirror"),
             t_from_array(torch.from_numpy(np.ascontiguousarray(x)),
                          border=border, border_mode="mirror"))
            for x in (a, b)]


@pytest.mark.parametrize("shift,kw", [
    ((2, 2), dict(detector_th=8, k=256, search_radius=12.0)),
    ((1, -3), dict(detector_th=10, k=128, search_radius=6.0, nscales=2,
                   winsize=9, max_refine=1.0)),
])
def test_sparse_optical_flow(shift, kw):
    (j1, t1), (j2, t2) = _frames(*shift)
    jo = jsf.sparse_optical_flow(j1, j2, **kw)
    to = tsf.sparse_optical_flow(t1, t2, **kw)
    for name in ("pos1", "valid", "distance"):
        np.testing.assert_array_equal(np.asarray(getattr(jo, name)),
                                      getattr(to, name).numpy())
    v = to.valid.numpy()
    assert v.sum() > 30
    d = np.abs(to.pos2.numpy() - np.asarray(jo.pos2)).max(1)[v]
    assert (d <= 1e-2).mean() >= 0.99
    flow = (to.pos2.numpy() - to.pos1.numpy())[v]
    np.testing.assert_allclose(np.median(flow, 0), [-s for s in shift],
                               atol=0.3)


def test_sparse_flow_no_candidate():
    """A query with no train keypoint in the radius: index 0's position,
    not valid, distance 3.4e38."""
    (j1, t1), (j2, t2) = _frames(2, 2)
    kw = dict(detector_th=8, k=64, search_radius=0.5)
    jo = jsf.sparse_optical_flow(j1, j2, **kw)
    to = tsf.sparse_optical_flow(t1, t2, **kw)
    np.testing.assert_array_equal(np.asarray(jo.valid), to.valid.numpy())
    np.testing.assert_array_equal(np.asarray(jo.distance),
                                  to.distance.numpy())
    assert (to.distance.numpy()[~to.valid.numpy()] > 1e38).all()
