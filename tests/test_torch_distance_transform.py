"""Parity of vpp_tpu_torch's distance transforms (kernel K11's plain
version) with vpp_tpu's on the CPU.

Bit-equal: the chamfer doubling method (small integers in float32), and
the Euclidean transform's distances and displacement vectors (exact
float32 sums of squared int32 differences), pass by pass. The sweeps
method is bit-equal wherever JAX's value is below 1e9 (a seed reaches the
pixel); in a row no seed has reached yet both sides add multiples of w to
1e9 in their own order, so there the port is only held to >= 1e9.
Inputs: tests/test_geometry_matcher.py:134,144 and
tests/test_algorithms_basic.py:236.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jdt = importlib.import_module("vpp_tpu.algorithms.distance_transform")
tdt = importlib.import_module("vpp_tpu_torch.algorithms.distance_transform")

torch.set_num_threads(1)

METRICS = ["d4", "d8", "d3_4", "d5_7_11"]


def _mask(shape, p, seed, extra=None):
    rng = np.random.RandomState(seed)
    m = rng.rand(*shape) < p
    if extra is not None:
        m[extra] = True
    if not m.any():
        m[min(3, shape[0] - 1), min(5, shape[1] - 1)] = True
    return m


CHAMFER_CASES = [((20, 33), 0.05, 4, (7, 12)),    # test_geometry_matcher:134
                 ((37, 53), 0.01, 3, None),       # test_algorithms_basic:236
                 ((7, 90), 0.02, 3, None),        # thin: knight moves past it
                 ((64, 40), 0.002, 9, None)]      # sparse: unreached rows


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("case", CHAMFER_CASES)
def test_chamfer_doubling_bit_equal(metric, case):
    shape, p, seed, extra = case
    m = _mask(shape, p, seed, extra)
    j = np.asarray(jdt.chamfer_distance_transform(jnp.asarray(m), metric))
    t = tdt.chamfer_distance_transform(torch.from_numpy(m), metric)
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    np.testing.assert_array_equal(j, t.numpy())


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("case", CHAMFER_CASES)
def test_chamfer_sweeps(metric, case):
    shape, p, seed, extra = case
    m = _mask(shape, p, seed, extra)
    j = np.asarray(jdt.chamfer_distance_transform(jnp.asarray(m), metric,
                                                  method="sweeps"))
    t = tdt.chamfer_distance_transform(torch.from_numpy(m), metric,
                                       method="sweeps").numpy()
    reached = j < 1e9
    np.testing.assert_array_equal(t[reached], j[reached])
    assert (t[~reached] >= 1e9).all()
    # the reference's own recurrence gives the doubling method's result
    np.testing.assert_array_equal(
        t, tdt.chamfer_distance_transform(torch.from_numpy(m), metric)
        .numpy())


def test_named_instances_and_image_seeds():
    from vpp_tpu_torch.core.image import from_array
    m = _mask((20, 33), 0.05, 4)
    img = from_array(torch.from_numpy(m.astype(np.uint8)), border=2)
    for name in METRICS:
        want = jdt.chamfer_distance_transform(jnp.asarray(m), name)
        np.testing.assert_array_equal(
            np.asarray(want), getattr(tdt, name)(img).numpy())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdt.euclidean_distance_transform(m)      # numpy: the card by default
    d, _ = tdt.euclidean_distance_transform(m, device="cpu")
    assert d.device.type == "cpu"


@pytest.mark.parametrize("shape,p,seed,extra", [
    ((40, 40), 0.03, 5, (20, 20)),                # test_geometry_matcher:144
    ((37, 53), 0.01, 3, None),
    ((7, 90), 0.02, 3, None),
    ((96, 128), 0.001, 0, None),
    ((33, 17), 0.0, 1, None),                     # one seed
])
def test_euclidean_bit_equal(shape, p, seed, extra):
    m = _mask(shape, p, seed, extra)
    jd, jv = jdt.euclidean_distance_transform(jnp.asarray(m))
    td, tv = tdt.euclidean_distance_transform(torch.from_numpy(m))
    assert td.dtype == torch.float32 and tv.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    # the exact transform, and vectors that point at seeds
    seeds = np.argwhere(m)
    rr, cc = np.mgrid[0:shape[0], 0:shape[1]]
    brute = ((seeds[:, None, None, 0] - rr) ** 2
             + (seeds[:, None, None, 1] - cc) ** 2).min(0)
    if shape == (40, 40):
        np.testing.assert_array_equal(td.numpy().astype(np.int64), brute)
    tvn = tv.numpy()
    assert m[rr + tvn[..., 0], cc + tvn[..., 1]].all()


def test_euclidean_no_seed():
    m = np.zeros((9, 11), bool)
    jd, jv = jdt.euclidean_distance_transform(jnp.asarray(m))
    td, tv = tdt.euclidean_distance_transform(torch.from_numpy(m))
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def test_jfa_pass_plain_steps():
    """The pass schedule (N/2 ... 1, then 1) and each pass against the JAX
    loop's, on coordinates that hold no-seed entries."""
    assert tdt._steps(540, 960) == (512, 256, 128, 64, 32, 16, 8, 4, 2, 1,
                                    1)
    m = _mask((45, 60), 0.004, 7)
    h, w = m.shape
    rr, cc = np.mgrid[0:h, 0:w].astype(np.int32)
    br = np.where(m, rr, -(1 << 20)).astype(np.int32)
    bc = np.where(m, cc, -(1 << 20)).astype(np.int32)
    tr, tc = torch.from_numpy(br), torch.from_numpy(bc)
    for step in tdt._steps(h, w):
        tr, tc = tdt.jfa_pass(tr, tc, step)
    td, tv = tdt.euclidean_distance_transform(torch.from_numpy(m))
    np.testing.assert_array_equal(tv[..., 0].numpy(), (tr - torch.from_numpy(
        rr)).numpy())
