"""Parity of vpp_tpu_torch.core.interp (kernel K5's plain version and the
plain samplers) with vpp_tpu.core.interp on the CPU.

Patch extraction is exact in both packages (the JAX one-hot products are
exact at ``Precision.HIGHEST``; its integer branch and the port are
gathers), so patches are compared bit for bit: float and integer data,
2-D and channel-last 3-D, centres that need clamping. The bilinear
samplers are held within 1e-5 relative (float32 arithmetic in another
order)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ji = importlib.import_module("vpp_tpu.core.interp")
ti = importlib.import_module("vpp_tpu_torch.core.interp")

torch.set_num_threads(1)


def _data(kind, shape, seed):
    rng = np.random.RandomState(seed)
    if kind == "float32":
        return (rng.rand(*shape) * 255).astype(np.float32)
    if kind == "uint8":
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.randint(0, 255, shape).astype(np.int32)


@pytest.mark.parametrize("kind", ["float32", "uint8", "int32"])
@pytest.mark.parametrize("shape", [(40, 56), (40, 56, 2), (30, 34, 3)])
@pytest.mark.parametrize("size", [3, 7])
def test_extract_patches_bit_equal(kind, shape, size):
    """The inputs of tests/test_core.py:158 and centres beyond the edges."""
    data = _data(kind, shape, size)
    rng = np.random.RandomState(5)
    ctr = np.concatenate([rng.randint(4, 26, (17, 2)),
                          [[-3, -3], [0, 55], [39, 0], [100, 100]]]
                         ).astype(np.int32)
    j = np.asarray(ji.extract_patches(jnp.asarray(data), jnp.asarray(ctr),
                                      size))
    t = ti.extract_patches(torch.from_numpy(data), torch.from_numpy(ctr),
                           size)
    assert t.dtype == torch.from_numpy(data).dtype
    np.testing.assert_array_equal(j, t.numpy())


def test_extract_patches_at_tl_and_small_cases():
    arr = np.arange(100, dtype=np.float32).reshape(10, 10)
    p = ti.extract_patches(torch.from_numpy(arr),
                           torch.tensor([[5, 5]], dtype=torch.int32), 3)
    np.testing.assert_array_equal(p[0].numpy(), arr[4:7, 4:7])
    tl = np.array([[0, 0], [7, 7], [2, 5]], np.int32)
    np.testing.assert_array_equal(
        np.asarray(ji.extract_patches_at_tl(jnp.asarray(arr),
                                            jnp.asarray(tl), 3)),
        ti.extract_patches_at_tl(torch.from_numpy(arr),
                                 torch.from_numpy(tl), 3).numpy())
    with pytest.raises(ValueError):
        ti.extract_patches(torch.from_numpy(arr),
                           torch.zeros((2, 3), dtype=torch.int32), 3)


@pytest.mark.parametrize("shape", [(12, 15), (12, 15, 2)])
def test_bilinear_nearest_and_bilinear_patches(shape):
    rng = np.random.RandomState(len(shape))
    data = (rng.rand(*shape) * 255).astype(np.float32)
    pts = (rng.rand(40, 2) * [shape[0] + 4, shape[1] + 4] - 2).astype(
        np.float32)
    jd, td = jnp.asarray(data), torch.from_numpy(data)
    np.testing.assert_allclose(
        ti.bilinear(td, torch.from_numpy(pts)).numpy(),
        np.asarray(ji.bilinear(jd, jnp.asarray(pts))), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(
        ti.nearest(td, torch.from_numpy(pts)).numpy(),
        np.asarray(ji.nearest(jd, jnp.asarray(pts))))
    ctr = (rng.rand(9, 2) * [shape[0] - 6, shape[1] - 6] + 3).astype(
        np.float32)
    np.testing.assert_allclose(
        ti.extract_patches_bilinear(td, torch.from_numpy(ctr), 5).numpy(),
        np.asarray(ji.extract_patches_bilinear(jd, jnp.asarray(ctr), 5)),
        rtol=1e-5, atol=1e-4)
