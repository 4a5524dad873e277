"""Parity of vpp_tpu_torch's Scharr and LBP with vpp_tpu's on the CPU.

Both are bit-equal: Scharr sums its six float32 terms left to right as the
JAX package writes them (and divides by 32, exactly); LBP compares and
packs bits. Inputs: tests/test_algorithms_basic.py:69-102, and seeded
random float and uint8 images.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpp_tpu.algorithms.lbp import (lbp_hamming_distance as j_ham,
                                    lbp_transform as j_lbp)
from vpp_tpu.algorithms.scharr import (scharr as j_scharr,
                                       scharr_point as j_scharr_point)
from vpp_tpu.core.image import from_array as j_from_array
from vpp_tpu_torch.algorithms.lbp import (lbp_hamming_distance as t_ham,
                                          lbp_transform as t_lbp)
from vpp_tpu_torch.algorithms.scharr import (scharr as t_scharr,
                                             scharr_point as t_scharr_point)
from vpp_tpu_torch.core.image import from_array as t_from_array

torch.set_num_threads(1)


def _images(kind, shape, seed):
    rng = np.random.RandomState(seed)
    if kind == "ramp":
        r, c = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                           indexing="ij")
        return (2.0 * r + 3.0 * c).astype(np.float32)
    if kind == "float":
        return (rng.rand(*shape) * 255).astype(np.float32)
    if kind == "uint8":
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.randint(0, 255, shape).astype(np.float32)


def _both(a, border, mode):
    return (j_from_array(jnp.asarray(a), border=border, border_mode=mode),
            t_from_array(torch.from_numpy(a), border=border,
                         border_mode=mode))


@pytest.mark.parametrize("kind,shape,border,mode", [
    ("ramp", (12, 14), 1, "closest"),       # test_algorithms_basic.py:69
    ("integer", (9, 9), 1, "zero"),         # :79
    ("float", (37, 53), 2, "mirror"),
    ("uint8", (30, 41), 1, "mirror"),
])
def test_scharr_bit_equal(kind, shape, border, mode):
    a = _images(kind, shape, 2)
    ji, ti = _both(a, border, mode)
    j, t = j_scharr(ji), t_scharr(ti)
    assert t.border == j.border == 0
    assert t.data.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(j.data), t.data.numpy())
    for p in [(4, 5), (0, 0), (shape[0] - 1, shape[1] - 1)]:
        np.testing.assert_array_equal(np.asarray(j_scharr_point(ji, p)),
                                      t_scharr_point(ti, p).numpy())


@pytest.mark.parametrize("kind,shape,mode", [
    ("hand", (3, 3), "zero"),               # test_algorithms_basic.py:88
    ("integer", (23, 31), "mirror"),        # ties between neighbours
    ("float", (40, 33), "closest"),
    ("uint8", (17, 64), "zero"),
])
def test_lbp_bit_equal(kind, shape, mode):
    a = (np.array([[9, 1, 9], [1, 5, 9], [9, 1, 1]], np.float32)
         if kind == "hand" else _images(kind, shape, 5))
    ji, ti = _both(a, 1, mode)
    j, t = j_lbp(ji), t_lbp(ti)
    assert t.data.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(j.data), t.data.numpy())
    if kind == "hand":
        assert int(t.data[1, 1]) == (1 << 0) | (1 << 2) | (1 << 4) | (1 << 5)


def test_lbp_hamming_bit_equal():
    """test_algorithms_basic.py:99's pairs and every pair of codes."""
    assert int(t_ham(np.uint8(0b1010), np.uint8(0b0101))) == 4
    assert int(t_ham(np.uint8(255), np.uint8(255))) == 0
    a = np.repeat(np.arange(256, dtype=np.uint8), 256)
    b = np.tile(np.arange(256, dtype=np.uint8), 256)
    t = t_ham(torch.from_numpy(a), torch.from_numpy(b))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(j_ham(a, b)), t.numpy())
