"""Parity of the port's N-d images (``vpp_tpu_torch.core.imagend``) with
vpp_tpu's on the CPU: tests/test_imagend.py's five cases, each run on both
packages and held to the same values, and the border modes,
``with_interior`` and N-linear interpolation at seeded points.

Tolerance: bit-equal throughout. ``linear_interpolate`` rounds each
product and sum in float32 in the JAX module's corner order, and JAX runs
it op by op (not under ``jax.jit``), so the bits agree."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vpp_tpu_torch.core as tcore

# the modules (the packages' ``imagend`` name is the function)
jnd = importlib.import_module("vpp_tpu.core.imagend")
tnd = importlib.import_module("vpp_tpu_torch.core.imagend")

torch.set_num_threads(1)
CPU = "cpu"


def _eq(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.dtype == j.dtype, (t.dtype, j.dtype)
    np.testing.assert_array_equal(t, j, strict=True)


def test_image3d_geometry():
    for mod, kw in ((jnd, dict(dtype=jnp.int32)),
                    (tnd, dict(dtype=torch.int32, device=CPU))):
        img1 = mod.image3d(10, 20, 30, **kw)
        img2 = mod.imagend((10, 20, 30), **kw)
        assert img1.domain() == img2.domain()
        assert img1.shape == (10, 20, 30)
        assert img1.domain().shape == (10, 20, 30)
    t = tnd.image3d(10, 20, 30, dtype=torch.int32, border=2, channels=3,
                    device=CPU)
    j = jnd.image3d(10, 20, 30, dtype=jnp.int32, border=2, channels=3)
    _eq(t.data, j.data)
    assert t.domain_with_border() == tnd.BoxNd((-2, -2, -2), (11, 21, 31))
    assert t.domain_with_border().shape == j.domain_with_border().shape


def test_image3d_content_and_subimage():
    s, r, c = np.meshgrid(np.arange(6), np.arange(7), np.arange(8),
                          indexing="ij")
    vals = (s * r * c).astype(np.int32)
    jimg = jnd.from_array_nd(jnp.asarray(vals))
    timg = tnd.from_array_nd(vals, device=CPU)
    assert int(timg(3, 4, 5)) == 3 * 4 * 5
    box = tnd.BoxNd((2, 3, 4), (5, 6, 7))
    tsub = timg | box
    jsub = jimg | jnd.BoxNd((2, 3, 4), (5, 6, 7))
    assert tsub.shape == jsub.shape == (4, 4, 4)
    _eq(tsub.data, jsub.data)
    for off in [(0, 0, 0), (0, 1, 1), (1, 1, 1), (2, 2, 2)]:
        assert int(tsub(*off)) == int(timg(2 + off[0], 3 + off[1],
                                           4 + off[2]))
    # a subimage of a bordered image keeps the parent's neighbours in its
    # border, and reads them at negative coordinates
    jb = jnd.from_array_nd(jnp.asarray(vals), border=1, border_mode="mirror")
    tb = tnd.from_array_nd(vals, border=1, border_mode="mirror", device=CPU)
    _eq((tb | box).data, (jb | jnd.BoxNd((2, 3, 4), (5, 6, 7))).data)
    assert int((tb | box)(-1, -1, -1)) == int(tb(1, 2, 3))


@pytest.mark.parametrize("mode", ["zero", "mirror", "closest"])
def test_imagend_border_and_shift(mode):
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    jimg = jnd.from_array_nd(jnp.asarray(a), border=1, border_mode=mode)
    timg = tnd.from_array_nd(a, border=1, border_mode=mode, device=CPU)
    assert timg.shape == (2, 3, 4) and timg.border == 1
    _eq(timg.data, jimg.data)
    _eq(timg.interior, a)
    for off in [(0, 0, -1), (1, -1, 0), (-1, 1, 1), (0, 0, 0)]:
        _eq(timg.shifted(*off), jimg.shifted(*off))
    if mode == "closest":
        sh = timg.shifted(0, 0, -1)
        _eq(sh[:, :, 1:], a[:, :, :-1])
        _eq(sh[:, :, 0], a[:, :, 0])
    with pytest.raises(ValueError):
        timg.shifted(0, 0, 2)
    # channels stay unpadded; nsdim picks the spatial axes
    c = np.arange(60, dtype=np.int32).reshape(3, 4, 5)
    _eq(tnd.from_array_nd(c, nsdim=2, border=2, border_mode=mode,
                          device=CPU).data,
        jnd.from_array_nd(jnp.asarray(c), nsdim=2, border=2,
                          border_mode=mode).data)


def test_imagend_trilinear_interpolation():
    vals = np.zeros((2, 2, 2), np.float32)
    vals[1, 1, 1] = 8.0
    jimg = jnd.from_array_nd(jnp.asarray(vals))
    timg = tnd.from_array_nd(vals, device=CPU)
    for p in ([0.5, 0.5, 0.5], [1.0, 1.0, 1.0]):
        _eq(timg.linear_interpolate(torch.tensor(p)),
            jimg.linear_interpolate(jnp.asarray(p)))
    assert abs(float(timg.linear_interpolate(
        torch.tensor([0.5, 0.5, 0.5]))) - 1.0) < 1e-6


def test_boxnd_grow_shrink_has():
    b = tnd.make_box3d(4, 5, 6)
    assert b.shape == (4, 5, 6)
    g = b.grow(2)
    assert g.p1 == (-2, -2, -2) and g.shape == (8, 9, 10)
    assert g.shrink(2) == b
    assert b.has((0, 0, 0)) and b.has((3, 4, 5))
    assert not b.has((4, 0, 0))
    assert tnd.make_boxNd((4, 5, 6)) == b
    jb = jnd.make_box3d(4, 5, 6)
    assert (g.p1, g.p2) == (jb.grow(2).p1, jb.grow(2).p2)
    with pytest.raises(ValueError):
        tnd.BoxNd((0, 0), (1, 1, 1))


@pytest.mark.parametrize("nd,border,channels", [(3, 1, 0), (2, 0, 3),
                                                 (4, 2, 0), (1, 1, 2)])
def test_linear_interpolate_bit_equal(nd, border, channels):
    """Seeded positions inside, on the edge of and outside the domain
    (clipped to the bordered buffer), N = 1 to 4, with channels."""
    rng = np.random.RandomState(nd * 10 + border)
    shape = tuple(rng.randint(3, 7, nd))
    full = shape + ((channels,) if channels else ())
    a = rng.rand(*full).astype(np.float32) * 50
    pos = (rng.rand(257, nd) * (np.array(shape) + 4) - 2).astype(np.float32)
    pos[0] = 0.0
    pos[1] = np.array(shape) - 1
    jimg = jnd.from_array_nd(jnp.asarray(a), nsdim=nd, border=border,
                             border_mode="mirror")
    timg = tnd.from_array_nd(a, nsdim=nd, border=border,
                             border_mode="mirror", device=CPU)
    t = timg.linear_interpolate(torch.from_numpy(pos))
    _eq(t, jimg.linear_interpolate(jnp.asarray(pos)))
    assert tuple(t.shape) == (257,) + ((channels,) if channels else ())


def test_with_interior_copies():
    """``with_interior`` writes into a copy: the caller's image and values
    stay as they were; the border is kept, values cast to the image's
    dtype."""
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    timg = tnd.from_array_nd(a, border=1, border_mode="closest", device=CPU)
    jimg = jnd.from_array_nd(jnp.asarray(a), border=1, border_mode="closest")
    before = timg.data.clone()
    vals = np.full((2, 3, 4), 7, np.int32)
    tv = torch.from_numpy(vals)
    out = timg.with_interior(tv)
    _eq(out.data, jimg.with_interior(jnp.asarray(vals)).data)
    assert torch.equal(timg.data, before)
    assert out.data.data_ptr() != timg.data.data_ptr()
    flat = tnd.from_array_nd(a, device=CPU)
    new = flat.with_interior(tv)
    _eq(new.data, jnd.from_array_nd(jnp.asarray(a)).with_interior(
        jnp.asarray(vals)).data)
    tv += 1
    assert int(new.data[0, 0, 0]) == 7


def test_astype_to_numpy_and_namespace():
    a = np.arange(8, dtype=np.float32).reshape(2, 2, 2) + 0.5
    timg = tnd.from_array_nd(a, border=1, device=CPU)
    jimg = jnd.from_array_nd(jnp.asarray(a), border=1)
    _eq(timg.astype(torch.int32).data, jimg.astype(jnp.int32).data)
    np.testing.assert_array_equal(timg.to_numpy(), jimg.to_numpy())
    assert timg.dtype == torch.float32 and timg.device.type == "cpu"
    assert tcore.ImageNd is tnd.ImageNd and tcore.image3d is tnd.image3d
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tnd.imagend((2, 2))          # the card is the default
