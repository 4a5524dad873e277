"""Parity of vpp_tpu_torch's core containers with vpp_tpu's on the CPU.

The same numpy inputs, made from seeds, go through the JAX function and the
port's (``device="cpu"``). Images, borders, keypoint ops and integer
pyramids must be bit-equal; the float pyramid is held within 1e-5 abs.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpp_tpu.core import border as j_border
from vpp_tpu.core import box as j_box
from vpp_tpu.core import image as j_image
from vpp_tpu.core import keypoints as j_kp
from vpp_tpu_torch.core import border as t_border
from vpp_tpu_torch.core import box as t_box
from vpp_tpu_torch.core import image as t_image
from vpp_tpu_torch.core import keypoints as t_kp

j_pyr = importlib.import_module("vpp_tpu.algorithms.pyramid")
t_pyr = importlib.import_module("vpp_tpu_torch.algorithms.pyramid")

torch.set_num_threads(1)


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("mode", ["zero", "mirror", "closest"])
@pytest.mark.parametrize("border", [0, 1, 3, 9])
@pytest.mark.parametrize("shape", [(7, 9), (5, 4, 3)])
def test_from_array_border_modes(mode, border, shape):
    rng = np.random.RandomState(border)
    a = (rng.rand(*shape) * 255).astype(np.float32)
    ji = j_image.from_array(jnp.asarray(a), border=border, border_mode=mode)
    ti = t_image.from_array(a, border=border, border_mode=mode)
    _eq(ji.data, ti.data)
    assert ti.shape == ji.shape and ti.nchannels == ji.nchannels


def test_from_array_uint8_and_box():
    a = np.random.RandomState(1).randint(0, 256, (6, 8)).astype(np.uint8)
    ti = t_image.from_array(a, border=3, border_mode="mirror")
    ji = j_image.from_array(jnp.asarray(a), border=3, border_mode="mirror")
    _eq(ji.data, ti.data)
    assert ti.dtype == torch.uint8
    assert t_box.make_box2d(5, 10) == t_box.Box2d(0, 0, 4, 9)
    for kw in (dict(border=2), dict(border=1, channels=3)):
        z = t_image.image2d(5, 10, **kw)
        _eq(j_image.image2d(5, 10, **kw).data, z.data)
        jb = j_image.image2d(5, 10, **kw).domain_with_border()
        assert (z.domain_with_border().p1, z.domain_with_border().p2) == (
            jb.p1, jb.p2)
    b = t_box.Box2d(1, 2, 3, 5)
    np.testing.assert_array_equal(b.coords(),
                                  j_box.Box2d(1, 2, 3, 5).coords())
    assert b.grow(2).shrink(2) == b and b.size() == 12


def test_image_views_match():
    rng = np.random.RandomState(2)
    a = (rng.rand(10, 12) * 255).astype(np.float32)
    ji = j_image.from_array(jnp.asarray(a), border=3, border_mode="mirror")
    ti = t_image.from_array(a, border=3, border_mode="mirror")
    _eq(ji.interior, ti.interior)
    for dr, dc in [(-3, 2), (0, 0), (3, -3), (1, -2)]:
        _eq(ji.shifted(dr, dc), ti.shifted(dr, dc))
    box = j_box.Box2d(2, 3, 6, 9)
    tbox = t_box.Box2d(2, 3, 6, 9)
    _eq(ji.subimage(box).data, ti.subimage(tbox).data)
    _eq(ji(-2, -3), ti(-2, -3))
    new = (rng.rand(10, 12) * 9).astype(np.float32)
    _eq(ji.with_interior(jnp.asarray(new)).data,
        ti.with_interior(torch.from_numpy(new)).data)
    with pytest.raises(ValueError):
        ti.shifted(4, 0)


@pytest.mark.parametrize("fill_name", [
    "fill_border_mirror", "fill_border_closest", "fill_border_with_value",
    "fill", "fill_with_border", "clone"])
def test_border_fills(fill_name):
    rng = np.random.RandomState(3)
    a = (rng.rand(6, 7) * 255).astype(np.float32)
    ji = j_image.from_array(jnp.asarray(a), border=2)
    ti = t_image.from_array(a, border=2)
    jf, tf = getattr(j_border, fill_name), getattr(t_border, fill_name)
    if fill_name in ("fill_border_with_value", "fill", "fill_with_border"):
        jo, to = jf(ji, 7.5), tf(ti, 7.5)
    elif fill_name == "clone":
        jo = jf(ji, border=3, border_mode="mirror")
        to = tf(ti, border=3, border_mode="mirror")
    else:
        jo, to = jf(ji), tf(ti)
    _eq(jo.data, to.data)


def _random_kps(rng, k, h=40, w=50):
    pos = np.stack([rng.rand(k) * (h + 6) - 3, rng.rand(k) * (w + 6) - 3],
                   -1).astype(np.float32)
    vel = rng.randn(k, 2).astype(np.float32)
    age = (rng.randint(0, 5, k) * (rng.rand(k) > 0.3)).astype(np.int32)
    return (j_kp.Keypoints(position=jnp.asarray(pos),
                           velocity=jnp.asarray(vel), age=jnp.asarray(age)),
            t_kp.Keypoints(position=torch.from_numpy(pos),
                           velocity=torch.from_numpy(vel),
                           age=torch.from_numpy(age)))


def _eq_kps(j, t):
    _eq(j.position, t.position)
    _eq(j.velocity, t.velocity)
    _eq(j.age, t.age)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keypoint_ops_bit_equal(seed):
    rng = np.random.RandomState(seed)
    k = 64
    jk, tk = _random_kps(rng, k)
    new_pos = (rng.rand(k, 2) * 40).astype(np.float32)
    ok = rng.rand(k) > 0.4
    _eq_kps(j_kp.kp_move_all(jk, jnp.asarray(new_pos), jnp.asarray(ok)),
            t_kp.kp_move_all(tk, torch.from_numpy(new_pos),
                             torch.from_numpy(ok)))
    dead = rng.rand(k) > 0.7
    _eq_kps(j_kp.kp_kill_where(jk, jnp.asarray(dead)),
            t_kp.kp_kill_where(tk, torch.from_numpy(dead)))
    for n in (5, 40, 100):
        cand = (rng.rand(n, 2) * 40).astype(np.float32)
        cvalid = rng.rand(n) > 0.5
        _eq_kps(j_kp.kp_add(jk, jnp.asarray(cand), jnp.asarray(cvalid)),
                t_kp.kp_add(tk, torch.from_numpy(cand),
                            torch.from_numpy(cvalid)))
    jc, jm = j_kp.kp_compact(jk)
    tc, tm = t_kp.kp_compact(tk)
    _eq_kps(jc, tc)
    _eq(jm, tm)
    attr = rng.randn(k, 3, 2).astype(np.float32)
    _eq(j_kp.sync_attributes(jnp.asarray(attr), jm, fill_value=-1.0),
        t_kp.sync_attributes(torch.from_numpy(attr), tm, fill_value=-1.0))
    _eq(j_kp.occupancy_grid(jk, (40, 50), cell=4),
        t_kp.occupancy_grid(tk, (40, 50), cell=4))
    assert int(tk.size()) == int(jk.size())


def test_level_shapes_match():
    for shape in [(480, 640), (96, 128), (37, 53)]:
        assert (t_pyr.level_shapes(shape, 4)
                == j_pyr.level_shapes(shape, 4))
        assert (t_pyr.level_shapes(shape, 3, 1.5)
                == j_pyr.level_shapes(shape, 3, 1.5))


@pytest.mark.parametrize("shape", [(96, 128), (61, 77)])
def test_pyramid_float_within_1e5(shape):
    """Fused float path: the banded float32 products (TF32 off). Integer-
    valued pixels keep every product and partial sum exact, so the two
    frameworks' summation orders cannot differ by more than rounding."""
    rng = np.random.RandomState(shape[0])
    for a in (rng.randint(0, 256, shape).astype(np.float32),
              (rng.rand(*shape) * 255).astype(np.float32)):
        jp = j_pyr.pyramid(j_image.from_array(jnp.asarray(a), border=9,
                                              border_mode="mirror"), 3,
                           border=9)
        tp = t_pyr.pyramid(t_image.from_array(a, border=9,
                                              border_mode="mirror"), 3,
                           border=9)
        assert len(tp) == len(jp)
        for lj, lt in zip(jp.levels, tp.levels):
            assert lt.border == lj.border
            np.testing.assert_allclose(lt.data.numpy(), np.asarray(lj.data),
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("factor", [2.0, 1.5])
def test_pyramid_integer_chain_bit_equal(factor):
    """The reference filter/subsample chain of integer pixel types."""
    a = np.random.RandomState(5).randint(0, 256, (50, 61)).astype(np.uint8)
    jp = j_pyr.pyramid(j_image.from_array(jnp.asarray(a), border=3), 3,
                       factor=factor, border=3)
    tp = t_pyr.pyramid(t_image.from_array(a, border=3), 3, factor=factor,
                       border=3)
    for lj, lt in zip(jp.levels, tp.levels):
        _eq(lj.data, lt.data)


@pytest.mark.parametrize("kind", ["integer", "float"])
def test_decimate_level_bench_shape(kind):
    """K4's plain version at the bench shape, 480x640 and 3 levels. On
    integer-valued frames every partial sum is exact, so the levels equal
    the JAX products bit for bit; on float frames within 1e-6 relative
    (float32 sums in another order)."""
    rng = np.random.RandomState(7)
    a = (rng.randint(0, 256, (480, 640)) if kind == "integer"
         else rng.rand(480, 640) * 255 + 12).astype(np.float32)
    jp = j_pyr.pyramid(j_image.from_array(jnp.asarray(a), border=9,
                                          border_mode="mirror"), 3, border=9)
    tp = t_pyr.pyramid(t_image.from_array(a, border=9, border_mode="mirror"),
                       3, border=9)
    nxt = t_pyr.decimate_level(tp[1], *t_pyr.level_shapes((480, 640), 3)[2],
                               9)
    for lj, lt in zip(jp.levels, tp.levels[:2] + (nxt,)):
        if kind == "integer":
            _eq(lj.data, lt.data)
        else:
            np.testing.assert_allclose(lt.data.numpy(), np.asarray(lj.data),
                                       rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(480, 640), (61, 77), (37, 53)])
def test_pyramid_from_raw_frame_and_strided_interior(shape):
    """K4's entry as the run loops call it: the pyramid of an unbordered
    frame, and of a bordered image's (strided) interior, equals the JAX
    pyramid of the mirrored frame bit for bit on integer-valued pixels; its
    level 0 is ``from_array(frame, border=9, border_mode="mirror")``."""
    a = np.random.RandomState(shape[1]).randint(0, 256, shape).astype(
        np.float32)
    jp = j_pyr.pyramid(j_image.from_array(jnp.asarray(a), border=9,
                                          border_mode="mirror"), 3, border=9)
    raw = t_pyr.pyramid(t_image.Image2d(data=torch.from_numpy(a), border=0),
                        3, border=9)
    bordered = t_image.from_array(a, border=5, border_mode="closest")
    assert not bordered.interior.is_contiguous()
    strided = t_pyr.pyramid(bordered, 3, border=9)
    for tp in (raw, strided):
        assert len(tp) == len(jp) == 3
        for lj, lt in zip(jp.levels, tp.levels):
            assert lt.border == lj.border == 9
            _eq(lj.data, lt.data)
    _eq(raw[0].data, t_image.from_array(a, border=9,
                                        border_mode="mirror").data)



# --- the first slice's helpers ----------------------------------------------

j_interp = importlib.import_module("vpp_tpu.core.interp")
t_interp = importlib.import_module("vpp_tpu_torch.core.interp")


@pytest.mark.parametrize("channels", [0, 3])
def test_bilinear_image_bit_equal(channels):
    """Interior coordinates, border reads included (test_core.py:115's
    sampling, through the bordered image)."""
    rng = np.random.RandomState(channels)
    shape = (9, 11, channels) if channels else (9, 11)
    a = (rng.rand(*shape) * 255).astype(np.float32)
    pts = np.concatenate([rng.rand(40, 2) * [12, 14] - 2.5,
                          [[0.0, 0.0], [8.0, 10.0], [-3.0, -3.0],
                           [0.5, 0.5]]]).astype(np.float32)
    ji = j_image.from_array(jnp.asarray(a), border=2, border_mode="mirror")
    ti = t_image.from_array(a, border=2, border_mode="mirror")
    _eq(j_interp.bilinear_image(ji, jnp.asarray(pts)),
        t_interp.bilinear_image(ti, torch.from_numpy(pts)))


def test_keypoint_helpers_bit_equal():
    """test_keypoints.py's keypoints_from_positions, kp_move and kp_remove:
    a scalar slot, a negative one and an index array naming a slot twice
    (it ages twice and takes the last of its positions, as JAX's CPU
    scatter does)."""
    pos = np.array([[0.0, 0.0], [1.0, 1.0], [2.0, 2.0], [5.0, 5.0]],
                   np.float32)
    valid = np.array([True, True, False, True])
    jk = j_kp.keypoints_from_positions(jnp.asarray(pos), jnp.asarray(valid))
    tk = t_kp.keypoints_from_positions(torch.from_numpy(pos),
                                       torch.from_numpy(valid))
    _eq_kps(jk, tk)
    moves = [(0, np.array([7.0, 4.0], np.float32)),
             (-1, np.array([6.0, 6.5], np.float32)),
             (np.array([3, 1, 3]), np.array([[1, 2], [3, 4], [5, 6]],
                                            np.float32))]
    for i, new in moves:
        jk = j_kp.kp_move(jk, jnp.asarray(i), jnp.asarray(new))
        tk = t_kp.kp_move(tk, i, torch.from_numpy(new))
        _eq_kps(jk, tk)
    assert int(tk.age[3]) == 4 and tk.position[3].tolist() == [5.0, 6.0]
    for i in (1, np.array([0, 2, 0])):
        jk = j_kp.kp_remove(jk, jnp.asarray(i))
        tk = t_kp.kp_remove(tk, i)
        _eq_kps(jk, tk)
    assert int(tk.size()) == 1


def test_scatter_last_rule():
    """``.at[i].set(src, mode="drop")`` with repeats: the last writer in
    index order; indices outside the buffer are dropped."""
    out = torch.zeros((4, 2))
    idx = torch.tensor([2, 0, 2, 9, -1, 0])
    src = torch.arange(12, dtype=torch.float32).view(6, 2)
    got = t_kp.scatter_last(out, idx, src)
    assert got.tolist() == [[10, 11], [0, 0], [4, 5], [0, 0]]


@pytest.mark.parametrize("border", [0, 2])
def test_copy_and_copy_with_border(border):
    rng = np.random.RandomState(border)
    a = (rng.rand(6, 7) * 255).astype(np.float32)
    b = rng.randint(0, 256, (6, 7)).astype(np.uint8)
    for mode in ("zero", "mirror"):
        js = j_image.from_array(jnp.asarray(a), border=border,
                                border_mode=mode)
        ts = t_image.from_array(a, border=border, border_mode=mode)
        jd = j_image.from_array(jnp.asarray(b), border=border,
                                border_mode="closest")
        td = t_image.from_array(b, border=border, border_mode="closest")
        for name in ("copy", "copy_with_border"):
            jo = getattr(j_border, name)(js, jd)
            to = getattr(t_border, name)(ts, td)
            _eq(jo.data, to.data)
            assert to.border == jo.border and to.dtype == torch.uint8
    with pytest.raises(ValueError):
        t_border.copy(ts, t_image.from_array(np.zeros((5, 7), np.float32)))


@pytest.mark.parametrize("shape", [(8, 128), (5, 9), (13, 130, 3)])
def test_pad_to_multiple_bit_equal(shape):
    a = np.random.RandomState(len(shape)).rand(*shape).astype(np.float32)
    for kw in (dict(), dict(row_mult=4, col_mult=16, value=-1.5)):
        _eq(j_image.pad_to_multiple(jnp.asarray(a), **kw),
            t_image.pad_to_multiple(torch.from_numpy(a), **kw))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("border", [0, 1, 3])
def test_antialias_subsample2_bit_equal(dtype, border):
    """test_algorithms_basic.py's filter and decimation inputs, through
    ``antialias_subsample2`` (a border below 2 gets a 2-px mirror pad)."""
    rng = np.random.RandomState(border)
    a = (rng.rand(21, 30) * 255).astype(dtype)
    jo = j_pyr.antialias_subsample2(j_image.from_array(
        jnp.asarray(a), border=border, border_mode="mirror"))
    to = t_pyr.antialias_subsample2(t_image.from_array(
        a, border=border, border_mode="mirror"))
    assert to.border == jo.border == max(border, 1)
    if dtype == np.uint8:
        _eq(jo.data, to.data)
    else:
        np.testing.assert_allclose(to.data.numpy(), np.asarray(jo.data),
                                   rtol=0, atol=1e-4)


def test_pyramid_update_keeps_geometry():
    """``pyramid_update`` rebuilds a pyramid's levels, factor and border
    from a new frame: equal to JAX's within the float pyramid's 1e-5."""
    rng = np.random.RandomState(3)
    a, b = (rng.randint(0, 256, (61, 77)).astype(np.float32)
            for _ in range(2))
    jp = j_pyr.pyramid(j_image.from_array(jnp.asarray(a), border=5), 3,
                       border=5)
    tp = t_pyr.pyramid(t_image.from_array(a, border=5), 3, border=5)
    ju = j_pyr.pyramid_update(jp, j_image.from_array(jnp.asarray(b)))
    tu = t_pyr.pyramid_update(tp, t_image.from_array(b))
    assert len(tu) == 3 and tu.factor == jp.factor
    for lj, lt in zip(ju.levels, tu.levels):
        assert lt.border == lj.border == 5
        np.testing.assert_allclose(lt.data.numpy(), np.asarray(lj.data),
                                   rtol=0, atol=1e-5)
