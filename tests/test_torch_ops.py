"""Parity of the port's loop constructs, windows, scans, reductions and LIIE
expressions (``vpp_tpu_torch.ops``) with vpp_tpu's on the CPU, on the
input sets of tests/test_ops.py and a few more (ragged blocks with image
output, tuple results, int32 overflow, 3-channel arg-extrema).

Each case runs once against each package through a small namespace (its
image constructor, its ``ops`` and its array module), so the kernels are
the same Python code. Tolerance: bit-equal, dtype and shape included,
where JAX is exact (integer and integer-valued float arithmetic, selects,
orderings); ``avg`` and the sum of random float32 values within 1e-6
relative (the summation order differs)."""

import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpp_tpu.core import from_array as j_from_array, make_box2d as j_box
from vpp_tpu_torch.core import from_array as t_from_array
from vpp_tpu_torch.core import make_box2d as t_box
from vpp_tpu_torch.core.image import Image2d

jops = importlib.import_module("vpp_tpu.ops")
tops = importlib.import_module("vpp_tpu_torch.ops")

torch.set_num_threads(1)

J = types.SimpleNamespace(
    xp=jnp, ops=jops, box=j_box, arr=jnp.asarray,
    img=lambda a, border=0, mode="zero": j_from_array(
        jnp.asarray(a), border=border, border_mode=mode))
T = types.SimpleNamespace(
    xp=torch, ops=tops, box=t_box, arr=torch.as_tensor,
    img=lambda a, border=0, mode="zero": t_from_array(
        np.asarray(a), border=border, border_mode=mode))


class _Img:
    def __init__(self, border, data):
        self.border, self.data = border, data


def _np(x):
    """Results as comparable host values (an image as its border and
    bordered buffer)."""
    if isinstance(x, Image2d) or hasattr(x, "border"):
        return _Img(x.border, _np(x.data))
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _same(j, t, path="out"):
    if isinstance(j, _Img):
        assert isinstance(t, _Img), path
        assert j.border == t.border, (path, "border", j.border, t.border)
        return _same(j.data, t.data, path + ".data")
    if isinstance(j, (tuple, list)):
        assert type(j) is type(t) and len(j) == len(t), path
        for i, (a, b) in enumerate(zip(j, t)):
            _same(a, b, f"{path}[{i}]")
        return
    if isinstance(j, dict):
        assert j.keys() == t.keys(), path
        for k in j:
            _same(j[k], t[k], f"{path}[{k!r}]")
        return
    assert j.dtype == t.dtype, (path, j.dtype, t.dtype)
    np.testing.assert_array_equal(t, j, err_msg=path, strict=True)


# --- the cases: each takes a package namespace and returns its results -----

def pw_add(P):
    a = P.img(np.arange(12, dtype=np.float32).reshape(3, 4))
    b = P.img(np.ones((3, 4), np.float32))
    return P.ops.pixel_wise(a, b) | (lambda x, y: x + y)


def pw_coords(P):
    return P.ops.pixel_wise(P.box(3, 4)) | (lambda p: p[0] * 10 + p[1])


def pw_stencil(P):
    img = P.img(np.arange(16, dtype=np.float32).reshape(4, 4), border=1)
    return P.ops.pixel_wise(P.ops.relative_access(img)) | (
        lambda n: n(0, -1) + n(0, 1) + n(-1, 0) + n(1, 0))


def pw_stencil_mirror_center(P):
    rng = np.random.RandomState(3)
    img = P.img(rng.randint(0, 255, (6, 9)).astype(np.int32), border=2,
                mode="mirror")
    return P.ops.pixel_wise(P.ops.relative_access(img)) | (
        lambda n: 4 * n.center - n(-2, 0) - n(2, 0) - n(0, -2) - n(0, 2))


def pw_tuple_out_border(P):
    """Two results from one kernel, each wrapped with ``out_border``; the
    option given through ``pixel_wise(...)(out_border=...)`` and .apply."""
    a = P.img(np.arange(20, dtype=np.float32).reshape(4, 5))
    box = P.box(4, 5)
    first = P.ops.pixel_wise(a, box, out_border=1) | (
        lambda x, p: (x * 2, x > p[1]))
    second = P.ops.pixel_wise(a)(out_border=2).apply(lambda x: x - 1)
    none = P.ops.pixel_wise(a) | (lambda x: None)
    return first, second, none is None


def bw_scalar_per_block(P):
    arr = np.arange(64, dtype=np.float32).reshape(8, 8)
    return P.ops.block_wise((4, 4), P.img(arr)) | (
        lambda blk, valid: P.xp.sum(P.xp.where(valid, blk, 0)))


def bw_ragged(P):
    return P.ops.block_wise((4, 4), P.img(np.ones((5, 7), np.float32))) | (
        lambda blk, valid: P.xp.sum(P.xp.where(valid, blk, 0)))


def bw_image_output(P):
    arr = np.arange(16, dtype=np.float32).reshape(4, 4)
    return P.ops.block_wise((2, 2), P.img(arr)) | (
        lambda blk, valid: blk * 2)


def bw_ragged_image_and_mask(P):
    """Ragged 16x16 blocks of a 37x53 image: the image output cropped
    back, the mask itself, and a per-block (max, count) pair."""
    rng = np.random.RandomState(1)
    a = P.img(rng.randint(-50, 50, (37, 53)).astype(np.int32), border=1)
    b = P.img(rng.rand(37, 53).astype(np.float32))
    return P.ops.block_wise((16, 16), a, b).apply(
        lambda x, y, valid: (x * 3 + 1, y * 0.5, valid,
                             P.xp.max(P.xp.where(valid, x, -1000)),
                             P.xp.sum(valid * 1, dtype=P.xp.int32)))


def rw_sum(P):
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    return P.ops.row_wise(P.img(arr)) | (lambda row: P.xp.sum(row))


def rw_image_out(P):
    arr = np.arange(12, dtype=np.int32).reshape(3, 4)
    return P.ops.row_wise(P.img(arr), P.img(arr * 2)) | (
        lambda r, s: (r + s, P.xp.max(s)))


def _count(carry, col):
    out = carry + 1
    return out, out


def _prefix(carry, row):
    s = carry + row
    return s, s


def scan_l2r(P):
    return P.ops.scan_left_to_right(_count, P.arr(np.full(3, -1.0,
                                                          np.float32)),
                                    P.img(np.zeros((3, 5), np.float32)))


def scan_r2l(P):
    return P.ops.scan_right_to_left(_count, P.arr(np.full(3, -1.0,
                                                          np.float32)),
                                    P.img(np.zeros((3, 5), np.float32)))


def scan_t2b(P):
    return P.ops.scan_top_to_bottom(_prefix, P.arr(np.zeros(3, np.float32)),
                                    P.img(np.ones((4, 3), np.float32)))


def scan_b2t(P):
    return P.ops.scan_bottom_to_top(_prefix, P.arr(np.zeros(3, np.float32)),
                                    P.img(np.ones((4, 3), np.float32)))


def scan_two_images_reverse(P):
    """A reverse column sweep over two images with a running max: the
    outputs at their slices' indices, the final carry beside them."""
    rng = np.random.RandomState(5)
    a = P.img(rng.randint(0, 100, (6, 7)).astype(np.int32), border=2)
    b = P.img(rng.randint(0, 3, (6, 7)).astype(np.int32))

    def fn(c, x, y):
        m = P.xp.maximum(c, x * y)
        return m, m - x

    return P.ops.scan_right_to_left(fn, P.arr(np.zeros(6, np.int32)), a, b)


def dpw_int32_running_sum(P):
    rng = np.random.RandomState(2)
    img = P.img(rng.randint(0, 1000, (9, 11)).astype(np.int32), border=1)
    return [P.ops.directional_pixel_wise(
        d, _prefix, P.arr(np.zeros(n, np.int32)), img)
        for d, n in (("left_to_right", 9), ("right_to_left", 9),
                     ("top_to_bottom", 11), ("bottom_to_top", 11))]


def reductions_int(P):
    img = P.img(np.arange(12, dtype=np.int32).reshape(3, 4), border=2)
    o = P.ops
    return (o.sum_(img), o.min_(img), o.max_(img), o.argmin(img),
            o.argmax(img))


def reductions_float_exact(P):
    rng = np.random.RandomState(4)
    img = P.img(rng.randint(-9, 9, (13, 17)).astype(np.float32), border=1,
                mode="closest")
    o = P.ops
    return (o.sum_(img), o.min_(img), o.max_(img), o.argmin(img),
            o.argmax(img))


def reductions_ties_and_channels(P):
    """The first extremum on ties; a 3-channel image sums its channels
    (integer and float) before the arg-extremum; uint8 and bool sums are
    int32."""
    a = np.zeros((5, 6), np.int32)
    a[1, 2] = a[3, 4] = 7
    a[2, 1] = a[4, 0] = -3
    rng = np.random.RandomState(6)
    c3 = rng.randint(0, 255, (5, 6, 3)).astype(np.uint8)
    f3 = rng.rand(5, 6, 3).astype(np.float32)
    o = P.ops
    return (o.argmax(P.img(a)), o.argmin(P.img(a)), o.argmax(P.img(c3)),
            o.argmin(P.img(c3)), o.argmax(P.img(f3)), o.argmin(P.img(f3)),
            o.sum_(P.img(c3)), o.sum_(P.img(a > 0)))


def reductions_int32_overflow(P):
    """A true sum of 16 * 2^30 = 2^34: int32 arithmetic wraps it."""
    img = P.img(np.full((4, 4), 2 ** 30, np.int32))
    img2 = P.img(np.arange(64, dtype=np.int32).reshape(8, 8) * 2 ** 26 + 7)
    return P.ops.sum_(img), P.ops.sum_(img2)


def window_offsets(P):
    return [np.asarray(w, np.int32) for w in (P.ops.C4, P.ops.C5, P.ops.C8,
                                              P.ops.C9)]


def window_erosion(P):
    arr = np.full((4, 4), 9.0, np.float32)
    arr[2, 2] = 1.0
    img = P.img(arr, border=1, mode="closest")
    return P.xp.amin(P.ops.window_stack(img, P.ops.C9), 0)


def window_stacks(P):
    rng = np.random.RandomState(7)
    img = P.img(rng.randint(0, 50, (6, 5)).astype(np.int32), border=1,
                mode="mirror")
    return [P.ops.window_stack(img, w) for w in (P.ops.C4, P.ops.C5,
                                                 P.ops.C8, P.ops.C9)]


def window_foreach(P):
    seen = []
    P.ops.window_foreach(P.ops.C8, seen.append)
    return np.asarray(seen, np.int32)


def expr_eval(P):
    a = P.img(np.arange(6, dtype=np.float32).reshape(2, 3))
    b = P.img(np.ones((2, 3), np.float32))
    return P.ops.evaluate(P.ops.P1 + 2 * P.ops.P2, a, b)


def expr_value_of_and_if(P):
    a = P.img(np.arange(6, dtype=np.float32).reshape(2, 3))
    return P.ops.evaluate(P.ops.if_(P.ops.V(a) > 2)(1.0)(0.0))


def expr_global_reduction(P):
    a = P.img(np.arange(6, dtype=np.float32).reshape(2, 3))
    return P.ops.evaluate(P.ops.sum_of(P.ops.P1 * P.ops.P1), a)


def expr_operators(P):
    """Every operator and reduction on integer-valued images."""
    rng = np.random.RandomState(8)
    a = P.img(rng.randint(-20, 20, (5, 7)).astype(np.float32))
    b = P.img(rng.randint(1, 9, (5, 7)).astype(np.int32), border=1)
    o = P.ops
    x, y = o.P1, o.P2
    exprs = [x - y, 3 - x, x / y, 12 / y, x / 3, y / 7, 2.5 / x, -x, x * x - 5 * y, x < y,
             x <= 0, x >= y, x.eq(y), x.ne(0), o.if_(x > y)(x)(y * 2),
             o.if_(x.eq(0))(-1)(x + 0.5), o.sum_of(x * y), o.sum_of(y),
             o.sum_of(y > 4), o.min_of(x - y), o.max_of(x), o.avg_of(y),
             o.argmin_of(x), o.argmax_of(x * y), o.argmax_of(y)]
    return [o.evaluate(e, a, b) for e in exprs]


def expr_value_images(P):
    """No placeholder: the shape comes from the first V, and a result of
    another shape stays a tensor."""
    a = P.img(np.arange(12, dtype=np.int32).reshape(3, 4))
    b = P.img(np.arange(12, dtype=np.int32).reshape(3, 4)[::-1].copy())
    o = P.ops
    return (o.evaluate(o.V(a) * o.V(b) + 1),
            o.evaluate(o.argmax_of(o.V(a) - o.V(b))),
            o.evaluate(o.max_of(a)))


CASES = [pw_add, pw_coords, pw_stencil, pw_stencil_mirror_center,
         pw_tuple_out_border, bw_scalar_per_block, bw_ragged,
         bw_image_output, bw_ragged_image_and_mask, rw_sum, rw_image_out,
         scan_l2r, scan_r2l, scan_t2b, scan_b2t, scan_two_images_reverse,
         dpw_int32_running_sum, reductions_int, reductions_float_exact,
         reductions_ties_and_channels, reductions_int32_overflow,
         window_offsets, window_erosion, window_stacks, window_foreach,
         expr_eval, expr_value_of_and_if, expr_global_reduction,
         expr_operators, expr_value_images]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_bit_equal_to_jax(case):
    _same(_np(case(J)), _np(case(T)))


def test_test_ops_expectations():
    """tests/test_ops.py's own expected values hold for the port."""
    out = pw_coords(T).to_numpy()
    np.testing.assert_array_equal(out, np.add.outer(np.arange(3) * 10,
                                                    np.arange(4)))
    np.testing.assert_array_equal(bw_ragged(T).numpy(), [[16, 12], [4, 3]])
    _, out = scan_r2l(T)
    np.testing.assert_array_equal(
        out.numpy(), np.tile(np.arange(4, -1, -1, dtype=np.float32), (3, 1)))
    s, mn, mx, amin, amax = reductions_int(T)
    assert int(s) == 66 and int(mn) == 0 and int(mx) == 11
    assert amin.tolist() == [0, 0] and amax.tolist() == [2, 3]
    er = window_erosion(T).numpy()
    assert er[2, 2] == 1.0 and er[1, 1] == 1.0 and er[0, 0] == 9.0
    assert float(expr_global_reduction(T)) == 55.0


def test_int32_sum_wraps():
    """The port's int32 sum is the true sum modulo 2^32 (PyTorch's own
    would be the int64 2^34)."""
    s, s2 = reductions_int32_overflow(T)
    assert s.dtype == torch.int32 and int(s) == 0
    true2 = int((np.arange(64, dtype=np.int64) * 2 ** 26 + 7).sum())
    assert true2 > 2 ** 31
    assert int(s2) == (true2 + 2 ** 31) % 2 ** 32 - 2 ** 31
    wide = tops.sum_(T.img(np.full((4, 4), 2 ** 30, np.int32)),
                     dtype=torch.int64)
    assert int(wide) == 2 ** 34


@pytest.mark.parametrize("shape", [(7, 9), (64, 80), (33, 47, 3)])
def test_avg_and_float_sum_within_tolerance(shape):
    """avg and the sum of random float32 values: within 1e-6 relative of
    JAX (another summation order)."""
    a = np.random.RandomState(9).rand(*shape).astype(np.float32) * 100
    for name in ("avg", "sum_"):
        j = np.asarray(getattr(jops, name)(J.img(a, border=1)))
        t = getattr(tops, name)(T.img(a, border=1))
        assert t.dtype == torch.float32 and t.dim() == 0
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=0)
        np.testing.assert_allclose(float(t), a.astype(np.float64).sum()
                                   / (a.size if name == "avg" else 1),
                                   rtol=1e-6)


def test_coords_follow_the_domain_device():
    """A box beside an image takes the image's device; alone, the CPU."""
    img = T.img(np.zeros((2, 3), np.float32))
    out = tops.pixel_wise(img, T.box(2, 3)) | (lambda x, p: x + p[1])
    assert out.data.device == img.data.device
    c = tops.Coords(T.box(2, 3))
    assert c.rows.dtype == torch.int32 and c.cols.device.type == "cpu"
    np.testing.assert_array_equal(c[0].numpy(), [[0, 0, 0], [1, 1, 1]])
