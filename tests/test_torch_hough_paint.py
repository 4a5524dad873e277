"""Parity of vpp_tpu_torch's drawing (``draw/draw.py``) and Hough track
painter (``draw/hough_paint.py``) with vpp_tpu's on the CPU.

Inputs: ``tests/test_draw_utils.py``'s primitives and
``tests/test_hough_paint.py``'s tracked line, with the tracker state made
by JAX and carried over (``convert``), so both painters see the same
state. Where samples of one primitive or one track hit a pixel, they
write equal values, and every pixel is compared bit for bit. Where two
tracks (or two trajectory segments) hit one pixel, the port writes the
sample last in flat order (the higher slot, then the later sample); JAX's
scatter leaves that open, so on the two-line clip the pixels written by
two or more tracks are compared with that rule and not with JAX, and all
the others with JAX. ``track_support_points`` must be equal: points, ok,
and JAX's lower-index-first order among equal magnitudes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpp_tpu.algorithms import hough_tracker as jht
from vpp_tpu.core import from_array as j_from_array
from vpp_tpu.draw import draw as jd
from vpp_tpu.draw import hough_paint as jp
from vpp_tpu_torch import convert
from vpp_tpu_torch.core.image import from_array as t_from_array
from vpp_tpu_torch.draw import draw as td
from vpp_tpu_torch.draw import hough_paint as tp
from vpp_tpu_torch.utils.clips import synthetic_line_clip

torch.set_num_threads(1)
H, W = 96, 128


def _img_pair(shape):
    z = np.zeros(shape, np.float32)
    return j_from_array(jnp.asarray(z)), t_from_array(z)


def _eq(j, t):
    j = j.data if hasattr(j, "data") else j
    t = t.data if hasattr(t, "data") else t
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_plot_color_and_blend():
    ji, ti = _img_pair((10, 10, 3))
    pts = np.array([[2, 3], [50, 50], [-1, 0], [2, 3]])
    jo = jd.plot_color(ji, jnp.asarray(pts), (255, 0, 0))
    to = td.plot_color(ti, torch.from_numpy(pts), (255, 0, 0))
    _eq(jo, to)
    assert float(to.data.sum()) == 255.0
    j2 = jd.plot_color(jo, jnp.array([[2, 3]]), (0, 255, 0),
                       alpha=jnp.array([0.5]))
    t2 = td.plot_color(to, torch.tensor([[2, 3]]), (0, 255, 0),
                       alpha=torch.tensor([0.5]))
    _eq(j2, t2)
    assert np.allclose(t2.data.numpy()[2, 3], [127.5, 127.5, 0])
    # a bordered target and a validity mask
    jb = j_from_array(jnp.zeros((8, 8), jnp.float32), border=2)
    tb = t_from_array(np.zeros((8, 8), np.float32), border=2)
    pts = np.array([[0, 0], [-2, -2], [9, 9], [7, 7]])
    ok = np.array([True, True, True, False])
    _eq(jd.plot_color(jb, jnp.asarray(pts), 3.0, valid=jnp.asarray(ok)),
        td.plot_color(tb, torch.from_numpy(pts), 3.0,
                      valid=torch.from_numpy(ok)))


@pytest.mark.parametrize("p1,p2,n", [((2, 2), (2, 12), None),
                                     ((0, 0), (15, 15), None),
                                     ((3, 1), (14, 9), 7),
                                     ((-4, 5), (20, 11), None)])
def test_draw_line(p1, p2, n):
    ji, ti = _img_pair((16, 16))
    _eq(jd.draw_line(ji, p1, p2, 7.0, n), td.draw_line(ti, p1, p2, 7.0, n))
    jpts, _ = jd.line_points(p1, p2, 9)
    tpts, _ = td.line_points(p1, p2, 9)
    _eq(jpts, tpts)


def test_draw_line_covers_bresenham_pixels():
    _, ti = _img_pair((16, 16))
    a = td.draw_line(ti, (2, 2), (2, 12), 7.0).data.numpy()
    assert (a[2, 2:13] == 7.0).all() and a.sum() == 7.0 * 11
    d = td.draw_line(ti, (0, 0), (15, 15), 1.0).data.numpy()
    assert np.trace(d) == 16.0 and d.sum() == 16.0


@pytest.mark.parametrize("fill", [True, False])
def test_draw_square(fill):
    ji, ti = _img_pair((12, 12))
    for centre, half in (((5, 5), 2), ((0, 11), 3)):
        _eq(jd.draw_square(ji, centre, half, 3.0, fill=fill),
            td.draw_square(ti, centre, half, 3.0, fill=fill))
    t = td.draw_square(ti, (5, 5), 2, 3.0, fill=fill).data.numpy()
    assert t.sum() == 3.0 * (25 if fill else 16)


@pytest.mark.parametrize("channels", [3, 0])
def test_draw_trajectories(channels):
    """test_draw_utils.py's trajectory, plus a second live track crossing
    it and a dead one: consecutive segments share their end pixels with
    other alphas, and JAX's scatter lets the later sample win there too,
    so every pixel is equal."""
    shape = (32, 32, channels) if channels else (32, 32)
    ji, ti = _img_pair(shape)
    traj = np.zeros((4, 5, 2), np.float32)
    traj[0] = [[5, 5], [5, 9], [5, 13], [0, 0], [0, 0]]
    traj[1] = [[2, 9], [9, 9], [14, 12], [20, 20], [25, 3]]
    traj[2] = [[30, 30], [1, 1], [0, 0], [0, 0], [0, 0]]
    n = np.array([3, 5, 2, 0], np.int32)
    alive = np.array([True, True, False, False])
    jo = jd.draw_trajectories(ji, jnp.asarray(traj), jnp.asarray(n),
                              jnp.asarray(alive))
    to = td.draw_trajectories(ti, torch.from_numpy(traj),
                              torch.from_numpy(n), torch.from_numpy(alive))
    _eq(jo, to)
    a = to.data.numpy()
    assert a[5, 5:14].sum() > 0 and a[28:].sum() == 0


def _line_img(col):
    a = np.zeros((H, W), np.float32)
    a[:, col] = 255.0
    return a


def _jax_state(frames, **kw):
    cfg = jht.HoughTrackerConfig(**kw)
    st = jht.hough_tracker_init(cfg)
    for f in frames:
        st, _ = jht.hough_tracker_update(
            st, j_from_array(jnp.asarray(f), border=3), cfg)
    return st, cfg


def _both(st):
    m = {f.name: np.asarray(getattr(st, f.name))
         for f in dataclasses.fields(st)}
    return st, convert.hough_tracker_state_from_numpy(m, device="cpu")


@pytest.fixture(scope="module")
def tracked():
    """test_hough_paint.py's tracked vertical line (columns 58, 59, 60)."""
    st, cfg = _jax_state([_line_img(c) for c in (58, 59, 60)], capacity=8,
                         m_first_lines=4, acc_threshold=10.0)
    return _both(st) + ((cfg.t_theta, int(np.ceil(np.hypot(H, W)))),)


def test_track_support_points_on_line():
    img = _line_img(60)
    ji = j_from_array(jnp.asarray(img), border=3)
    ti = t_from_array(img, border=3)
    ti_idx = np.array([127, 127, 3], np.float32)
    ri_idx = np.array([1120, 1100, 50], np.float32)
    for k in (32, 64):
        j = jp.track_support_points(ji, jnp.asarray(ti_idx),
                                    jnp.asarray(ri_idx),
                                    jnp.array([True, True, False]), k=k)
        t = tp.track_support_points(ti, torch.from_numpy(ti_idx),
                                    torch.from_numpy(ri_idx),
                                    torch.tensor([True, True, False]), k=k)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # test_hough_paint.py:36: the strongest cell's support hugs the line
    from vpp_tpu_torch.algorithms.hough import hough_accumulator, hough_top_k
    pk = hough_top_k(hough_accumulator(ti), 1)
    pts, ok = tp.track_support_points(ti, pk.theta_idx, pk.rho_idx,
                                      torch.tensor([True]), k=32)
    assert int(ok[0].sum()) >= 16
    assert (np.abs(pts[0][ok[0]][:, 1].numpy() - 60) <= 2).all()


def test_paint_decays_and_paints(tracked):
    jst, tst, acc_shape = tracked
    paint = np.zeros((H, W, 4), np.float32)
    paint[..., 3] = 200.0
    j = np.asarray(jp.paint_hough_video(jnp.asarray(paint), jst, acc_shape))
    t = tp.paint_hough_video(torch.from_numpy(paint), tst, acc_shape)
    np.testing.assert_array_equal(j, t.numpy())
    out = t.numpy()
    np.testing.assert_allclose(out[:, :20, 3], 200.0 * 0.97, rtol=1e-5)
    painted = (out[..., 3] > 200) | (out[..., :3].sum(-1) > 0)
    assert painted[:, 55:66].any()


def test_draw_line_tracks_renders_segment(tracked):
    jst, tst, acc_shape = tracked
    frame = np.zeros((H, W, 3), np.uint8)
    j = np.asarray(jp.draw_line_tracks(jnp.asarray(frame), jst, acc_shape))
    t = tp.draw_line_tracks(torch.from_numpy(frame), tst, acc_shape)
    assert t.dtype == torch.uint8
    np.testing.assert_array_equal(j, t.numpy())
    out = t.numpy()
    assert out[:, 55:66].astype(np.int32).sum() > 0 and out[:, :30].sum() == 0


def _writers(tst, acc_shape, n):
    """(H, W) count of distinct live tracks whose samples hit each pixel."""
    live = tst.age > 0
    _, _, r, c = tp._segment_samples(tst, acc_shape, H, W, n, live)
    hit = np.zeros((tst.age.shape[0], H, W), bool)
    for s in range(r.shape[0]):
        ok = r[s] < H
        hit[s, r[s][ok].numpy(), c[s][ok].numpy()] = True
    return hit


def test_two_line_clip_painter_and_duplicate_rule():
    """The two-line clip after 8 frames (several live tracks, segments
    crossing): pixels with one writer equal JAX's; pixels with two or
    more take the highest live slot's colour (the stated rule)."""
    frames = synthetic_line_clip(W, H, 8)
    jst, cfg = _jax_state(frames, m_first_lines=8, acc_threshold=10.0)
    jst, tst = _both(jst)
    acc_shape = (cfg.t_theta, int(np.ceil(np.hypot(H, W))))
    frame = (np.random.RandomState(0).rand(H, W, 3) * 255).astype(np.uint8)
    j = np.asarray(jp.draw_line_tracks(jnp.asarray(frame), jst, acc_shape,
                                       max_fwu=5))
    t = tp.draw_line_tracks(torch.from_numpy(frame), tst, acc_shape).numpy()
    hit = _writers(tst, acc_shape, 256)
    nw = hit.sum(0)
    assert (nw >= 2).any(), "no crossing: the rule is not exercised"
    # the 3x3 markers write after the segments; leave their pixels out
    centre = torch.round(sum(tp._segment_samples(
        tst, acc_shape, H, W, 256, tst.age > 0)[:2]) / 2).int().numpy()
    marker = np.zeros((H, W), bool)
    for s in np.flatnonzero(tst.age.numpy() > 0):
        r0, c0 = centre[s]
        marker[max(r0 - 1, 0):r0 + 2, max(c0 - 1, 0):c0 + 2] = True
    one = (nw <= 1) & ~marker
    np.testing.assert_array_equal(j[one], t[one])
    many = (nw >= 2) & ~marker
    top = (hit * np.arange(1, hit.shape[0] + 1)[:, None, None]).argmax(0)
    base = frame.astype(np.float32)
    from vpp_tpu_torch.ops.color import hsv_to_rgb
    hues = torch.tensor([i * 137.5 % 360.0 for i in range(32)])
    color = hsv_to_rgb(hues, 1.0, 1.0).float().numpy()
    fade = np.clip(1.0 - tst.fwu.numpy().astype(np.float32) / 6, 0.2, 1.0)
    s = top[many]
    want = base[many] * (1 - fade[s][:, None]) + color[s] * fade[s][:, None]
    np.testing.assert_array_equal(
        t[many], np.clip(want, 0, 255).astype(np.uint8))
    # the paint buffer: alpha (the largest write) equal everywhere
    paint = np.zeros((H, W, 4), np.float32)
    jpaint = np.asarray(jp.paint_hough_video(jnp.asarray(paint), jst,
                                             acc_shape))
    tpaint = tp.paint_hough_video(torch.from_numpy(paint), tst,
                                  acc_shape).numpy()
    np.testing.assert_array_equal(jpaint[..., 3], tpaint[..., 3])
    one = _writers(tst, acc_shape, 128).sum(0) <= 1
    np.testing.assert_array_equal(jpaint[one], tpaint[one])


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("channels", [3, 4])
def test_color_conversions_bit_equal(dtype, channels):
    """The painter's colours (``ops/color.py``): gray from 3 or 4 channels
    (integers floor-divided in int32), gray to RGB, and ``hsv_to_rgb``
    over the whole hue circle and past it, truncating to uint8."""
    from vpp_tpu.ops import color as jc
    from vpp_tpu_torch.ops import color as tc
    rng = np.random.RandomState(channels)
    a = (rng.rand(7, 9, channels) * 255).astype(dtype)
    ji = j_from_array(jnp.asarray(a), border=1, border_mode="mirror")
    ti = t_from_array(a, border=1, border_mode="mirror")
    _eq(jc.rgb_to_graylevel(ji), tc.rgb_to_graylevel(ti))
    _eq(jc.rgb_to_graylevel(ji, jnp.float32),
        tc.rgb_to_graylevel(ti, torch.float32))
    g = tc.rgb_to_graylevel(ti)
    _eq(jc.graylevel_to_rgb(jc.rgb_to_graylevel(ji)),
        tc.graylevel_to_rgb(g))
    hue = np.concatenate([np.arange(-30, 400, 0.25),
                          rng.rand(500) * 360]).astype(np.float32)
    for s, v in ((1.0, 1.0), (0.6, 0.8)):
        _eq(jc.hsv_to_rgb(jnp.asarray(hue), s, v),
            tc.hsv_to_rgb(torch.from_numpy(hue), s, v))


def test_nan_tracks_paint_as_jax():
    """Tracks whose filter went NaN (the reference's Kalman mode does
    that): their samples convert to 0 as XLA converts NaN, and the port
    paints what JAX paints (a plain ``.to`` gives INT_MIN on the CPU and 0
    on the card)."""
    frames = [_line_img(c) for c in (58, 59, 60)]
    jst, cfg = _jax_state(frames, capacity=8, m_first_lines=4,
                          acc_threshold=10.0)
    nan = jnp.full_like(jst.theta, jnp.nan)
    jst = jst.replace(theta=nan, rho=nan,
                      traj=jst.traj.at[:, 0].set(jnp.nan))
    jst, tst = _both(jst)
    acc_shape = (cfg.t_theta, int(np.ceil(np.hypot(H, W))))
    frame = np.full((H, W, 3), 7, np.uint8)
    j = np.asarray(jp.draw_line_tracks(jnp.asarray(frame), jst, acc_shape))
    t = tp.draw_line_tracks(torch.from_numpy(frame), tst, acc_shape).numpy()
    np.testing.assert_array_equal(j, t)
    assert (t[0, :2] != 7).any() and (t[40:] == 7).all()
    paint = np.zeros((H, W, 4), np.float32)
    t = tp.paint_hough_video(torch.from_numpy(paint), tst, acc_shape)
    np.testing.assert_array_equal(
        np.asarray(jp.paint_hough_video(jnp.asarray(paint), jst,
                                        acc_shape)), t.numpy())
