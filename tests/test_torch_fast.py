"""Parity of vpp_tpu_torch's FAST9 (kernel K2's plain version and the
selection passes, kernel K3's plain version among them) with vpp_tpu's on
the CPU. Everything here is integer and must be bit-equal. The blockwise
top-K (K3) gives every candidate a distinct key, so it is compared on every
slot; the full-image ``select_keypoints`` is compared on valid slots only
(its invalid slots share key -1, and torch.topk orders such ties
differently)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpp_tpu.core.image import from_array as j_from_array
from vpp_tpu_torch.core.image import from_array as t_from_array
from vpp_tpu_torch.utils.clips import make_clip

jf = importlib.import_module("vpp_tpu.algorithms.fast")
tf = importlib.import_module("vpp_tpu_torch.algorithms.fast")

torch.set_num_threads(1)


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def _pair(seed=0, shape=(96, 128), border=9):
    frame = make_clip(shape[1], shape[0], 1, seed=seed)[0]
    return (j_from_array(jnp.asarray(frame), border=border,
                         border_mode="mirror"),
            t_from_array(frame, border=border, border_mode="mirror"))


def test_has_9_contiguous_all_codes():
    """Every 16-bit ring code through both bit tricks."""
    codes = np.arange(1 << 16, dtype=np.int64).reshape(256, 256)
    flags = np.stack([(codes >> k) & 1 for k in range(16)]).astype(bool)
    j = jf._has_9_contiguous(jnp.asarray(flags))
    t = tf._has_9_contiguous(torch.from_numpy(flags))
    _eq(j, t)
    assert 0 < int(t.sum()) < (1 << 16)


@pytest.mark.parametrize("th", [5, 10, 20])
@pytest.mark.parametrize("seed", [0, 1])
def test_fast9_score_and_detect_bit_equal(th, seed):
    ji, ti = _pair(seed)
    score, flag = tf.fast9_plain(ti, th)
    _eq(jf.fast9_score(ji, th), score)
    _eq(jf.fast9_detect(ji, th), flag != 0)
    _eq(jf.fast9_score(ji, th), tf.fast9_score(ti, th))
    _eq(jf.fast9_detect(ji, th), tf.fast9_detect(ti, th))
    assert score.dtype == torch.int32 and flag.dtype == torch.uint8


def test_fast9_truncates_fractional_pixels():
    """Pixels are truncated to int32 before differencing."""
    a = np.full((12, 12), 100.9, np.float32)
    a[3:9, 3:9] = 130.2
    ji = j_from_array(jnp.asarray(a), border=3, border_mode="mirror")
    ti = t_from_array(a, border=3, border_mode="mirror")
    _eq(jf.fast9_score(ji, 10), tf.fast9_score(ti, 10))
    _eq(jf.fast9_detect(ji, 10), tf.fast9_detect(ti, 10))


def test_fast9_score_image_with_mask():
    ji, ti = _pair(2)
    mask = (np.random.RandomState(2).rand(96, 128) > 0.3).astype(np.uint8)
    jo = jf.fast9_score_image(ji, 10, mask=jnp.asarray(mask))
    to = tf.fast9_score_image(ti, 10, mask=torch.from_numpy(mask))
    _eq(jo.data, to.data)
    assert to.border == 1 and to.dtype == torch.uint8


@pytest.mark.parametrize("th", [8, 20])
@pytest.mark.parametrize("mask_kind", ["none", "uint8", "bool"])
def test_fast9_score_image_masks(th, mask_kind):
    """K2's score image (plain version) against JAX ``fast9_score_image``:
    no mask, a uint8 mask with values other than 0/1, a bool mask."""
    ji, ti = _pair(7)
    rng = np.random.RandomState(th)
    mask = None
    if mask_kind == "uint8":
        mask = (rng.randint(0, 4, (96, 128)) * 60).astype(np.uint8)
    elif mask_kind == "bool":
        mask = rng.rand(96, 128) > 0.4
    jo = jf.fast9_score_image(
        ji, th, mask=None if mask is None else jnp.asarray(mask))
    to = tf.fast9_score_image(
        ti, th, mask=None if mask is None else torch.from_numpy(mask))
    _eq(jo.data, to.data)
    assert to.border == 1 and to.dtype == torch.uint8
    assert int(to.data.count_nonzero()) > 0


def _cull_positions(h, w, seed):
    """Float positions: random ones inside and around the domain, exact .5
    fractions (rounded half to even), the edge rows and columns, and
    points well outside the domain."""
    rng = np.random.RandomState(seed)
    rand = rng.rand(64, 2) * [h + 8, w + 8] - 4
    halves = rng.randint(-2, max(h, w) + 2, (32, 2)) + 0.5
    edges = np.array([[0, 0], [h - 1, w - 1], [0, w - 1], [h - 1, 0],
                      [-0.5, -0.5], [h - 0.5, w - 0.5], [h - 1.5, 0.5],
                      [0.49, w - 1.51], [-40.0, 17.0], [h + 300.0, -9.0]])
    return np.concatenate([rand, halves, edges]).astype(np.float32)


@pytest.mark.parametrize("th", [5, 10])
@pytest.mark.parametrize("shape,border", [((96, 128), 9), ((37, 53), 3)])
def test_fast9_cull_scores_match_jax_cull(th, shape, border):
    """K2's cull (plain version) against the JAX tracker's cull expression
    (vpp_tpu/algorithms/video_extruder.py:140-143)."""
    ji, ti = _pair(8, shape=shape, border=border)
    h, w = shape
    pos = _cull_positions(h, w, th + h)
    score_img = jf.fast9_score(ji, th)
    pos_i = jnp.clip(jnp.round(jnp.asarray(pos)).astype(jnp.int32), 0,
                     jnp.array([h - 1, w - 1]))
    want = score_img[pos_i[:, 0], pos_i[:, 1]]
    got = tf.fast9_cull_scores(ti, torch.from_numpy(pos), th)
    assert got.dtype == torch.int32 and got.shape == (pos.shape[0],)
    _eq(want, got)
    assert int((got >= 3).sum()) > 0


def test_fast9_score_at_matches():
    ji, ti = _pair(3)
    rng = np.random.RandomState(3)
    pos = np.stack([rng.randint(-2, 98, 50), rng.randint(-2, 130, 50)],
                   -1).astype(np.int32)
    _eq(jf.fast9_score_at(ji, jnp.asarray(pos), 10),
        tf.fast9_score_at(ti, torch.from_numpy(pos), 10))


@pytest.mark.parametrize("k", [16, 300])
@pytest.mark.parametrize("local_maxima", [False, True])
def test_select_keypoints_valid_picks(k, local_maxima):
    ji, ti = _pair(4)
    jp, js, jv = jf.fast9(ji, 10, k=k, local_maxima=local_maxima)
    tp, ts, tv = tf.fast9(ti, 10, k=k, local_maxima=local_maxima)
    jv = np.array(jv)
    _eq(jv, tv)
    _eq(np.asarray(jp)[jv], tp[torch.from_numpy(jv)])
    _eq(np.asarray(js)[jv], ts[torch.from_numpy(jv)])
    assert jv.any()


@pytest.mark.parametrize("k", [8, 64, 1024])
@pytest.mark.parametrize("block", [7, 10])
def test_blockwise_keypoints_valid_picks(k, block):
    ji, ti = _pair(5)
    mask = np.ones((96, 128), np.uint8)
    mask[20:50, 30:90] = 0
    jp, js, jv = jf.fast9(ji, 10, k=k, blockwise=True, block_size=block,
                          mask=jnp.asarray(mask))
    tp, ts, tv = tf.fast9(ti, 10, k=k, blockwise=True, block_size=block,
                          mask=torch.from_numpy(mask))
    assert tp.shape == (k, 2) and tv.shape == (k,)
    _eq(jv, tv)
    _eq(jp, tp)
    _eq(js, ts)


@pytest.mark.parametrize("k", [512, 4096])
def test_blockwise_keypoints_bench_shape(k):
    """K3's plain version at the SLAM bench shape: a 640x480 rendered frame,
    10 px blocks (3072 candidates), detect_k 512; and k above the block
    count (padded)."""
    from vpp_tpu_torch.utils.synth import (camera_path, make_cloud,
                                           render_frames)
    pts = make_cloud(2000, seed=1, extent=(16.0, 5.0, 3.5),
                     center=(3.2, 0.0, 5.0))
    frame = render_frames(pts, camera_path(1), (640.0, 640.0, 320.0, 240.0),
                          (480, 640), seed=1, sigma=(1.2, 2.2))[0]
    ji = j_from_array(jnp.asarray(frame), border=9, border_mode="mirror")
    ti = t_from_array(frame, border=9, border_mode="mirror")
    jp, js, jv = jf.fast9(ji, 10, k=k, blockwise=True, block_size=10)
    tp, ts, tv = tf.fast9(ti, 10, k=k, blockwise=True, block_size=10)
    _eq(jv, tv)
    _eq(jp, tp)
    _eq(js, ts)
    assert 0 < int(tv.sum()) <= min(k, 3072)


def test_blockwise_keypoints_all_invalid_order():
    """No positive score: every slot invalid, in ascending block order."""
    s = t_from_array(np.zeros((30, 40), np.uint8), border=1)
    js = j_from_array(jnp.zeros((30, 40), jnp.uint8), border=1)
    for a, b in zip(jf._blockwise_keypoints(js, 10, 8),
                    tf._blockwise_keypoints(s, 10, 8)):
        _eq(a, b)


def _score_image(shape, kind, seed):
    """uint8 score images: random scores on 40% of the pixels; three
    distinct scores (long runs of ties); one score everywhere."""
    rng = np.random.RandomState(seed)
    if kind == "random":
        s = rng.randint(1, 256, shape) * (rng.rand(*shape) > 0.6)
    elif kind == "ties":
        s = rng.choice([0, 0, 7, 200], shape)
    else:
        s = np.full(shape, 9)
    return s.astype(np.uint8)


@pytest.mark.parametrize("shape,block,k,kind", [
    ((400, 400), 2, 4096, "random"),     # 40000 blocks
    ((400, 400), 2, 4096, "ties"),
    ((300, 200), 1, 2048, "constant"),   # 60000 tied blocks
    ((96, 128), 1, 20000, "ties"),       # k > nb: padded
])
def test_blockwise_keypoints_many_blocks(shape, block, k, kind):
    """K3's plain version beyond the 32768 blocks that K3 once took, and on
    score images whose equal scores run across long block ranges: every
    slot equals JAX's."""
    s = _score_image(shape, kind, shape[0] + k)
    js = j_from_array(jnp.asarray(s), border=1)
    ts = t_from_array(s, border=1)
    got = tf._blockwise_keypoints(ts, block, k)
    for a, b in zip(jf._blockwise_keypoints(js, block, k), got):
        _eq(a, b)
    nb = -(-shape[0] // block) * -(-shape[1] // block)
    assert got[2].shape == (k,) and int(got[2].sum()) <= min(k, nb)


def test_maxima_filters_bit_equal():
    ji, ti = _pair(6)
    js = jf.fast9_score_image(ji, 8)
    ts = tf.fast9_score_image(ti, 8)
    _eq(jf.local_maxima_filter(js).data, tf.local_maxima_filter(ts).data)
    _eq(jf.blockwise_maxima_filter(js, 10).data,
        tf.blockwise_maxima_filter(ts, 10).data)


def test_fast9_needs_border_3():
    _, ti = _pair(0, border=2)
    with pytest.raises(ValueError):
        tf.fast9_score(ti, 10)
