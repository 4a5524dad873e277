"""Parity of vpp_tpu_torch's pyramidal Lucas-Kanade (kernel K10's plain
version) with vpp_tpu's on the CPU.

Tolerances:
* window samples bit-equal: the port's two-tap sampler rounds each product
  and sum on its own, as the JAX package's select-over-shifts sum does
  when it runs op by op (its CPU compile of the Newton loop contracts the
  same arithmetic into FMAs, so the search windows inside the loop are not
  compared bit for bit);
* the same keep/kill decision (err <= max_err) on every keypoint whose JAX
  err lies farther than 1e-3 relative from ``max_err``, and on those kept
  flow within 1e-3 px and err within 1e-3 relative or absolute (the
  121-term sums round in another order; 1e-3 px of flow moves the
  normalised SAD by up to ~1e-3). A killed keypoint's flow is where an
  iteration that did not converge stopped, and is not compared. Over a
  whole pyramid the flow is held where the JAX package's own flow moves
  by at most 1e-3 px when the keypoints move by 1e-4 px (``_conditioned``):
  at 128x160 the coarsest level is 33x41, which a winsize-11 window with a
  37x37 search patch nearly covers, and there the Newton iteration wanders
  for most keypoints (up to 2 px apart between the packages on the same
  inputs, while levels 1 and 0 agree within 3e-5 px);
* the gradient pyramid bit-equal (the same float32 taps in the same
  order).
Inputs: tests/test_lk.py (the blurred square, its flat patch, the
level-kill schedule) and a smooth seeded texture at 128x160. The bench
clip's box-smoothed noise is not used for the JAX comparison: on its
coarse levels the Newton iteration does not converge (it wanders for all
21 steps), so one float32 ulp of a pyramid level moves ~40% of its
keypoints by more than 1e-2 px, in either package. The port's K10 and
plain version sum in one order, so ``chip_smoke.py`` holds them bit for
bit on the bench clip.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpp_tpu.algorithms.pyramid import (antialiasing_lowpass_filter as
                                        j_lowpass, pyramid as j_pyramid)
from vpp_tpu.core.image import from_array as j_from_array
from vpp_tpu.core.keypoints import keypoints_from_positions as j_kps
from vpp_tpu_torch.algorithms.pyramid import (antialiasing_lowpass_filter as
                                              t_lowpass, pyramid as t_pyramid)
from vpp_tpu_torch.core.image import from_array as t_from_array
from vpp_tpu_torch.core.keypoints import keypoints_from_positions as t_kps

jlk = importlib.import_module("vpp_tpu.algorithms.lk")
tlk = importlib.import_module("vpp_tpu_torch.algorithms.lk")

torch.set_num_threads(1)

MAX_ERR = 2.0


def _square(shift_r, shift_c, size=100):
    """tests/test_lk.py's blurred square, in both packages."""
    a = np.zeros((size, size), np.float32)
    r0, c0 = 50 + shift_r, 50 + shift_c
    a[r0:r0 + 5, c0:c0 + 5] = 200.0
    j = j_lowpass(j_from_array(jnp.asarray(a), border=3,
                               border_mode="mirror"))
    t = t_lowpass(t_from_array(torch.from_numpy(a), border=3,
                               border_mode="mirror"))
    np.testing.assert_array_equal(np.asarray(j.data), t.data.numpy())
    return j, t


def _smooth(h, w, seed):
    """A smooth random texture: seeded noise through four 7x7 box passes
    (about a Gaussian of sigma 4 px), scaled to 0..255."""
    rng = np.random.RandomState(seed)
    a = rng.rand(h, w)
    for _ in range(4):
        p = np.pad(a, 3, mode="wrap")
        a = sum(p[r:r + h, c:c + w] for r in range(7) for c in range(7)) / 49
    a = (a - a.min()) / (a.max() - a.min()) * 255
    return a.astype(np.float32)


def _texture(shift, h=128, w=160, border=9):
    """Two frames of a smooth texture that moves by ``shift`` px along
    both axes (the scene content moves up and left)."""
    tex = _smooth(h + 16, w + 16, 3)
    out = []
    for a in (tex[:h, :w], tex[shift:shift + h, shift:shift + w]):
        out.append((j_from_array(jnp.asarray(a), border=border,
                                 border_mode="mirror"),
                    t_from_array(torch.from_numpy(a), border=border,
                                 border_mode="mirror")))
    return out


def _keypoints(n, h, w, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 2) * [h - 20, w - 20] + 10).astype(np.float32)


def _hold(jf, je, tf, te, max_err=MAX_ERR, held=None):
    """The flow/err rule of the module docstring, on the keypoints of
    ``held`` (all by default); returns the count held to the flow."""
    jf, je = np.asarray(jf), np.asarray(je)
    tf, te = tf.numpy(), te.numpy()
    far = np.abs(je - max_err) > 1e-3 * max_err
    assert far.mean() > 0.8
    np.testing.assert_array_equal(te[far] <= max_err, je[far] <= max_err)
    kept = far & (je <= max_err)
    if held is not None:
        kept &= held
    np.testing.assert_allclose(tf[kept], jf[kept], atol=1e-3, rtol=0)
    np.testing.assert_allclose(te[kept], je[kept], rtol=1e-3, atol=1e-3)
    return int(kept.sum())


def _conditioned(jax_flow, p, delta=1e-4):
    """Keypoints whose JAX flow moves by at most 1e-3 px when the keypoints
    move by ``delta`` px (``jax_flow(p) -> (N, 2)``): where the reference
    itself amplifies a change of its input by no more than 10."""
    f0 = np.asarray(jax_flow(p))
    f1 = np.asarray(jax_flow((p + delta).astype(np.float32)))
    return np.abs(f1 - f0).max(1) <= 1e-3


@pytest.mark.parametrize("pp,ws", [(37, 11), (13, 11), (9, 7), (11, 11)])
def test_sample_windows_bit_equal(pp, ws):
    """Offsets inside the patch, on its edge and beyond it (clipped)."""
    rng = np.random.RandomState(pp)
    n = 64
    patches = (rng.randn(n, pp, pp) * 50).astype(np.float32)
    k = pp - ws + 1
    s_r = (rng.rand(n) * (k + 4) - 2).astype(np.float32)
    s_c = (rng.rand(n) * (k + 4) - 2).astype(np.float32)
    s_r[:4] = [0.0, k - 2, k - 1, 0.5]
    j = np.asarray(jlk._sample_windows_local(
        jnp.asarray(patches), jnp.asarray(s_r), jnp.asarray(s_c), ws))
    t = tlk._sample_windows_local(torch.from_numpy(patches),
                                  torch.from_numpy(s_r),
                                  torch.from_numpy(s_c), ws)
    np.testing.assert_array_equal(j.view(np.int32), t.numpy().view(np.int32))


def test_level_windows_bit_equal():
    """The template and gradient windows the level samples (patches cut at
    ``jnp.round``'s top-lefts, offsets from them), bit for bit."""
    (j1, t1), _ = _texture(2)
    jg = jlk.gradient_pyramid(j_pyramid(j1, 1, border=5))[0]
    tg = tlk.gradient_pyramid(t_pyramid(t1, 1, border=5))[0]
    p = _keypoints(48, 128, 160, 1)
    p[:4] = [[10.5, 20.5], [11.5, 21.5], [0.0, 0.0], [127.0, 159.0]]
    ws, hws = 11, 5
    _, _, win, _ = tlk.lk_match_batch_plain(
        t1, t1, tg, torch.from_numpy(p), torch.zeros((48, 2)), winsize=ws,
        min_ev=1e-4, niterations=3, convergence_delta=0.1, windows=True)
    pj = jnp.asarray(p)
    for data, b, ch, i in ((j1.data, j1.border, None, 0),
                           (jg.data, jg.border, 0, 1),
                           (jg.data, jg.border, 1, 2)):
        d = data if ch is None else data[..., ch]
        patches, tl = jlk._extract_patches_tl(d, pj + b, ws + 2)
        s = (pj + b) - tl.astype(jnp.float32) - hws
        want = np.asarray(jlk._sample_windows_local(
            patches, s[:, 0], s[:, 1], ws)).reshape(48, -1)
        np.testing.assert_array_equal(want.view(np.int32),
                                      win[:, i].numpy().view(np.int32))


def test_gradient_pyramid_bit_equal():
    (j1, t1), _ = _texture(1)
    jp = jlk.gradient_pyramid(j_pyramid(j1, 3, border=5))
    tp = tlk.gradient_pyramid(t_pyramid(t1, 3, border=5))
    assert len(tp) == 3
    for a, b in zip(jp.levels, tp.levels):
        assert a.border == b.border
        np.testing.assert_array_equal(np.asarray(a.data), b.data.numpy())


@pytest.mark.parametrize("case", ["square", "texture", "texture_pred"])
def test_lk_match_batch(case):
    if case == "square":
        j1, t1 = _square(0, 0)
        j2, t2 = _square(2, 2)
        p = np.array([[52.0, 52.0], [10.0, 10.0], [51.0, 53.0],
                      [48.0, 49.5]], np.float32)
    else:
        (j1, t1), (j2, t2) = _texture(2)
        p = _keypoints(40, 128, 160, 4)
    pred = (np.zeros_like(p) if case != "texture_pred"
            else np.random.RandomState(5).randn(*p.shape).astype(np.float32))
    jg = jlk.gradient_pyramid(j_pyramid(j1, 1))[0]
    tg = tlk.gradient_pyramid(t_pyramid(t1, 1))[0]
    kw = dict(winsize=11, min_ev=1e-4, niterations=21,
              convergence_delta=0.1)
    jf, je = jlk.lk_match_batch(j1, j2, jg, jnp.asarray(p),
                                jnp.asarray(pred), **kw)
    tf, te = tlk.lk_match_batch(t1, t2, tg, torch.from_numpy(p),
                                torch.from_numpy(pred), **kw)
    _hold(jf, je, tf, te)
    if case == "square":
        assert float(te[1]) > 1e30          # the flat patch: min_ev gate


@pytest.mark.parametrize("nscales,pred", [(3, False), (2, True)])
def test_lucas_kanade(nscales, pred):
    (j1, t1), (j2, t2) = _texture(3)
    p = _keypoints(40, 128, 160, 6)
    pr = np.full_like(p, 3.0) if pred else None

    def jax_call(q):
        return jlk.lucas_kanade(j1, j2, jnp.asarray(q), nscales=nscales,
                                prediction=None if pr is None
                                else jnp.asarray(pr))

    jf, je = jax_call(p)
    tf, te = tlk.lucas_kanade(t1, t2, torch.from_numpy(p), nscales=nscales,
                              prediction=None if pr is None
                              else torch.from_numpy(pr))
    held = _conditioned(lambda q: jax_call(q)[0], p)
    assert _hold(jf, je, tf, te, held=held) >= 20
    good = te.numpy() < MAX_ERR
    assert good.mean() > 0.7
    np.testing.assert_allclose(np.median(tf.numpy()[good], 0), [-3, -3],
                               atol=0.1)


def test_lucas_kanade_square():
    """tests/test_lk.py:23."""
    j1, t1 = _square(0, 0)
    j2, t2 = _square(2, 2)
    jf, je = jlk.lucas_kanade(j1, j2, jnp.array([[52.0, 52.0]]))
    tf, te = tlk.lucas_kanade(t1, t2, torch.tensor([[52.0, 52.0]]))
    _hold(jf, je, tf, te)
    assert abs(float(tf[0, 0]) - 2) < 0.35 and float(te[0]) < 2.0


@pytest.mark.parametrize("case", ["square", "texture"])
def test_pyrlk_match(case):
    if case == "square":                   # tests/test_lk.py:45
        j1, t1 = _square(0, 0)
        j2, t2 = _square(2, 2)
        p = np.array([[52.0, 52.0], [10.0, 10.0]], np.float32)
        alive = np.array([True, True])
    else:
        (j1, t1), (j2, t2) = _texture(2)
        p = _keypoints(48, 128, 160, 7)
        alive = np.random.RandomState(8).rand(48) > 0.2
    jpp, jpn = j_pyramid(j1, 3), j_pyramid(j2, 3)
    tpp, tpn = t_pyramid(t1, 3), t_pyramid(t2, 3)
    jo = jlk.pyrlk_match(jpp, jlk.gradient_pyramid(jpp), jpn,
                         j_kps(jnp.asarray(p), jnp.asarray(alive)))
    to = tlk.pyrlk_match(tpp, tlk.gradient_pyramid(tpp), tpn,
                         t_kps(torch.from_numpy(p), torch.from_numpy(alive)))
    np.testing.assert_array_equal(np.asarray(jo.age), to.age.numpy())
    np.testing.assert_allclose(to.position.numpy(), np.asarray(jo.position),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(to.velocity.numpy(), np.asarray(jo.velocity),
                               atol=1e-3, rtol=0)
    if case == "square":
        assert bool(to.alive[0]) and not bool(to.alive[1])


def test_pyrlk_level_kill_semantics(monkeypatch):
    """tests/test_lk.py:62's schedule on the port: a coarse-level failure
    alone does not kill (its flow is not adopted), a finest-level failure
    does."""
    errs = {2: [9.0, 0.1], 1: [0.1, 0.1], 0: [0.1, 9.0]}
    flows = {2: [[8.0, 8.0], [1.0, 1.0]], 1: [[1.0, 1.0], [1.0, 1.0]],
             0: [[2.0, 2.0], [1.0, 1.0]]}
    shapes = {100: 0, 51: 1, 26: 2}

    def stub(A, B, Ag, p, tr, **kw):
        s = shapes[A.shape[0]]
        return torch.tensor(flows[s]), torch.tensor(errs[s])

    monkeypatch.setattr(tlk, "lk_match_batch", stub)
    _, t1 = _square(0, 0)
    pyr = t_pyramid(t1, 3, border=5)
    out = tlk.pyrlk_match(pyr, tlk.gradient_pyramid(pyr), pyr,
                          t_kps(torch.tensor([[50.0, 50.0], [50.0, 50.0]]),
                                torch.tensor([True, True])))
    assert bool(out.alive[0]) and not bool(out.alive[1])
    np.testing.assert_array_equal(out.position[0].numpy(), [52.0, 52.0])


@pytest.mark.parametrize("dirs", ["axis", "rotated"])
def test_oriented_lk(dirs):
    """Against the JAX package (bilinear sums in another order: 1e-4), and
    with axis-aligned directions and no step clamp against the port's
    square-window LK (tests/test_lk.py:98, same tolerance)."""
    j1, t1 = _square(0, 0)
    j2, t2 = _square(2, 1)
    jg = jlk.scharr(j1)
    tg = tlk.scharr(t1)
    p = np.array([[52.0, 52.0], [51.0, 53.0], [49.0, 50.0]], np.float32)
    if dirs == "axis":
        d1 = d2 = np.tile(np.array([[0.0, 1.0]], np.float32), (3, 1))
    else:
        a = np.array([0.3, -0.5, 1.1], np.float32)
        d1 = np.stack([np.sin(a), np.cos(a)], -1).astype(np.float32)
        d2 = np.stack([np.sin(a + 0.1), np.cos(a + 0.1)], -1).astype(
            np.float32)
    kw = dict(winsize=11, min_ev=1e-4, niterations=15,
              convergence_delta=0.01,
              max_step_norm=100.0 if dirs == "axis" else 1.5)
    jf, je = jlk.oriented_lk_match_batch(
        j1, j2, jg, jnp.asarray(p), jnp.zeros((3, 2)),
        match_direction1=jnp.asarray(d1), match_direction2=jnp.asarray(d2),
        **kw)
    tf, te = tlk.oriented_lk_match_batch(
        t1, t2, tg, torch.from_numpy(p), torch.zeros((3, 2)),
        match_direction1=torch.from_numpy(d1),
        match_direction2=torch.from_numpy(d2), **kw)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-4)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-4,
                               atol=1e-4)
    if dirs == "axis":
        kw.pop("max_step_norm")
        f0, e0 = tlk.lk_match_batch(t1, t2, tg, torch.from_numpy(p),
                                    torch.zeros((3, 2)), **kw)
        np.testing.assert_allclose(tf.numpy(), f0.numpy(), atol=1e-4)
        np.testing.assert_allclose(te.numpy(), e0.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_lk_level_refuses_cpu_tensors():
    """K10's wrapper takes CUDA tensors only; ``lk_match_batch`` routes a
    CPU image to the plain version."""
    _, t1 = _square(0, 0)
    tg = tlk.gradient_pyramid(t_pyramid(t1, 1))[0]
    with pytest.raises(ValueError, match="lk_level"):
        tlk.lk_level(t1, t1, tg, torch.zeros((2, 2)), torch.zeros((2, 2)),
                     winsize=11, min_ev=1e-4, niterations=3,
                     convergence_delta=0.1)
    with pytest.raises(ValueError, match="winsize"):
        tlk.lk_level(t1, t1, tg, torch.zeros((2, 2)), torch.zeros((2, 2)),
                     winsize=17, min_ev=1e-4, niterations=3,
                     convergence_delta=0.1)


# -- K10's plain pieces: the lane order and the level glue ----------------------

@pytest.mark.parametrize("m", [1, 31, 32, 33, 121, 225, 256])
def test_lane_sum_order(m):
    """``_lane_sum`` is K10's order: lane l (of 32) adds terms l, l + 32,
    ... to 0 in turn, then an xor butterfly over the lanes at strides 16,
    8, 4, 2, 1; held bit for bit to that order written out in float32."""
    rng = np.random.RandomState(m)
    t = (rng.randn(5, m) * 10 ** rng.uniform(-3, 3, (5, m))).astype(
        np.float32)
    t[0, :3] = [-0.0, 0.0, -0.0][:min(3, m)]
    got = tlk._lane_sum(torch.from_numpy(t)).numpy()
    for row, want_row in zip(t, got):
        lanes = [np.float32(0.0)] * 32
        for e in range(m):
            lanes[e % 32] = np.float32(lanes[e % 32] + row[e])
        for o in (16, 8, 4, 2, 1):
            lanes = [np.float32(lanes[i] + lanes[i ^ o]) for i in range(32)]
        assert np.float32(lanes[0]).view(np.int32) == np.float32(
            want_row).view(np.int32)


def _lucas_kanade_loop(i1, i2, keypoints, nscales, prediction, kw):
    """``lucas_kanade``'s level loop as it was written level by level."""
    border = max(3, kw["winsize"] // 2)
    p_prev = t_pyramid(i1, nscales, border=border)
    p_next = t_pyramid(i2, nscales, border=border)
    p_grad = tlk.gradient_pyramid(p_prev)
    n = keypoints.shape[0]
    tr = (torch.zeros((n, 2)) if prediction is None
          else prediction.to(torch.float32) / float(2 ** nscales))
    dist = torch.zeros((n,))
    for s in range(nscales - 1, -1, -1):
        tr = tr * 2.0
        flow, err = tlk.lk_match_batch(p_prev[s], p_next[s], p_grad[s],
                                       keypoints / float(2 ** s), tr, **kw)
        tr = flow
        dist = err
    return tr, dist


def _pyrlk_loop(pyr_prev, pyr_grad, pyr_next, position, max_err, kw):
    """``pyrlk_match``'s level loop as it was written level by level."""
    tr = torch.zeros((position.shape[0], 2))
    dist = torch.zeros((position.shape[0],))
    for s in range(len(pyr_prev) - 1, -1, -1):
        tr = tr * pyr_prev.factor
        flow, err = tlk.lk_match_batch(pyr_prev[s], pyr_next[s],
                                       pyr_grad[s], position / float(2 ** s),
                                       tr, **kw)
        tr = torch.where((err < max_err)[:, None], flow, tr)
        dist = err
    return tr, dist


def _bits(a, b):
    return np.array_equal(a.numpy().view(np.int32), b.numpy().view(np.int32))


@pytest.mark.parametrize("nscales", [1, 3, 4])
@pytest.mark.parametrize("pred", [False, True])
def test_level_glue_matches_level_loop(nscales, pred):
    """The level glue with its adopt flag (``_coarse_to_fine``, which the
    CPU routes take and ``lk_levels_plain`` runs over K10's plain level)
    against the level-by-level loops it replaced, bit for bit: adopt
    always (``lucas_kanade``, with and without a prediction) and adopt
    below ``max_err`` (``pyrlk_match``, ``max_err`` set to a keypoint's
    own residual at the coarsest level, so that ``err == max_err`` occurs
    and is not adopted)."""
    (_, t1), (_, t2) = _texture(3)
    p = torch.from_numpy(_keypoints(24, 128, 160, 11))
    prediction = (torch.from_numpy(np.random.RandomState(3).randn(24, 2)
                                   .astype(np.float32)) if pred else None)
    kw = dict(winsize=11, min_ev=1e-4, niterations=21,
              convergence_delta=0.1)
    want = _lucas_kanade_loop(t1, t2, p, nscales, prediction, kw)
    got = tlk.lucas_kanade(t1, t2, p, nscales=nscales, prediction=prediction)
    assert _bits(got[0], want[0]) and _bits(got[1], want[1])
    pp, pn = t_pyramid(t1, nscales, border=9), t_pyramid(t2, nscales,
                                                         border=9)
    pg = tlk.gradient_pyramid(pp)
    scales = list(range(nscales - 1, -1, -1))
    levels = [(pp[s], pn[s], pg[s]) for s in scales]
    tr0 = torch.zeros((24, 2)) if prediction is None else prediction
    coarse = tlk.lk_match_batch(*levels[0], p / float(2 ** scales[0]),
                                tr0 * pp.factor, **kw)[1]
    max_err = float(coarse[coarse < 1e30][5])
    want = _pyrlk_loop(pp, pg, pn, p, max_err, kw)
    plain = tlk.lk_levels_plain(levels, scales, p, torch.zeros((24, 2)),
                                adopt="below", factor=pp.factor,
                                max_err=max_err, **kw)
    assert _bits(plain[0], want[0]) and _bits(plain[1], want[1])
    moved = tlk.pyrlk_match(pp, pg, pn, t_kps(p, torch.ones(24, dtype=bool)),
                            max_err=max_err)
    final = p + want[0]
    ok = ((want[1] <= max_err) & (final[:, 0] >= 0) & (final[:, 0] <= 127)
          & (final[:, 1] >= 0) & (final[:, 1] <= 159))
    assert torch.equal(moved.alive, ok) and bool(ok.any())
    assert _bits(moved.position[ok], final[ok])
    # adopt always is not adopt below an infinite max_err: a NaN residual
    nan_err = {0: torch.tensor([float("nan"), 0.5])}

    def stub(A, B, Ag, q, tr, **_):
        return tr + 1.0, nan_err.get(0)

    one = [(pp[0], pn[0], pg[0])]
    always = tlk._coarse_to_fine(one, [0], p[:2], torch.zeros((2, 2)), stub,
                                 adopt="always", factor=2.0)
    below = tlk._coarse_to_fine(one, [0], p[:2], torch.zeros((2, 2)), stub,
                                adopt="below", factor=2.0,
                                max_err=float("inf"))
    assert float(always[0][0, 0]) == 1.0 and float(below[0][0, 0]) == 0.0


def test_level_glue_err_at_max_err():
    """``err == max_err`` at a level is not adopted (``<``), and the final
    kill tests ``<=``: the stubbed residuals of tests/test_lk.py:62's
    schedule moved onto ``max_err`` itself."""
    errs = {2: [2.0, 0.1], 1: [0.1, 2.0], 0: [2.0, 0.1]}
    flows = {2: [[8.0, 8.0], [1.0, 1.0]], 1: [[1.0, 1.0], [4.0, 4.0]],
             0: [[2.0, 2.0], [1.0, 1.0]]}
    shapes = {100: 0, 51: 1, 26: 2}

    def stub(A, B, Ag, p, tr, **kw):
        s = shapes[A.shape[0]]
        return torch.tensor(flows[s]), torch.tensor(errs[s])

    _, t1 = _square(0, 0)
    pyr = t_pyramid(t1, 3, border=5)
    levels = [(pyr[s], pyr[s], pyr[s]) for s in (2, 1, 0)]
    p = torch.tensor([[50.0, 50.0], [50.0, 50.0]])
    tr, dist = tlk._coarse_to_fine(levels, [2, 1, 0], p, torch.zeros((2, 2)),
                                   stub, adopt="below", factor=2.0,
                                   max_err=2.0)
    # keypoint 0: level 2 not adopted, level 1 adopted, level 0 not
    # adopted; keypoint 1: levels 2 and 0 adopted, level 1 not
    np.testing.assert_array_equal(tr.numpy(), [[2.0, 2.0], [1.0, 1.0]])
    np.testing.assert_array_equal(dist.numpy(),
                                  np.array([2.0, 0.1], np.float32))
