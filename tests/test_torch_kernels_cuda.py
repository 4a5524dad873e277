"""The CUDA kernels against their plain versions, on a card.

These tests need a CUDA card and skip without one. They import neither JAX
nor vpp_tpu, so they also run on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

Tolerances are chip_smoke.py's: K2 bit-equal in its three modes (full
map, score image, cull); K1 flow equal wherever the
best and second-best SAD differ by more than 1e-5 relative, dist and
volume within rtol 1e-5, the whole level bit-equal on integer-valued
buffers, propagation exactly equal on equal inputs; K7 bit-reproducible
and within 1e-4 * max of the float32 scatter, one device kernel a call;
K4's whole pyramid one launch, bit-equal to the plain chain on
integer-valued frames up to level 2 and within 1e-6 relative elsewhere.
"""

import numpy as np
import pytest
import torch

from vpp_tpu_torch.algorithms import fast, flow, hough, hough_cuda
from vpp_tpu_torch.algorithms.hough_tracker import (HoughTrackerConfig,
                                                    hough_tracker_init,
                                                    hough_tracker_update)
from vpp_tpu_torch.algorithms.video_extruder import (VideoExtruderConfig,
                                                     video_extruder_run)
from vpp_tpu_torch.core.image import from_array
from vpp_tpu_torch.kernels import launch_counts, reset_launch_counts
from vpp_tpu_torch.utils.clips import make_clip, synthetic_line_clip


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


K2_CASES = [((96, 128), 9), ((37, 53), 3)]


def _k2_frame(device, shape, border):
    frame = make_clip(shape[1], shape[0], 1, seed=shape[0])[0]
    return from_array(torch.from_numpy(frame).to(device), border=border,
                      border_mode="mirror")


@pytest.mark.parametrize("shape,border", K2_CASES)
def test_fast9_kernel_bit_equal(cuda, shape, border):
    """K2's full map, score and flag, and the score alone: one launch a
    call, bit-equal to the plain version."""
    img = _k2_frame(cuda, shape, border)
    for th in (5, 10, 20):
        reset_launch_counts()
        sk, dk = fast.fast9_cuda(img, th)
        assert launch_counts()["fast9"] == 1
        sp, dp = fast.fast9_plain(img, th)
        assert torch.equal(sk, sp) and torch.equal(dk, dp)
        assert torch.equal(fast.fast9_cuda(img, th, detect=False)[0], sp)


@pytest.mark.parametrize("shape,border", K2_CASES)
def test_fast9_score_image_kernel_bit_equal(cuda, shape, border):
    """K2's score image, with no mask, a uint8 mask (values other than 0/1)
    and a bool mask: one launch a call writing the whole bordered image,
    bit-equal to the plain composition."""
    img = _k2_frame(cuda, shape, border)
    rng = np.random.RandomState(border)
    masks = [None,
             torch.from_numpy((rng.randint(0, 4, shape) * 60).astype(
                 np.uint8)).to(cuda),
             torch.from_numpy(rng.rand(*shape) > 0.4).to(cuda)]
    for th in (5, 10, 20):
        for mask in masks:
            reset_launch_counts()
            got = fast.fast9_score_image(img, th, mask=mask)
            assert launch_counts()["fast9"] == 1
            want = fast.fast9_score_image_plain(img, th, mask=mask)
            assert got.border == 1 and torch.equal(got.data, want.data)
            assert int(got.data.count_nonzero()) > 0


@pytest.mark.parametrize("shape,border", K2_CASES)
def test_fast9_cull_kernel_bit_equal(cuda, shape, border):
    """K2's cull at random positions in and around the domain, exact .5
    fractions, the edge rows and columns and points far outside: one launch
    a call, bit-equal to the full map read at the rounded, clamped
    positions."""
    img = _k2_frame(cuda, shape, border)
    h, w = shape
    rng = np.random.RandomState(h)
    pos = np.concatenate([
        rng.rand(4000, 2) * [h + 8, w + 8] - 4,
        rng.randint(-2, max(h, w) + 2, (300, 2)) + 0.5,
        [[0, 0], [h - 1, w - 1], [0, w - 1], [h - 1, 0], [-0.5, -0.5],
         [h - 0.5, w - 0.5], [h - 1.5, 0.5], [0.49, w - 1.51],
         [-40.0, 17.0], [h + 300.0, -9.0]]]).astype(np.float32)
    pos = torch.from_numpy(pos).to(cuda)
    for th in (5, 10, 20):
        reset_launch_counts()
        got = fast.fast9_cull_scores(img, pos, th)
        assert launch_counts()["fast9"] == 1
        want = fast.fast9_cull_scores_plain(img, pos, th)
        assert got.dtype == torch.int32 and torch.equal(got, want)


def _device_kernels(fn):
    """The device kernels one call of ``fn`` runs, by name and count, from
    ``torch.profiler``, after a warm-up call under a profiler session of
    its own (a process's first session can miss device events)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        fn()
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU}


def test_k2_and_k5_calls_run_one_kernel(cuda):
    """On the card, K2's score image and cull and K5 from centres of either
    index type run their kernel and nothing else (no conversion, clamp,
    pad or mask kernel around it); the tracker's cull and its compare and
    mask are three kernels."""
    from vpp_tpu_torch.core import interp
    img = _k2_frame(cuda, (96, 128), 9)
    mask = torch.ones((96, 128), dtype=torch.uint8, device=cuda)
    pos = torch.rand((256, 2), device=cuda) * 90
    alive = torch.rand((256,), device=cuda) > 0.5
    data = torch.rand((114, 146), device=cuda)
    calls = {"fast9_tile": lambda: fast.fast9_score_image(img, 10, mask),
             "fast9_cull": lambda: fast.fast9_cull_scores(img, pos, 10)}
    for index in (torch.int32, torch.int64):
        ctr = (pos * 1.2).to(index)
        calls[f"patches_{index}"] = (
            lambda ctr=ctr: interp.extract_patches(data, ctr, 7))
    for name, fn in calls.items():
        kernels = _device_kernels(fn)
        assert sum(kernels.values()) == 1, (name, kernels)
        assert name.split("_")[0] in next(iter(kernels)), (name, kernels)
    cull = _device_kernels(
        lambda: alive & (fast.fast9_cull_scores(img, pos, 10) < 3))
    assert sum(cull.values()) == 3, cull


# (hb, wb, border, R, pred_bound, extra cells): the tracker's three levels
# of a 640x480 frame (grids (25, 33), (49, 65), (96, 128)), then a grid that
# is not a multiple of K1's tiles and a grid that outgrows the image
K1_CASES = [
    (138, 178, 9, 5, 0, 1),
    (258, 338, 9, 1, 10, 1),
    (498, 658, 9, 1, 22, 0),
    (71, 93, 9, 1, 10, 0),
    (71, 93, 9, 3, 6, 1),
]


def _k1_inputs(case, kind, device):
    hb, wb, b, R, pred_bound, extra = case
    rng = np.random.RandomState(hb + R + pred_bound)
    h, w = hb - 2 * b, wb - 2 * b
    gh, gw = h // 5 + extra, w // 5 + extra
    if kind == "float":
        a1 = (rng.rand(hb, wb) * 255).astype(np.float32)
        a2 = (np.roll(a1, (1, 2), (0, 1)) + rng.rand(hb, wb) * 3).astype(
            np.float32)
    elif kind == "integer":
        a1 = rng.randint(0, 256, (hb, wb)).astype(np.float32)
        a2 = (np.roll(a1, (2, -1), (0, 1))
              + rng.randint(0, 3, (hb, wb))).astype(np.float32)
    else:
        a1 = np.full((hb, wb), 77.3, np.float32)
        a2 = a1.copy()
    pred = np.zeros((gh, gw, 2), np.int32)
    if pred_bound:
        pred = (rng.randint(-pred_bound // 2 - 1, pred_bound // 2 + 2,
                            (gh, gw, 2)) * 2).astype(np.int32)
    g = flow.LevelGeometry(b=b, h=h, w=w, ws=9, patch=5, gh=gh, gw=gw, R=R,
                           pred_bound=pred_bound)
    return [torch.from_numpy(x).to(device) for x in (a1, a2, pred)] + [g]


@pytest.mark.parametrize("kind", ["float", "integer", "constant"])
@pytest.mark.parametrize("case", K1_CASES)
def test_flow_level_kernel_matches_plain(cuda, case, kind):
    """K1's two launches against the plain level. Float buffers: flow equal
    wherever best and second-best differ by more than 1e-5 relative, dist
    and volume within rtol 1e-5. Integer-valued and constant buffers make
    every sum exact: volume, flow and dist bit-equal, ties included, and
    a constant image takes k = 0 (flow = pred) in every cell. Propagation,
    1 to 3 passes in one launch, is bit-equal to the plain passes on equal
    inputs; ``flow_level`` equals the match followed by those passes."""
    t1, t2, tp, g = _k1_inputs(case, kind, cuda)
    fk, dk, vk = flow.flow_match(t1, t2, tp, g)
    fp, dp, vp = flow.flow_match_plain(t1, t2, tp, g)
    if kind == "float":
        two = torch.topk(vp, 2, dim=0, largest=False).values
        clear = (two[1] - two[0]) > 1e-5 * two[0].abs().clamp(min=1e-30)
        assert bool(((fk == fp).all(-1) | ~clear).all())
        assert torch.allclose(dk[clear], dp[clear], rtol=1e-5, atol=0)
        assert torch.allclose(vk, vp, rtol=1e-5, atol=0)
    else:
        assert torch.equal(vk, vp) and torch.equal(fk, fp)
        assert torch.equal(dk, dp)
    if kind == "constant":
        assert torch.equal(fk, tp) and bool((vk == 0).all())
    for iters in (0, 1, 2, 3):
        f_in, d_in = fp, dp
        for _ in range(iters):
            f_in, d_in = flow.flow_propagate_plain(f_in, d_in, tp, vp, g.R)
        pk, pdk = flow.flow_propagate(fp, dp, tp, vp, g.R, iters=iters)
        assert torch.equal(pk, f_in) and torch.equal(pdk, d_in)
        lf, ld = flow.flow_level(t1, t2, tp, g, iters)
        if kind == "float":
            sf, sd = flow.flow_propagate(fk, dk, tp, vk, g.R, iters=iters)
            assert torch.equal(lf, sf) and torch.equal(ld, sd)
        else:
            assert torch.equal(lf, f_in) and torch.equal(ld, d_in)


def _level_by_plain(t1, t2, tp, g, iters):
    f, d, v = flow.flow_match_plain(t1, t2, tp, g)
    for _ in range(iters):
        f, d = flow.flow_propagate_plain(f, d, tp, v, g.R)
    return f, d, v


@pytest.mark.parametrize("case", K1_CASES)
def test_flow_volume_tile_shapes_agree(cuda, case):
    """Launch A at each of its tile shapes, then launch B, on integer-valued
    buffers: volume, flow and dist bit-equal to the plain level."""
    t1, t2, tp, g = _k1_inputs(case, "integer", cuda)
    fp, dp, vp = _level_by_plain(t1, t2, tp, g, 2)
    a1, a2, pred, _ = flow._level_operands(t1, t2, tp, g, 2)
    for shape in flow._VOLUME_SHAPES:
        plan = flow._k1_plan(g, 2, flow._sm_count(a1.device), (shape,))
        vol, part = flow._launch_volume(a1, a2, pred, g, plan)
        f, d = flow._launch_select(vol, pred, g.R, 2, plan.b_tile, part,
                                   domain=(g.h, g.w, g.patch))
        assert torch.equal(vol, vp), shape
        assert torch.equal(f, fp) and torch.equal(d, dp), shape


# (hb, wb, border = winsize, patch, R): windows that fit launch A's 8-cell
# tile one displacement at a time, and windows that need its 4-cell tile
K1_LARGE_WINDOWS = [(150, 170, 31, 16, 5), (150, 170, 31, 16, 10)]


@pytest.mark.parametrize("case", K1_LARGE_WINDOWS)
def test_flow_level_kernel_large_windows(cuda, case):
    hb, wb, ws, patch, R = case
    rng = np.random.RandomState(R)
    a1 = rng.randint(0, 256, (hb, wb)).astype(np.float32)
    a2 = (np.roll(a1, (2, -1), (0, 1))
          + rng.randint(0, 3, (hb, wb))).astype(np.float32)
    h, w = hb - 2 * ws, wb - 2 * ws
    g = flow.LevelGeometry(b=ws, h=h, w=w, ws=ws, patch=patch,
                           gh=h // patch, gw=w // patch, R=R, pred_bound=8)
    pred = (rng.randint(-5, 6, (g.gh, g.gw, 2)) * 2).astype(np.int32)
    t1, t2, tp = (torch.from_numpy(x).to(cuda) for x in (a1, a2, pred))
    fp, dp, vp = _level_by_plain(t1, t2, tp, g, 2)
    _, _, vk = flow.flow_match(t1, t2, tp, g)
    fk, dk = flow.flow_level(t1, t2, tp, g, 2)
    assert torch.equal(vk, vp)
    assert torch.equal(fk, fp) and torch.equal(dk, dp)


def test_flow_level_launches_twice_per_level(cuda):
    t1, t2, tp, g = _k1_inputs(K1_CASES[3], "float", cuda)
    reset_launch_counts()
    flow.flow_level(t1, t2, tp, g, 2)
    assert launch_counts()["flow_level"] == 2


def test_hough_acc_kernel_reproducible(cuda):
    frame = synthetic_line_clip(160, 120, 1)[0]
    img = from_array(torch.from_numpy(frame).to(cuda), border=3,
                     border_mode="mirror")
    for weight in ("binary", "magnitude"):
        t0i, r0i, ft, fr, wgt, rho_bins = hough._vote_bins(
            img, 63, None, 40.0, weight, None)
        th_n = (t0i.float() + ft).reshape(-1)
        rho_n = (r0i.float() + fr).reshape(-1)
        wv = wgt.reshape(-1).contiguous()
        a = hough_cuda.hough_acc(th_n, rho_n, wv, 63, rho_bins)
        b = hough_cuda.hough_acc(th_n, rho_n, wv, 63, rho_bins)
        p = hough_cuda.hough_acc_plain(th_n, rho_n, wv, 63, rho_bins)
        assert torch.equal(a, b)
        assert float((a - p).abs().max()) <= 1e-4 * float(p.max())


def _hough_votes(device, w, h, t_theta, weight):
    frame = synthetic_line_clip(w, h, 1)[0]
    img = from_array(torch.from_numpy(frame).to(device), border=3,
                     border_mode="mirror")
    t0i, r0i, ft, fr, wgt, rho_bins = hough._vote_bins(
        img, t_theta, None, 40.0, weight, None)
    return ((t0i.float() + ft).reshape(-1), (r0i.float() + fr).reshape(-1),
            wgt.reshape(-1).contiguous(), t_theta, rho_bins)


@pytest.mark.parametrize("weight", ["binary", "magnitude"])
def test_hough_acc_kernel_one_launch(cuda, weight):
    """K7 is one device kernel a call (no memset beside it), and gives the
    same bits across calls, across two shapes in a row, and from a weight
    vector that is not 16-byte aligned."""
    small = _hough_votes(cuda, 160, 120, 63, weight)
    large = _hough_votes(cuda, 640, 480, 255, weight)
    kernels = _device_kernels(lambda: hough_cuda.hough_acc(*small))
    assert sum(kernels.values()) == 1, kernels
    assert "hough" in next(iter(kernels)), kernels
    first = hough_cuda.hough_acc(*small)
    big = hough_cuda.hough_acc(*large)
    assert torch.equal(hough_cuda.hough_acc(*small), first)
    assert torch.equal(hough_cuda.hough_acc(*large), big)
    th, rho, w, tt, rb = small
    shifted = torch.cat([w.new_zeros(1), w])[1:]
    assert shifted.data_ptr() % 16 != 0
    reset_launch_counts()
    assert torch.equal(hough_cuda.hough_acc(th, rho, shifted, tt, rb), first)
    assert launch_counts()["hough_acc"] == 1
    for got, args in ((first, small), (big, large)):
        want = hough_cuda.hough_acc_plain(*args)
        assert float((got - want).abs().max()) <= 1e-4 * float(want.max())


def test_trackers_on_card_match_cpu(cuda):
    cfg = VideoExtruderConfig(capacity=256, detect_k=128, detector_period=2)
    clip = make_clip(128, 96, 6, seed=1)
    reset_launch_counts()
    _, (_, alive_k) = video_extruder_run(clip, cfg, device="cuda")
    counts = launch_counts()
    assert counts["fast9"] > 0 and counts["flow_level"] > 0
    _, (_, alive_c) = video_extruder_run(clip, cfg, device="cpu")
    nk, nc = int(alive_k[-1].sum()), int(alive_c[-1].sum())
    assert abs(nk - nc) <= 0.01 * nc
    hcfg = HoughTrackerConfig(m_first_lines=8, acc_threshold=10.0)
    sk = hough_tracker_init(hcfg, device="cuda")
    sc = hough_tracker_init(hcfg, device="cpu")
    for f in synthetic_line_clip(128, 96, 8):
        sk, _ = hough_tracker_update(
            sk, from_array(torch.from_numpy(f).to(cuda), border=3,
                           border_mode="mirror"), hcfg)
        sc, _ = hough_tracker_update(
            sc, from_array(f, border=3, border_mode="mirror"), hcfg)
    assert torch.equal(sk.age.cpu(), sc.age)
    assert torch.equal(sk.rho.cpu(), sc.rho)
    assert launch_counts()["hough_acc"] > 0


# -- K3 block top-K, K4 pyramid decimation, K5 patches, K6 window BA --------
#
# K3 and K5 are bit-equal to their plain versions; K4 is bit-equal on
# integer-valued frames (every partial sum is exact) and within 1e-6
# relative on float frames; K6's first-iteration S and cost (its trace) are
# within 1e-4 of the plain assembly relative to their largest magnitude,
# rhs within 1e-4 of the magnitude of its terms (``ba.rhs_term_scale``),
# two launches give the same bits, and its LM solve lands within 1e-4
# (poses) and 1e-3 px (landmark reprojections) of the plain LM loop on the
# same problem.


def _score_image(device, h, w, seed, zero_frac=0.6, kind="random"):
    """Random scores on (1 - zero_frac) of the pixels; or three distinct
    scores ("ties": long runs of equal scores across the CTAs' ranges); or
    one score everywhere ("constant")."""
    rng = np.random.RandomState(seed)
    if kind == "random":
        s = rng.randint(1, 256, (h, w)) * (rng.rand(h, w) > zero_frac)
    elif kind == "ties":
        s = rng.choice([0, 0, 7, 200], (h, w))
    else:
        s = np.full((h, w), 9)
    return from_array(torch.from_numpy(s.astype(np.uint8)).to(device),
                      border=1)


@pytest.mark.parametrize("h,w,bs,k,kind", [
    (480, 640, 10, 512, "random"), (37, 53, 7, 64, "random"),
    (128, 256, 1, 1000, "random"), (129, 256, 1, 8, "random"),
    (400, 400, 2, 4096, "random"), (400, 400, 2, 4096, "ties"),
    (2160, 3840, 10, 2048, "random"), (2160, 3840, 10, 2048, "ties"),
    (300, 200, 1, 2048, "constant"), (30, 40, 10, 100, "random")])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_block_topk_kernel_bit_equal(cuda, h, w, bs, k, kind, dtype):
    """nb = 3072 (the SLAM frame), 32768 and 33024 (the old cap and just
    above), 40000, 82944 (a 4K frame at 10 px), 60000 tied blocks; (30, 40,
    10): k > nb, padded. One launch per call."""
    img = _score_image(cuda, h, w, h + bs, kind=kind)
    img = from_array(img.interior.to(dtype), border=1)
    reset_launch_counts()
    got = fast._blockwise_keypoints(img, bs, k)
    assert launch_counts()["block_topk"] == 1
    want = fast._blockwise_keypoints_plain(img, bs, k)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_block_topk_kernel_on_fast_scores(cuda):
    frame = make_clip(640, 480, 1, seed=7)[0]
    img = from_array(torch.from_numpy(frame).to(cuda), border=9,
                     border_mode="mirror")
    s = fast.fast9_score_image(img, 10)
    got = fast._blockwise_keypoints(s, 10, 512)
    want = fast._blockwise_keypoints_plain(s, 10, 512)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[2].any())


@pytest.mark.parametrize("shape", [(480, 640), (61, 77), (96, 128)])
def test_pyramid_decim_kernel(cuda, shape):
    from vpp_tpu_torch.algorithms import pyramid as pyr
    rng = np.random.RandomState(shape[0])
    for kind in ("integer", "float"):
        a = (rng.randint(0, 256, shape) if kind == "integer"
             else rng.rand(*shape) * 255).astype(np.float32)
        img = from_array(torch.from_numpy(a).to(cuda), border=9,
                         border_mode="mirror")
        shapes = pyr.level_shapes(shape, 3)
        lvl_k = lvl_p = pyr.pyramid(img, 1, border=9)[0]
        for i in range(1, 3):
            lvl_k = pyr.decimate_level(lvl_k, *shapes[i], 9)
            lvl_p = pyr.Image2d(
                data=pyr.pad2d(pyr._binomial_decimate(lvl_p.interior,
                                                      *shapes[i]),
                               9, 9, 9, 9, "symmetric"), border=9)
            if kind == "integer":
                assert torch.equal(lvl_k.data, lvl_p.data), i
            else:
                rel = ((lvl_k.data - lvl_p.data).abs()
                       / lvl_p.data.abs().clamp(min=1e-30))
                assert float(rel.max()) <= 1e-6, (i, float(rel.max()))
            lvl_k = pyr.Image2d(data=lvl_p.data.clone(), border=9)


def _level_close(got, want, exact):
    """Bit-equal where ``exact``, else within 1e-6 relative per pixel."""
    if exact:
        return torch.equal(got, want)
    rel = (got - want).abs() / want.abs().clamp(min=1e-30)
    return float(rel.max()) <= 1e-6


@pytest.mark.parametrize("shape", [(480, 640), (61, 77), (37, 53)])
@pytest.mark.parametrize("nlevels", [1, 2, 3, 4])
def test_pyramid_kernel_whole_pyramid(cuda, shape, nlevels):
    """K4 builds the whole pyramid in one launch, from a raw frame and from
    a bordered frame's strided interior: bit-equal to the plain chain on
    integer-valued frames up to level 2 (every partial sum exact there;
    level 3 within 1e-6 relative), within 1e-6 relative on float frames."""
    from vpp_tpu_torch.algorithms import pyramid as pyr
    rng = np.random.RandomState(nlevels + shape[0])
    shapes = pyr.level_shapes(shape, nlevels)
    for kind in ("integer", "float"):
        a = torch.from_numpy((rng.randint(0, 256, shape) if kind == "integer"
                              else rng.rand(*shape) * 255 + 1).astype(
                                  np.float32)).to(cuda)
        want = pyr.pyramid_plain(a, shapes, 9)
        for img in (pyr.Image2d(data=a, border=0),
                    from_array(a, border=5, border_mode="closest")):
            reset_launch_counts()
            got = pyr.pyramid(img, nlevels, border=9)
            assert launch_counts()["pyramid_decim"] == 1
            assert len(got) == nlevels
            for lvl, (g, wl) in enumerate(zip(got.levels, want)):
                assert g.border == 9 and g.data.is_contiguous()
                assert _level_close(g.data, wl.data,
                                    kind == "integer" and lvl <= 2), (
                    kind, lvl)


@pytest.mark.parametrize("shape", [(480, 640), (61, 77), (37, 53)])
@pytest.mark.parametrize("nlevels", [3, 4])
def test_pyramid_kernel_barrier_design_same_bits(cuda, shape, nlevels):
    """Level 2 after a grid barrier (the design the fused level-2 tiles
    replaced, which ``call_times.py`` times beside them) gives the same
    bits as the fused tiles, in one launch."""
    from vpp_tpu_torch.algorithms import pyramid as pyr
    a = torch.from_numpy(np.random.RandomState(shape[1]).rand(*shape)
                         .astype(np.float32) * 255).to(cuda)
    shapes = pyr.level_shapes(shape, nlevels)
    fused = pyr._k4(a, shapes, 9, first=0)
    reset_launch_counts()
    barrier = pyr._k4(a, shapes, 9, first=0, fuse=False)
    assert launch_counts()["pyramid_decim"] == 1
    for f, b in zip(fused, barrier):
        assert torch.equal(f.data, b.data)


def test_pyramid_kernel_other_routes(cuda):
    """A float64 frame pads level 0 and launches K4 once a level; a uint8
    frame takes the integer chain (no K4); a level that cannot be
    decimated raises; nlevels 1 is the pad alone."""
    from vpp_tpu_torch.algorithms import pyramid as pyr
    a = np.random.RandomState(1).randint(0, 256, (61, 77))
    shapes = pyr.level_shapes((61, 77), 3)
    f64 = torch.from_numpy(a.astype(np.float64)).to(cuda)
    reset_launch_counts()
    got = pyr.pyramid(pyr.Image2d(data=f64, border=0), 3, border=9)
    assert launch_counts()["pyramid_decim"] == 2
    for g, wl in zip(got.levels, pyr.pyramid_plain(f64, shapes, 9)):
        assert g.data.dtype == torch.float64 and torch.equal(g.data, wl.data)
    u8 = torch.from_numpy(a.astype(np.uint8))
    reset_launch_counts()
    got = pyr.pyramid(pyr.Image2d(data=u8.to(cuda), border=0), 3, border=9)
    assert launch_counts()["pyramid_decim"] == 0
    for g, c in zip(got.levels, pyr.pyramid(pyr.Image2d(data=u8, border=0),
                                            3, border=9).levels):
        assert torch.equal(g.data.cpu(), c.data)
    thin = torch.ones((2, 40), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError):
        pyr.pyramid(pyr.Image2d(data=thin, border=0), 2, border=3)
    one = pyr.pyramid(pyr.Image2d(data=thin[:1], border=0), 1, border=3)
    assert torch.equal(one[0].data, from_array(thin[:1], border=3,
                                               border_mode="mirror").data)


def test_run_loops_build_one_pyramid_a_frame(cuda):
    """The tracker's run loop makes one K4 launch a frame, and one for the
    first frame's pyramid, and takes level 0 as the frame image."""
    cfg = VideoExtruderConfig(capacity=256, detect_k=128, detector_period=2)
    clip = make_clip(128, 96, 6, seed=2)
    reset_launch_counts()
    _, (pos_k, alive_k) = video_extruder_run(clip, cfg, device="cuda")
    assert launch_counts()["pyramid_decim"] == 7
    _, (pos_c, alive_c) = video_extruder_run(clip, cfg, device="cpu")
    nk, nc = int(alive_k[-1].sum()), int(alive_c[-1].sum())
    assert abs(nk - nc) <= 0.01 * nc


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8, torch.int32,
                                   torch.float64, torch.int16])
@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("index", [torch.int32, torch.int64])
def test_patches_kernel_bit_equal(cuda, dtype, channels, index):
    """K5 from int32 and int64 centres (some beyond the buffer) and from
    top-lefts: one launch a call, bit-equal to the plain versions."""
    from vpp_tpu_torch.core import interp
    rng = np.random.RandomState(channels)
    shape = (498, 658) + ((channels,) if channels else ())
    data = torch.from_numpy(rng.rand(*shape) * 255).to(dtype).to(cuda)
    ctr = torch.from_numpy(rng.randint(-5, 670, (1024, 2))).to(index).to(
        cuda)
    for size in (7, 9):
        reset_launch_counts()
        got = interp.extract_patches(data, ctr, size)
        assert launch_counts()["patches"] == 1
        want = interp.extract_patches_at_tl_plain(
            data, interp._clamp_tl(ctr.long() - size // 2, 498, 658, size),
            size)
        assert got.shape == want.shape and torch.equal(got, want)
        assert torch.equal(interp.extract_patches_plain(data, ctr, size),
                           want)
        tl = ctr - size // 2
        assert torch.equal(interp.extract_patches_at_tl(data, tl, size),
                           interp.extract_patches_at_tl_plain(data, tl, size))
        assert launch_counts()["patches"] == 2


def _ring_problem(device, n, m, seed, noise=0.5):
    from vpp_tpu_torch.slam.ba import BATracks
    from vpp_tpu_torch.slam.se3 import se3_exp
    rng = np.random.RandomState(seed)
    xi = np.zeros((m, 6), np.float32)
    xi[:, 3] = -np.linspace(0.0, 0.3, m)     # a 0.3 baseline
    xi[:, :3] = rng.randn(m, 3) * 0.01
    poses = se3_exp(torch.from_numpy(xi))
    X = torch.from_numpy((rng.rand(n, 3) * [4, 3, 2] + [-2, -1.5, 4])
                         .astype(np.float32))
    intr = torch.tensor([640.0, 640.0, 320.0, 240.0])
    pc = (poses[None, :, :3, :3] @ X[:, None, :, None])[..., 0] \
        + poses[None, :, :3, 3]
    uv = torch.stack([640 * pc[..., 1] / pc[..., 2] + 240,
                      640 * pc[..., 0] / pc[..., 2] + 320], -1)
    uv = uv + torch.from_numpy(rng.randn(n, m, 2).astype(np.float32) * noise)
    valid = torch.from_numpy(rng.rand(n, m) > 0.3)
    valid[:, 0] = valid[:, -1] = True       # two views a baseline apart
    valid[n // 2:n // 2 + 5] = False        # unseen landmarks
    Xn = X + torch.from_numpy(rng.randn(n, 3).astype(np.float32) * 0.02)
    fixed = torch.zeros(m, dtype=torch.bool)
    fixed[:2] = True
    p = BATracks(poses=poses, landmarks=Xn,
                 obs_pose=torch.arange(m, dtype=torch.int32)[None].expand(
                     n, m).contiguous(),
                 obs_uv=uv, obs_valid=valid, intrinsics=intr,
                 fixed_poses=fixed)
    return BATracks(*(t.to(device) for t in p))


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _check_fused(p, iters, lam0, linalg, huber=4.0):
    """K6's one launch against the plain LM loop on ``p``; returns the
    kernel's trace."""
    from vpp_tpu_torch.slam import ba, ba_cuda
    reset_launch_counts()
    out = ba_cuda.lm_tracks(p, iters, huber, lam0, linalg)
    assert launch_counts()["ba_tracks"] == 1
    again = ba_cuda.lm_tracks(p, iters, huber, lam0, linalg)
    for a, b in zip(out[:3] + tuple(out[3]), again[:3] + tuple(again[3])):
        assert _same_bits(a, b)
    poses, lms, costs, tr = out
    lam = torch.full((), lam0, device=p.poses.device)
    (Sp, rhsp, costp), _ = ba._tracks_assemble(p, lam, huber, True, linalg)
    assert _rel(tr.S, Sp) <= 1e-4 and _rel(tr.cost, costp) <= 1e-4
    assert float((tr.rhs - rhsp).abs().max()) <= 1e-4 * ba.rhs_term_scale(
        p, huber, True)
    sp, cp = ba._lm_tracks(p, iters, huber, lam0, True, linalg,
                           kernel=False)
    assert float((poses - sp.poses).abs().max()) <= 1e-4
    sk = p._replace(poses=poses, landmarks=lms)
    reproj = (ba.track_residuals(sk, True) - ba.track_residuals(
        sk._replace(landmarks=sp.landmarks), True)).abs().max()
    assert float(reproj) <= 1e-3
    assert _rel(costs, cp) <= 1e-4
    assert torch.equal(costs, torch.where(tr.accept != 0, tr.cost_after,
                                          tr.cost_before))
    return tr


@pytest.mark.parametrize("n,m", [(1024, 6), (1000, 16), (37, 3), (500, 8)])
@pytest.mark.parametrize("linalg", ["chol", "lu"])
def test_ba_tracks_kernel_matches_plain(cuda, n, m, linalg):
    """The fused LM solve (3 iterations, one launch) against the plain
    loop, and its trace's first-iteration S, rhs and cost against the plain
    assembly; ``ba_solve_tracks`` makes the same one launch. The windows
    take each size of the kernel's Cholesky staging and both tile sizes."""
    from vpp_tpu_torch.slam import ba, ba_cuda
    p = _ring_problem(cuda, n, m, n + m)
    tr = _check_fused(p, 3, 1e-4, linalg)
    assert float(tr.accept[0]) == 1.0      # the last steps may be noise
    reset_launch_counts()
    sk, ck = ba.ba_solve_tracks(p, iters=3, huber=4.0, lam0=1e-4,
                                ring_layout=True, linalg=linalg)
    assert launch_counts()["ba_tracks"] == 1
    poses, lms, costs, _ = ba_cuda.lm_tracks(p, 3, 4.0, 1e-4, linalg)
    assert _same_bits(sk.poses, poses) and _same_bits(sk.landmarks, lms)
    assert _same_bits(ck, costs)
    with pytest.raises(NotImplementedError):
        ba.ba_solve_tracks(p, iters=1, ring_layout=False)


@pytest.mark.parametrize("linalg", ["chol", "lu"])
@pytest.mark.parametrize("case", ["rejected", "failed"])
def test_ba_tracks_kernel_branches(cuda, case, linalg):
    """Every step rejected (landmarks thrown 2 units off: each candidate
    costs more), and the pose factorisation failing (no damping, no
    observation of free pose 2: dp is NaN): costs hold the first cost,
    lam grows, and nothing moves, as in the plain loop."""
    p = _ring_problem(cuda, 1024, 6, 7)
    lam0 = 1e-3
    if case == "rejected":
        rng = np.random.RandomState(5)
        p = p._replace(landmarks=p.landmarks + torch.from_numpy(
            rng.randn(1024, 3).astype(np.float32) * 2.0).to(cuda))
    else:
        valid = p.obs_valid.clone()
        valid[:, 2] = False
        p, lam0 = p._replace(obs_valid=valid), 0.0
    tr = _check_fused(p, 3, lam0, linalg)
    assert not bool((tr.accept != 0).any())
    assert bool((tr.cost_before == tr.cost).all())
    assert bool(torch.isnan(tr.dp).all()) == (case == "failed")
    if case == "rejected":
        assert bool((tr.lam[1:] > tr.lam[:-1]).all())


def test_ba_tracks_zero_iterations_on_card(cuda):
    """``ba_solve_tracks(iters=0)`` on a CUDA problem launches nothing and
    returns its inputs bit-equal with costs of shape (0,); K6's own entry
    refuses 0 iterations."""
    from vpp_tpu_torch.slam import ba, ba_cuda
    p = _ring_problem(cuda, 1024, 6, 3)
    reset_launch_counts()
    sk, ck = ba.ba_solve_tracks(p, iters=0, ring_layout=True, linalg="chol")
    assert launch_counts()["ba_tracks"] == 0
    assert _same_bits(sk.poses, p.poses) and _same_bits(sk.landmarks,
                                                        p.landmarks)
    assert tuple(ck.shape) == (0,) and ck.device.type == "cuda"
    assert ck.dtype == torch.float32
    with pytest.raises(ValueError):
        ba_cuda.lm_tracks(p, 0, 4.0, 1e-3, "chol")


def test_ba_tracks_kernel_rejects_large_windows(cuda):
    from vpp_tpu_torch.slam import ba_cuda
    p = _ring_problem(cuda, 64, 17, 0)
    with pytest.raises(ValueError):
        ba_cuda.lm_tracks(p, 1, 4.0, 1e-3, "chol")


def test_slam_on_card_matches_cpu(cuda):
    """A short SLAM run launches K1-K6 and tracks the plain CPU path."""
    from vpp_tpu_torch.slam import pipeline as sp
    from vpp_tpu_torch.utils.synth import (camera_path, make_cloud,
                                           render_frames)
    intr = (160.0, 160.0, 80.0, 60.0)
    pts = make_cloud(220, seed=0, extent=(6.0, 4.0, 3.0),
                     center=(0.8, 0.0, 5.0))
    poses = camera_path(25, step=(0.06, 0.0, 0.0))
    frames = render_frames(pts, poses, intr, (120, 160), seed=0)
    cfg = sp.SlamConfig(
        intrinsics=intr, keyframe_period=4, ring=6, ba_iters=3,
        min_parallax=2.0, max_reproj=2.0, history=16, enable_recovery=False,
        tracker=VideoExtruderConfig(capacity=256, detect_k=128, nscales=3,
                                    winsize=9, keypoint_spacing=8,
                                    detector_period=1, detector_th=8))
    boot = poses[[0, 4]]
    reset_launch_counts()
    sk = sp.slam_run(frames, cfg, bootstrap_poses=boot, device="cuda")
    counts = launch_counts()
    for name in ("flow_level", "fast9", "block_topk", "pyramid_decim",
                 "patches", "ba_tracks"):
        assert counts[name] > 0, name
    sc = sp.slam_run(frames, cfg, bootstrap_poses=boot, device="cpu")
    assert sk.n_keyframes == sc.n_keyframes == 7
    ek, fk = sp.keyframe_trajectory(sk)
    ec, fc = sp.keyframe_trajectory(sc)
    ate_k = float(sp.ate_rmse(ek.cpu(), torch.from_numpy(
        poses[fk.cpu().numpy()])))
    ate_c = float(sp.ate_rmse(ec, torch.from_numpy(poses[fc.numpy()])))
    assert ate_k < 0.065 and abs(ate_k - ate_c) < 0.01
