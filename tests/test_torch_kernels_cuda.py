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
integer-valued frames up to level 2 and within 1e-6 relative elsewhere;
``hough_accumulator_mxu`` and ``hough_sparse_revote`` one K7 launch each,
bit-equal to ``hough_accumulator`` with the same mask and weights; a Kalman
Hough tracker step with no host read; the painter the same bits twice;
K8's map-vote PnP one launch for every match set, bit-equal to its plain
version up to the PnP (shifts, j1, uv1, inl), T and err within 1e-4 and
n equal after it; K9 (the generic-layout BA, one launch a call) held
stage by stage to its plain version as chip_smoke.py's ``k9_check`` holds
it (the assembly within 1e-4, the first pose step's backward error on the
system it solved no more than 4x the library's solve of that system and
below 1e-5, NaN where the plain solve has one, the first candidate within
1e-4), the same bits twice, and a ring problem down K9 within 1e-5 of K6;
a loop
closure keyframe (the pose-graph smoother's full and refresh branches)
within 1e-4 of the plain CPU path from one state; K10 (LK) asked for one
level one launch, bit-equal to its plain version (flow, err, every window
sample, the Newton step counts), a whole coarse-to-fine pass one launch,
every level in it bit-equal to the plain level loop with either adopt
rule, a ``lucas_kanade`` call one K10 and two K4 launches and bit-equal to
the plain CPU path on the card's pyramids, a ``pyrlk_match`` call one K10
launch; K11 (jump flooding) asked for one pass one launch, bit-equal to
its plain version pass by pass (and from random claims), the whole
transform one launch bit-equal to the plain passes and to the CPU, and
an image whose squared diagonal reaches 1e9 refused; K1 at a column slice
(``col0`` left of, at and inside the image, ``w_total`` wider than the
slice) by the K1 rule above; and the sharded tracker at world size 1 over
NCCL bit-equal to ``video_extruder_update`` away from the margins, with
its launches a frame.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from vpp_tpu_torch.algorithms import fast, flow, hough, hough_cuda
from vpp_tpu_torch.algorithms.hough_tracker import (HoughTrackerConfig,
                                                    hough_tracker_init,
                                                    hough_tracker_update)
from vpp_tpu_torch.algorithms.video_extruder import (VideoExtruderConfig,
                                                     video_extruder_run)
from vpp_tpu_torch.core.image import Image2d, from_array
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
# is not a multiple of K1's tiles and a grid that outgrows the image, then
# the coarsest level searched at R 16 and 32
K1_CASES = [
    (138, 178, 9, 5, 0, 1),
    (258, 338, 9, 1, 10, 1),
    (498, 658, 9, 1, 22, 0),
    (71, 93, 9, 1, 10, 0),
    (71, 93, 9, 3, 6, 1),
    # the top level's search at search_niters 16 and 32 (1089 and 4225
    # displacements, past the 1024 K1 once took)
    (138, 178, 9, 16, 0, 1),
    (138, 178, 9, 32, 0, 1),
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


def _line_image(device, w=640, h=480):
    frame = synthetic_line_clip(w, h, 1)[0]
    return from_array(torch.from_numpy(frame).to(device), border=3,
                      border_mode="mirror")


def test_hough_mxu_and_revote_one_k7_launch(cuda):
    """``hough_accumulator_mxu`` and ``hough_sparse_revote`` on the card are
    one K7 launch a call, bit-equal to ``hough_accumulator`` with the same
    mask and weights."""
    img = _line_image(cuda)
    reset_launch_counts()
    mxu = hough.hough_accumulator_mxu(img, chunk=512)
    assert launch_counts()["hough_acc"] == 1
    assert torch.equal(mxu, hough.hough_accumulator(img))
    peaks, theta, rho, _ = hough.hough_lines(img, 4)
    near = hough._near_lines(img.shape, theta, rho, peaks.valid, 4.0)
    reset_launch_counts()
    rev = hough.hough_sparse_revote(img, theta, rho, peaks.valid, band=4.0)
    assert launch_counts()["hough_acc"] == 1
    want = hough.hough_accumulator(img, vote_weight="magnitude",
                                   pixel_mask=near)
    assert torch.equal(rev, want)
    assert float(rev.sum()) > 0


def test_kalman_tracker_step_reads_no_host(cuda):
    """A step of the Kalman Hough tracker (UKF bank predict and update,
    the Cholesky factors and 2x2 inverses included) under
    ``set_sync_debug_mode("error")``: no host read."""
    cfg = HoughTrackerConfig(m_first_lines=8, acc_threshold=10.0,
                             with_kalman_filter=True)
    st = hough_tracker_init(cfg, device="cuda")
    frames = [from_array(torch.from_numpy(f).to(cuda), border=3,
                         border_mode="mirror")
              for f in synthetic_line_clip(320, 240, 4)]
    for f in frames[:3]:
        st, _ = hough_tracker_update(st, f, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, _ = hough_tracker_update(st, frames[3], cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int((st.age > 0).sum()) >= 2
    assert bool(torch.isfinite(st.ukf_x[st.age > 0]).all())


def test_first_slice_helpers_on_card(cuda):
    """``pyramid_update`` is one K4 launch, bit-equal to ``pyramid``;
    ``kp_move`` with a slot named twice and ``bilinear_image`` give the
    CPU's result on the card (the last writer wins, deterministically)."""
    from vpp_tpu_torch.algorithms.pyramid import pyramid, pyramid_update
    from vpp_tpu_torch.core import keypoints as kp
    from vpp_tpu_torch.core.interp import bilinear_image
    frames = [torch.from_numpy(f).to(cuda) for f in make_clip(160, 120, 2)]
    pyr = pyramid(from_array(frames[0]), 3, border=9)
    reset_launch_counts()
    upd = pyramid_update(pyr, from_array(frames[1]))
    assert launch_counts()["pyramid_decim"] == 1
    want = pyramid(from_array(frames[1]), 3, border=9)
    for a, b in zip(upd.levels, want.levels):
        assert a.border == b.border and torch.equal(a.data, b.data)
    pos = torch.rand((8, 2)) * 50
    k = kp.keypoints_from_positions(pos, torch.ones(8, dtype=torch.bool))
    idx = torch.tensor([3, 1, 3, 7, 3])
    new = torch.rand((5, 2)) * 50
    want = kp.kp_move(k, idx, new)
    got = kp.kp_move(kp.Keypoints(*(t.to(cuda) for t in (
        k.position, k.velocity, k.age))), idx.to(cuda), new.to(cuda))
    for a, b in zip((got.position, got.velocity, got.age),
                    (want.position, want.velocity, want.age)):
        assert torch.equal(a.cpu(), b)
    img = from_array(frames[0], border=2, border_mode="mirror")
    pts = torch.rand((64, 2), device=cuda) * 120 - 2
    torch.testing.assert_close(
        bilinear_image(img, pts).cpu(),
        bilinear_image(from_array(frames[0].cpu(), border=2,
                                  border_mode="mirror"), pts.cpu()),
        rtol=1e-6, atol=1e-4)


def test_paint_hough_video_reproducible(cuda):
    """``paint_hough_video`` and ``draw_line_tracks`` give the same bits in
    two calls (the duplicate-pixel rule is deterministic)."""
    from vpp_tpu_torch.draw.hough_paint import (draw_line_tracks,
                                                paint_hough_video)
    cfg = HoughTrackerConfig(m_first_lines=8, acc_threshold=10.0)
    st = hough_tracker_init(cfg, device="cuda")
    for f in synthetic_line_clip(320, 240, 6):
        st, _ = hough_tracker_update(
            st, from_array(torch.from_numpy(f).to(cuda), border=3,
                           border_mode="mirror"), cfg)
    acc_shape = (cfg.t_theta, hough.default_rho_bins((240, 320)))
    paint = torch.zeros((240, 320, 4), device=cuda)
    a = paint_hough_video(paint, st, acc_shape)
    b = paint_hough_video(paint, st, acc_shape)
    assert torch.equal(a, b) and float(a[..., 3].max()) > 0
    frame = torch.zeros((240, 320, 3), dtype=torch.uint8, device=cuda)
    assert torch.equal(draw_line_tracks(frame, st, acc_shape),
                       draw_line_tracks(frame, st, acc_shape))


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
    pyr = importlib.import_module("vpp_tpu_torch.algorithms.pyramid")
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
    pyr = importlib.import_module("vpp_tpu_torch.algorithms.pyramid")
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


def test_pyramid_kernel_past_32_levels(cuda):
    """36 levels of a 61x77 frame (2x2 from level 6 on): two chained K4
    launches (32 levels, then the rest from the 32nd level's interior),
    every level within 1e-6 relative of the plain chain."""
    pyr = importlib.import_module("vpp_tpu_torch.algorithms.pyramid")
    a = torch.from_numpy(np.random.RandomState(36).rand(61, 77).astype(
        np.float32) * 255 + 1).to(cuda)
    shapes = pyr.level_shapes((61, 77), 36)
    reset_launch_counts()
    got = pyr.pyramid(pyr.Image2d(data=a, border=0), 36, border=5)
    assert launch_counts()["pyramid_decim"] == 2
    assert got[35].shape == (2, 2)
    for g, wl in zip(got.levels, pyr.pyramid_plain(a, shapes, 5)):
        assert _level_close(g.data, wl.data, False)


@pytest.mark.parametrize("shape", [(480, 640), (61, 77), (37, 53)])
@pytest.mark.parametrize("nlevels", [3, 4])
def test_pyramid_kernel_barrier_design_same_bits(cuda, shape, nlevels):
    """Level 2 after a grid barrier (the design the fused level-2 tiles
    replaced, which ``call_times.py`` times beside them) gives the same
    bits as the fused tiles, in one launch."""
    pyr = importlib.import_module("vpp_tpu_torch.algorithms.pyramid")
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
    frame takes the integer chain (no K4); a 2-row frame decimates to 2
    rows (the last tap wraps, as in ``_decim_matrix``) within K4's rule; a
    1-row level keeps its one row (every tap on it, as ``_decim_matrix``
    folds them), bit-equal to the plain chain; nlevels 1 is the pad
    alone."""
    pyr = importlib.import_module("vpp_tpu_torch.algorithms.pyramid")
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
    thin = torch.from_numpy(a[:2, :40].astype(np.float32)).to(cuda)
    got = pyr.pyramid(pyr.Image2d(data=thin, border=0), 2, border=3)
    want = pyr.pyramid_plain(thin, pyr.level_shapes((2, 40), 2), 3)
    assert got[1].shape == (2, 21)
    for g, wl in zip(got.levels, want):
        assert torch.equal(g.data, wl.data)
    reset_launch_counts()
    got = pyr.pyramid(pyr.Image2d(data=thin[:1], border=0), 2, border=3)
    assert launch_counts()["pyramid_decim"] == 1
    assert got[1].shape == (1, 21)
    for g, wl in zip(got.levels, pyr.pyramid_plain(
            thin[:1], pyr.level_shapes((1, 40), 2), 3)):
        assert _same_bits(g.data, wl.data)
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
    # the same problem down the generic route runs K9: costs within 1e-4,
    # poses within 1e-5 of K6's, landmarks within 1e-3 px in their
    # observations (this window's weakly seen landmarks move along their
    # rays with the solver's last bits: K6 factors the dense S, K9 its
    # band, each its own way; test_ba_generic_kernel_ring_matches_k6 holds
    # both at tests/test_slam_scale.py:131's recipe and tolerances)
    reset_launch_counts()
    sg, cg = ba.ba_solve_tracks(p, iters=3, huber=4.0, lam0=1e-4,
                                ring_layout=False, linalg=linalg)
    assert launch_counts()["ba_generic"] == 1
    assert launch_counts()["ba_tracks"] == 0
    assert _rel(cg, ck) <= 1e-4
    assert float((sg.poses - sk.poses).abs().max()) <= 1e-5
    assert float((ba.track_residuals(sg, True) - ba.track_residuals(
        sg._replace(landmarks=sk.landmarks), True)).abs().max()) <= 1e-3


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


def _generic_problem(device, n, m, k, seed, case="plain", noise=0.3,
                     rot=0.01, centre=False):
    """tests/test_slam_scale.py:13-40's recipe on the port's own maps: m
    poses stepping 0.1 in x, each landmark seen by k consecutive poses
    (``case="shuffled"``: k random distinct poses in random order),
    ``noise`` px of noise, the landmarks perturbed by 0.03, poses 0 and 1
    fixed. Cases: ``masked`` (slot 1 of every row thrown 500 px and
    masked), ``repeated`` (slot 1 of every 3rd row names slot 0's pose),
    ``unseen`` (landmarks 10-13 with no valid slot), ``nan_masked`` (a NaN
    measurement in a masked slot), ``out_of_range`` (one valid slot names
    pose m, one pose -1), ``closure`` (landmark 7 seen by poses 0 and m - 1:
    S's band spans the whole matrix), ``masked_far`` (the last slot of
    every 5th row masked and naming pose m - 1: the band stays the
    chain's), ``nonfinite`` (pose m - 1 NaN and named by masked slots only,
    the last slot of every 7th row from pose 8 on, pose 0 free: S's blocks
    between pose 0 and those rows' poses, outside the band, are NaN).
    ``rot``: radians of random rotation a step (a long chain takes less,
    or its heading wanders off the landmarks laid along x); ``centre``:
    the world origin at the middle pose's camera centre."""
    from vpp_tpu_torch.slam.ba import BATracks, project
    from vpp_tpu_torch.slam.se3 import se3_exp
    rng = np.random.RandomState(seed)
    xi = np.zeros((m, 6), np.float32)
    xi[1:, 3] = -0.1
    xi[1:, :3] = rng.randn(m - 1, 3) * rot
    steps = se3_exp(torch.from_numpy(xi))
    poses = [torch.eye(4)]
    for i in range(1, m):
        poses.append(steps[i] @ poses[-1])
    poses = torch.stack(poses)
    if case == "shuffled":
        op = np.stack([rng.permutation(m)[:k] for _ in range(n)])
        start = op.min(1)
    else:
        start = rng.randint(0, m - k + 1, size=n)
        op = start[:, None] + np.arange(k)[None]
    X = rng.rand(n, 3) * [2.0, 1.5, 1.0] + [-1.0, -0.75, 3.0]
    X[:, 0] += 0.1 * start
    X = torch.from_numpy(X.astype(np.float32))
    op = torch.from_numpy(op.astype(np.int32))
    if case == "closure":
        # in front of both ends of the chain, ~23 degrees off their axes
        op[7, 0], op[7, k - 1] = 0, m - 1
        X[7] = torch.tensor([0.05 * (m - 1), 0.0, 3.0 + 0.12 * (m - 1)])
    if centre:
        mid = poses[m // 2]
        c = -mid[:3, :3].T @ mid[:3, 3]
        poses[:, :3, 3] += poses[:, :3, :3] @ c
        X = X - c
    intr = torch.tensor([300.0, 300.0, 160.0, 120.0])
    uv = project(poses[op.long()], X[:, None], intr) + torch.from_numpy(
        (rng.randn(n, k, 2) * noise).astype(np.float32))
    valid = torch.ones((n, k), dtype=torch.bool)
    if case == "masked":
        uv[:, 1] += 500.0
        valid[:, 1] = False
    elif case == "repeated":
        op[::3, 1] = op[::3, 0]
    elif case == "unseen":
        valid[10:14] = False
    elif case == "nan_masked":
        uv[5, 1] = float("nan")
        valid[5, 1] = False
    elif case == "out_of_range":
        op[3, 0] = m
        op[9, k - 1] = -1
    elif case == "masked_far":
        op[::5, k - 1] = m - 1
        valid[::5, k - 1] = False
    elif case == "nonfinite":
        poses[m - 1] = float("nan")
        valid &= op != m - 1
        far = torch.from_numpy(start >= 8) & (torch.arange(n) % 7 == 0)
        op[far, k - 1] = m - 1
        valid[far, k - 1] = False
    # with one slot a landmark the poses learn nothing from the landmarks
    # (S is lam I, dp rhs / lam: rounding noise), so K = 1 fixes every pose
    # and its step moves the landmarks alone
    fixed = torch.ones(m, dtype=torch.bool) if k == 1 else torch.zeros(
        m, dtype=torch.bool)
    fixed[:2] = True
    if case == "nonfinite":
        fixed[:3] = torch.tensor([False, True, True])
    Xn = X + torch.from_numpy((rng.randn(n, 3) * 0.03).astype(np.float32))
    p = BATracks(poses=poses, landmarks=Xn, obs_pose=op, obs_uv=uv,
                 obs_valid=valid, intrinsics=intr, fixed_poses=fixed)
    return BATracks(*(t.to(device) for t in p)), X.to(device)


def _pred(p, poses, lms):
    """Predicted minus measured uv at every valid slot (0 elsewhere)."""
    from vpp_tpu_torch.slam import ba
    return ba.track_residuals(p._replace(poses=poses, landmarks=lms))


def _band(p):
    """S's block half-bandwidth as K9 takes it: the widest span of the
    poses that one landmark's valid slots scatter to (JAX's scatter rule:
    negative from the end, dropped outside [0, M))."""
    from vpp_tpu_torch.slam import ba
    m = p.poses.shape[0]
    idx = ba.scatter_index(p.obs_pose, m)
    ok = p.obs_valid & (idx < m)
    hi = torch.where(ok, idx, torch.full_like(idx, -1)).max(1).values
    lo = torch.where(ok, idx, torch.full_like(idx, m)).min(1).values
    return int(torch.where(hi >= 0, hi - lo, torch.zeros_like(hi)).max())


def _backward_error(A, x, b):
    """||A x - b||inf / (||A||inf ||x||inf + ||b||inf) in float64; 0 where
    the residual is exactly 0."""
    A, x, b = A.double(), x.double(), b.double()
    r = float((A @ x - b).abs().max())
    if r == 0.0:
        return 0.0
    return r / (float(A.abs().sum(1).max()) * float(x.abs().max())
                + float(b.abs().max()))


def _solve_backward_errors(tr, p, lam0, linalg):
    """K9's first pose solve against the library's on the same system, the
    one K9 solved (its S, rhs and Jacobi scales, damped, gauge-fixed and
    scaled in float32 in the kernel's order): their backward errors."""
    m = p.poses.shape[0]
    D = 6 * m
    dev = p.poses.device
    fx = p.fixed_poses[:, None].expand(m, 6).reshape(-1)
    eye = torch.eye(D, device=dev)
    S = torch.where(fx[:, None] | fx[None, :], eye,
                    tr.S.reshape(D, D) + lam0 * eye)
    d = tr.scale
    Sp = S * d[:, None] * d[None, :]
    bs = d * torch.where(fx, torch.zeros_like(d), tr.rhs.reshape(-1))
    if linalg == "chol":
        L, _ = torch.linalg.cholesky_ex(Sp)
        y = torch.linalg.solve_triangular(L, bs[:, None], upper=False)
        xl = torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]
    else:
        xl, _ = torch.linalg.solve_ex(Sp, bs)
    return _backward_error(Sp, tr.x, bs), _backward_error(Sp, xl, bs)


def _plain_f64_solves(p, iters, lam0, linalg, huber=4.0):
    """The plain LM loop with its pose solves in float64 (dp rounded to
    float32): how far the loop moves when only the solve's rounding
    does."""
    from vpp_tpu_torch.slam import ba
    solve = ba._tracks_solve_poses

    def f64(S, rhs, fixed, lam, linalg="lu"):
        lam = lam.double() if torch.is_tensor(lam) else lam
        return solve(S.double(), rhs.double(), fixed, lam, linalg).float()

    ba._tracks_solve_poses = f64
    try:
        return ba._lm_tracks(p, iters, huber, lam0, False, linalg,
                             kernel=False)
    finally:
        ba._tracks_solve_poses = solve


def _check_generic(p, iters, lam0, linalg, huber=4.0, twin="cpu"):
    """K9 against its plain version on ``p``, on the card, stage by stage
    on the same inputs (chip_smoke.py's ``k9_check``): one launch a call,
    the same bits twice; S's block half-bandwidth the widest span of a
    landmark's valid slots; the first iteration's S and rhs (on the free
    poses' rows and columns) and cost within 1e-4 of the plain assembly;
    its first pose step NaN everywhere or nowhere, and only where the plain
    solve of its own system has a NaN; else finite, d x, with a backward
    error on the system it solved below 1e-5 and no more than 4x the
    library's solve of that system where the library's factorisation
    holds; the first candidate (one iteration) within 1e-4 (cost, of the
    larger of the iterate's and the candidate's; poses, times the step's
    size where it passes 1) and 1e-3 px (predicted measurements, times the
    poses' extent over 10 units where it passes 10) of the plain step from
    that dp, with the same decision unless the costs tie within 1e-4; over
    the loop the last cost at most 1e-4 of the first (or 3x the
    plain loop's own CPU-to-card distance) above the plain loop's, and
    poses within 1e-4 of it where the plain loop lands within 1e-5 of
    itself on the CPU (``twin="f64"``: of itself with float64 pose
    solves on the card). Returns the kernel's result and trace."""
    from vpp_tpu_torch.slam import ba, ba_generic_cuda
    reset_launch_counts()
    out = ba_generic_cuda.lm_generic(p, iters, huber, lam0, linalg,
                                     trace=True)
    assert launch_counts()["ba_generic"] == 1
    again = ba_generic_cuda.lm_generic(p, iters, huber, lam0, linalg,
                                       trace=True)
    for a, b in zip(out[:3] + tuple(out[3]), again[:3] + tuple(again[3])):
        assert _same_bits(a, b)
    poses, lms, costs, tr = out
    assert int(tr.band) == _band(p)
    lam = torch.full((), lam0, device=p.poses.device)
    (Sp, rhsp, costp), local = ba._tracks_assemble(p, lam, huber, False,
                                                   linalg)
    finite = bool(torch.isfinite(costp))
    # S and rhs on the free poses' rows and columns (the pose solve's)
    free = (~p.fixed_poses)[:, None].expand(-1, 6).reshape(-1)
    D = free.numel()
    if finite:
        assert _rel(tr.cost, costp) <= 1e-4
    if finite and bool(free.any()):
        assert _rel(tr.S.reshape(D, D)[free][:, free],
                    Sp.reshape(D, D)[free][:, free]) <= 1e-4
        assert float((tr.rhs.reshape(-1) - rhsp.reshape(-1))[free].abs(
            ).max()) <= 1e-4 * ba.rhs_term_scale(p, huber, False)
    dp0 = tr.dp[0]
    want = ba._tracks_solve_poses(tr.S, tr.rhs, p.fixed_poses, lam, linalg)
    plain_failed = bool(torch.isnan(want).any())
    if bool(torch.isnan(dp0).any()):
        assert bool(torch.isnan(dp0).all()) and plain_failed
    else:
        assert bool(torch.isfinite(dp0).all())
        assert _same_bits(dp0.reshape(-1), tr.scale * tr.x)
        be_k9, be_lib = _solve_backward_errors(tr, p, lam0, linalg)
        # where the library's factorisation fails on a system positive
        # definite only up to float32 rounding, K9's x is held to the
        # equations alone
        assert (plain_failed or be_k9 <= 4 * be_lib) and be_k9 < 1e-5, (
            be_k9, be_lib)
    cand_p = ba.apply_pose_step(p.poses, dp0, p.fixed_poses)
    cand_l = p.landmarks + ba._tracks_backsub(local, dp0)
    new_p = ba._tracks_cost(p._replace(poses=cand_p, landmarks=cand_l),
                            huber)
    one = ba_generic_cuda.lm_generic(p, 1, huber, lam0, linalg)
    acc = bool(one[3].accept[0] != 0)
    if finite and bool(torch.isfinite(new_p)):
        assert float((one[3].cost_after[0] - new_p).abs()) <= 1e-4 * max(
            abs(float(costp)), abs(float(new_p)))
    if abs(float(new_p) - float(costp)) > 1e-4 * abs(float(costp)):
        assert acc == bool(new_p < costp)
    if acc:
        assert _dist(one[0], cand_p) <= 1e-4 * max(
            1.0, float(torch.nan_to_num(dp0).abs().max()))
        assert _dist(_pred(p, one[0], one[1]), _pred(p, cand_p, cand_l)) \
            <= 1e-3 * max(1.0, float(p.poses[:, :3, 3].abs().max()) / 10)
    sp, cp = ba._lm_tracks(p, iters, huber, lam0, False, linalg,
                           kernel=False)
    if twin == "cpu":
        sc, cc = ba._lm_tracks(ba.BATracks(*(t.cpu() for t in p)), iters,
                               huber, lam0, False, linalg, kernel=False)
    else:
        sc, cc = _plain_f64_solves(p, iters, lam0, linalg, huber)
    if finite:
        assert torch.equal(costs, torch.where(
            tr.accept != 0, tr.cost_after, tr.cost_before))
        assert float(costs[-1] - cp[-1]) <= max(
            1e-4 * float(cp.abs().max()),
            3 * abs(float(cc[-1]) - float(cp[-1])))
    else:
        assert torch.equal(torch.isnan(costs), torch.isnan(cp))
    if _dist(sp.poses.cpu(), sc.poses.cpu()) <= 1e-5:
        assert _dist(poses, sp.poses) <= 1e-4
    return out


def _dist(a, b):
    return float((a - b).abs().max())


@pytest.mark.parametrize("n,m,k,case", [
    (10240, 128, 4, "plain"), (1024, 16, 4, "plain"), (512, 6, 6, "plain"),
    (300, 12, 5, "shuffled"), (200, 8, 3, "masked"), (200, 8, 3, "repeated"),
    (200, 8, 3, "unseen"), (200, 8, 3, "nan_masked"),
    (200, 8, 3, "out_of_range"), (100, 4, 1, "plain"),
    (4096, 512, 4, "plain"), (256, 40, 32, "plain"),
    (1024, 16, 4, "closure"), (4000, 512, 4, "closure"),
    (1024, 16, 4, "masked_far"), (1024, 16, 4, "nonfinite")])
@pytest.mark.parametrize("linalg", ["chol", "lu"])
def test_ba_generic_kernel_matches_plain(cuda, n, m, k, case, linalg):
    """K9 (5 iterations at lam0 1e-4, the JAX scale test's) against its
    plain version, at the JAX package's production scale (N 10240, M 128,
    K 4; there also that test's gates), at test_slam_scale.py:107's M 16 x
    N 1024 x K 4, a window of K = M = 6, shuffled slots, K = 1 and the
    masked, repeated-pose, unseen, NaN and out-of-range cases, at K9's
    limits of 512 poses and 32 slots a landmark; a closure pair (the band
    the whole matrix: the dense factorisation, at 16 and at 512 poses),
    masked slots naming a far pose (the band stays the chain's, 3) and
    S's blocks outside the band NaN (dp NaN, every step rejected).
    ``ba_solve_tracks`` makes the same launch, with the same bits."""
    from vpp_tpu_torch.slam import ba
    full = (n, m, k) == (10240, 128, 4)      # the JAX recipe: no noise
    p, X = _generic_problem(cuda, n, m, k, n + m + k, case,
                            noise=0.0 if full else 0.3)
    poses, lms, costs, tr = _check_generic(p, 5, 1e-4, linalg)
    if full:
        assert float(costs[-1]) < float(costs[0]) * 1e-4
        assert float((lms - X).abs().median()) < 1e-2
    if case == "nan_masked":
        assert bool(torch.isnan(costs).all()) and not bool(tr.accept.any())
    if case in ("closure", "masked_far"):
        assert int(tr.band) == (m - 1 if case == "closure" else k - 1)
    if case == "nonfinite":
        b = int(tr.band)
        S = tr.S.reshape(m, 6, m, 6)
        assert not bool(torch.isfinite(S[b + 1:, :, 0]).all())
        assert bool(torch.isnan(tr.dp).all()) and not bool(tr.accept.any())
        assert _same_bits(poses, p.poses) and _same_bits(lms, p.landmarks)
    reset_launch_counts()
    sk, ck = ba.ba_solve_tracks(p, iters=5, lam0=1e-4, linalg=linalg)
    assert launch_counts()["ba_generic"] == 1
    assert _same_bits(sk.poses, poses) and _same_bits(sk.landmarks, lms)
    assert _same_bits(ck, costs)


@pytest.mark.parametrize("linalg", ["chol", "lu"])
def test_ba_generic_kernel_ring_matches_k6(cuda, linalg):
    """tests/test_slam_scale.py:131's ring problem (M 6, N 64, a third of
    the slots masked) down the generic route (K9) and the ring route (K6),
    at that test's tolerances: costs rtol 1e-4, poses and landmarks atol
    1e-5."""
    from vpp_tpu_torch.slam import ba
    from vpp_tpu_torch.slam.se3 import se3_exp
    rng = np.random.RandomState(4)
    m, n = 6, 64
    xi = np.zeros((m, 6), np.float32)
    xi[1:, 3] = -0.2
    steps = se3_exp(torch.from_numpy(xi))
    poses = [torch.eye(4)]
    for i in range(1, m):
        poses.append(steps[i] @ poses[-1])
    poses = torch.stack(poses)
    X = torch.from_numpy((rng.rand(n, 3) * 2 + [-1.0, -1.0, 3.0]).astype(
        np.float32))
    op = torch.arange(m, dtype=torch.int32)[None].expand(n, m).contiguous()
    intr = torch.tensor([300.0, 300.0, 160.0, 120.0])
    uv = ba.project(poses[None], X[:, None], intr)
    p = ba.BATracks(
        poses=poses, landmarks=X + torch.from_numpy(
            (rng.randn(n, 3) * 0.02).astype(np.float32)),
        obs_pose=op, obs_uv=uv, obs_valid=torch.from_numpy(
            rng.rand(n, m) > 0.3), intrinsics=intr,
        fixed_poses=torch.tensor([True, True] + [False] * (m - 2)))
    p = ba.BATracks(*(t.to(cuda) for t in p))
    reset_launch_counts()
    s1, c1 = ba.ba_solve_tracks(p, iters=4, lam0=1e-4, linalg=linalg)
    s2, c2 = ba.ba_solve_tracks(p, iters=4, lam0=1e-4, ring_layout=True,
                                linalg=linalg)
    assert launch_counts()["ba_generic"] == 1
    assert launch_counts()["ba_tracks"] == 1
    assert float(((c1 - c2).abs() / c2.abs()).max()) <= 1e-4
    assert float((s1.poses - s2.poses).abs().max()) <= 1e-5
    assert float((s1.landmarks - s2.landmarks).abs().max()) <= 1e-5


@pytest.mark.parametrize("linalg", ["chol", "lu"])
def test_ring_of_twenty_runs_k9(cuda, linalg):
    """A ring problem of 20 poses (more than K6's 16) on the card: one K9
    launch with ``obs_pose = arange(M)``, no K6 launch, the result the
    generic route's on the same problem, within the plain ring loop's
    tolerances on the card (costs 1e-4 relative to the largest, poses 1e-4
    where the plain loop lands within 1e-5 of itself on the CPU). With a
    stream dimension of 2 it is two K9 launches, one a stream, each
    stream's result the single problem's bits."""
    from vpp_tpu_torch.slam import ba
    p = _ring_problem(cuda, 600, 20, 20)
    reset_launch_counts()
    sr, cr = ba.ba_solve_tracks(p, iters=3, lam0=1e-4, ring_layout=True,
                                linalg=linalg)
    assert launch_counts()["ba_generic"] == 1
    assert launch_counts()["ba_tracks"] == 0
    sg, cg = ba.ba_solve_tracks(p, iters=3, lam0=1e-4, linalg=linalg)
    assert _same_bits(sr.poses, sg.poses) and _same_bits(cr, cg)
    assert sr.obs_pose is p.obs_pose
    sp, cp = ba._lm_tracks(p, 3, 4.0, 1e-4, True, linalg, kernel=False)
    sc, _ = ba._lm_tracks(ba.BATracks(*(t.cpu() for t in p)), 3, 4.0, 1e-4,
                          True, linalg, kernel=False)
    assert _rel(cr, cp) <= 1e-4
    if _dist(sp.poses.cpu(), sc.poses) <= 1e-5:
        assert _dist(sr.poses, sp.poses) <= 1e-4
    streams = ba.BATracks(*(t if i == 5 else t[None].expand(
        (2,) + t.shape).contiguous() for i, t in enumerate(p)))
    reset_launch_counts()
    ss, cs = ba.ba_solve_tracks(streams, iters=3, lam0=1e-4,
                                ring_layout=True, linalg=linalg)
    assert launch_counts()["ba_generic"] == 2
    assert launch_counts()["ba_tracks"] == 0
    for i in range(2):
        assert _same_bits(ss.poses[i], sr.poses) and _same_bits(cs[i], cr)
        assert _same_bits(ss.landmarks[i], sr.landmarks)


@pytest.mark.parametrize("linalg", ["chol", "lu"])
@pytest.mark.parametrize("case", ["rejected", "failed"])
def test_ba_generic_kernel_branches(cuda, case, linalg):
    """Every step rejected (the observations of free pose 5 displaced
    2000 px, lam0 1e-8: each candidate costs more, in a CPU run of the
    plain loop) and the pose factorisation failing (no damping, no valid
    slot on free pose 5: S has a zero row and column, dp is NaN): nothing
    moves, as in the plain loop."""
    p, _ = _generic_problem(cuda, 1024, 16, 4, 9)
    if case == "rejected":
        p = p._replace(obs_uv=p.obs_uv + 2000.0 * (p.obs_pose == 5)[
            ..., None])
        lam0 = 1e-8
    else:
        p, lam0 = p._replace(obs_valid=p.obs_valid & (p.obs_pose != 5)), 0.0
    poses, lms, costs, tr = _check_generic(p, 3, lam0, linalg)
    assert not bool((tr.accept != 0).any())
    assert bool((tr.cost_before == tr.cost).all())
    assert bool(torch.isnan(tr.dp).all()) == (case == "failed")
    assert _same_bits(poses, p.poses) and _same_bits(lms, p.landmarks)


def test_ba_generic_limits_and_zero_iterations(cuda):
    """K9 takes M 513 and K 33 (past its old limits of 512 poses and 32
    slots a landmark): one launch each, on the routes ``k9_routes`` names,
    with a finite, falling cost. It refuses only what it does not take
    (``ValueError``: no landmark, streams); ``ba_solve_tracks(iters=0)``
    launches nothing, and the generic layout with a stream dimension
    raises ``NotImplementedError`` before any launch."""
    from vpp_tpu_torch.slam import ba, ba_generic_cuda
    p, _ = _generic_problem(cuda, 64, 8, 3, 1)
    reset_launch_counts()
    sk, ck = ba.ba_solve_tracks(p, iters=0)
    assert launch_counts()["ba_generic"] == 0 and tuple(ck.shape) == (0,)
    assert _same_bits(sk.poses, p.poses)
    smem = ba_generic_cuda.smem_bytes()
    for big in (_generic_problem(cuda, 1024, 513, 3, 2)[0],
                _generic_problem(cuda, 256, 40, 33, 3)[0]):
        reset_launch_counts()
        _, _, costs, tr = ba_generic_cuda.lm_generic(big, 3, 4.0, 1e-3,
                                                     "lu")
        assert launch_counts()["ba_generic"] == 1
        m = big.poses.shape[0]
        assert ba_generic_cuda.routes_of_trace(tr) == \
            ba_generic_cuda.k9_routes(m, _band(big), "lu", smem)
        assert bool(torch.isfinite(costs).all())
        assert float(costs[-1]) < float(tr.cost)
    reset_launch_counts()
    for bad in (p._replace(landmarks=p.landmarks[:0],
                           obs_pose=p.obs_pose[:0], obs_uv=p.obs_uv[:0],
                           obs_valid=p.obs_valid[:0]),):
        with pytest.raises(ValueError):
            ba_generic_cuda.lm_generic(bad, 1, 4.0, 1e-3, "lu")
    streams = ba.BATracks(*(t if i == 5 else t[None].expand(
        (2,) + t.shape).contiguous() for i, t in enumerate(p)))
    with pytest.raises(NotImplementedError):
        ba.ba_solve_tracks(streams, iters=1)
    with pytest.raises(ValueError):
        ba_generic_cuda.lm_generic(streams, 1, 4.0, 1e-3, "lu")
    assert launch_counts()["ba_generic"] == 0


def test_ba_generic_kernel_stamps(cuda):
    """``lm_generic(stamps=)`` writes K9's clock: the stage ends in order
    (4 iters + 3 of them) and per iteration the solve's four sub-stages in
    SM cycles, with the same result bits and one launch; a stamps tensor
    of another size or type raises before any launch."""
    from vpp_tpu_torch.slam import ba_generic_cuda
    p, _ = _generic_problem(cuda, 512, 16, 4, 5)
    st = torch.full((8 * 3 + 3,), -1, dtype=torch.int64, device=cuda)
    reset_launch_counts()
    out = ba_generic_cuda.lm_generic(p, 3, 4.0, 1e-4, "lu", trace=True,
                                     stamps=st)
    assert launch_counts()["ba_generic"] == 1
    ns = st[:4 * 3 + 3].cpu()
    assert bool((ns[1:] >= ns[:-1]).all()) and int(ns[0]) > 0
    assert bool((st[4 * 3 + 3:] >= 0).all())
    ref = ba_generic_cuda.lm_generic(p, 3, 4.0, 1e-4, "lu", trace=True)
    for a, b in zip(out[:3] + tuple(out[3]), ref[:3] + tuple(ref[3])):
        assert _same_bits(a, b)
    reset_launch_counts()
    for bad in (st[:-1], st.float(), st.cpu()):
        with pytest.raises(ValueError):
            ba_generic_cuda.lm_generic(p, 3, 4.0, 1e-4, "lu", stamps=bad)
    assert launch_counts()["ba_generic"] == 0


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


@pytest.mark.parametrize("n,m,k,case", [
    (2048, 600, 4, "plain"), (400, 64, 40, "plain"), (1500, 300, 4,
                                                        "closure")])
@pytest.mark.parametrize("linalg", ["chol", "lu"])
def test_ba_generic_kernel_past_old_limits(cuda, n, m, k, case, linalg):
    """K9 past its old limits (512 poses, 32 slots a landmark), at sizes
    below chip_smoke.py's phase 16: 600 poses on a chain, 40 slots a
    landmark, and a closure over 300 poses (the band the whole matrix,
    its panel past 64 rows), held to its plain version as
    ``_check_generic`` holds it, the plain loop's spread taken from its
    float64-solve twin (chip_smoke.py phase 16's rule: a host twin that
    factorises alike agrees to 1e-5 where 40 slots a landmark leave the
    poses undetermined to ~1e-3). The chains turn by 0.01 (128 / M)^1.5
    radians a step (a path's drift across the landmarks grows as M^1.5)
    and are laid out about their middle pose."""
    p, _ = _generic_problem(cuda, n, m, k, n + m + k, case,
                            rot=0.01 * min(1.0, (128 / m) ** 1.5),
                            centre=True)
    _check_generic(p, 3, 1e-4, linalg, twin="f64")


def _k9_guarded(p, iters, lam0, linalg, smem, make):
    """``lm_generic``'s launch with every buffer, the workspace included,
    from ``make`` (between guard zones), routes chosen for ``smem``
    bytes. Returns (poses, landmarks, costs, per, S, extra)."""
    import ctypes
    from vpp_tpu_torch.kernels import _build, stream_handle
    lib = _build.load()
    n, k = p.obs_valid.shape
    m = p.poses.shape[0]
    D = 6 * m

    def copy(t, dtype=None):
        t = t.contiguous()
        if t.dtype == torch.bool:
            g = make((t.numel() + 3) // 4, torch.int32).view(torch.uint8)[
                :t.numel()].view(torch.bool).view(t.shape)
        else:
            g = make(t.numel(), t.dtype).view(t.shape)
        g.copy_(t)
        return g
    ins = [copy(t) for t in (p.poses, p.landmarks, p.obs_pose, p.obs_uv,
                             p.obs_valid, p.intrinsics, p.fixed_poses)]
    nbytes = ctypes.c_longlong(0)
    _build.check(lib.vpp_ba_generic_workspace(n, k, m, iters, smem,
                                              ctypes.byref(nbytes)), "ws")
    ws = make((nbytes.value + 3) // 4, torch.int32)
    outs = (make(16 * m), make(3 * n), make(iters), make(iters * (D + 4)),
            make(D * D), make(3 * D + 2), make(4))
    outs[4].zero_()
    code = lib.vpp_ba_generic_lm(
        *(t.data_ptr() for t in ins), n, k, m, iters, int(linalg == "lu"),
        smem, 4.0, float(lam0), *(t.data_ptr() for t in outs[:4]),
        outs[4].data_ptr(), outs[5].data_ptr(), outs[6].data_ptr(), None,
        ws.data_ptr(), stream_handle(ins[0]))
    _build.check(code, "ba_generic")
    return outs


@pytest.mark.parametrize("n,m,k,case", [
    (96, 24, 4, "plain"), (64, 12, 3, "closure"), (40, 36, 34, "plain")])
@pytest.mark.parametrize("linalg", ["chol", "lu"])
def test_ba_generic_device_routes_same_bits(cuda, n, m, k, case, linalg):
    """K9 with its routes chosen for 2 KB and for 256 bytes of shared
    memory a CTA (``lm_generic(smem=)``), where the index, the landmark
    stage, the step and the pose solve's panel read and write the
    workspace at these sizes: the routes ``k9_routes`` names, and every
    output the bits of the H100's routes. The device-memory run is
    repeated with every buffer, the workspace included, between guard
    zones: the card reports no fault, every guard holds, and the bits are
    the same."""
    from vpp_tpu_torch.slam import ba_generic_cuda as bg
    p, _ = _generic_problem(cuda, n, m, k, n + m, case)
    ref = bg.lm_generic(p, 3, 4.0, 1e-3, linalg, trace=True)
    seen = set()
    for smem in (128 + 2048, 128 + 256):
        reset_launch_counts()
        got = bg.lm_generic(p, 3, 4.0, 1e-3, linalg, trace=True, smem=smem)
        assert launch_counts()["ba_generic"] == 1
        routes = bg.routes_of_trace(got[3])
        assert routes == bg.k9_routes(m, _band(p), linalg, smem)
        seen |= set(routes.values())
        for a, b in zip(got[:3] + tuple(got[3])[:-1],
                        ref[:3] + tuple(ref[3])[:-1]):
            assert _same_bits(a, b)
    assert {"device", "grid_device"} <= seen
    held = []
    make, hold = _guarded(cuda, held)
    outs = _k9_guarded(p, 3, 1e-3, linalg, 128 + 256, make)
    assert hold()
    D = 6 * m
    assert _same_bits(outs[0].view(m, 4, 4), ref[0])
    assert _same_bits(outs[1].view(n, 3), ref[1])
    assert _same_bits(outs[2], ref[2])
    assert _same_bits(outs[4].view(m, 6, m, 6), ref[3].S)
    assert _same_bits(outs[5][:D].view(m, 6), ref[3].rhs)
    assert [int(v) for v in outs[6].tolist()] == [0, 0, 0, 0]


def _pnp_case(device, a_n, q_n, b_n, kind, seed, p=7):
    """Seeded K8 operands on a 640x480 frame: map points in front of the
    camera, detections at their projections under the true pose (rounded,
    some entries unseen) and outliers, the prior pose off by a drift, and
    descriptors that the true detection's centre patch repeats. ``kind``:
    "random", "ties" (the second half of the detections repeats the first:
    exact distance ties), "empty_base" (no usable entry), "no_valid",
    "three_valid" (three valid detections), "nan_row" (a NaN map point).
    Returns (operands, keyword arguments) of ``map_vote_pnp``."""
    rng = np.random.RandomState(seed)
    intr = np.asarray([640.0, 640.0, 320.0, 240.0], np.float32)
    z = rng.uniform(3.0, 8.0, a_n)
    X = np.stack([(rng.uniform(0, 640, a_n) - 320) * z / 640,
                  (rng.uniform(0, 480, a_n) - 240) * z / 640, z], 1)
    T_true = np.eye(4)
    T_true[:3, 3] = [0.05, -0.03, 0.02]
    T_prior = T_true.copy()
    T_prior[:2, 3] += [0.12, -0.08]                 # the drift to undo
    xc = X @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([640 * xc[:, 1] / xc[:, 2] + 240,
                   640 * xc[:, 0] / xc[:, 2] + 320], 1)
    n_src = min(q_n, a_n) if q_n <= 8 else min(q_n, a_n) * 3 // 4
    src = rng.permutation(a_n)[:n_src]
    pos = np.stack([rng.randint(0, 480, q_n), rng.randint(0, 640, q_n)], 1)
    pos[:len(src)] = np.round(uv[src])
    pos = np.clip(pos, 0, [479, 639])
    if kind == "ties":
        pos[q_n // 2:] = pos[:q_n - q_n // 2]
    valid = rng.rand(q_n) > 0.1
    desc = (rng.rand(a_n, p * p) > 0.5) * 8.0   # binary textures
    det = (rng.rand(9, q_n, p * p) > 0.5) * 8.0
    det[4, :len(src)] = desc[src] + rng.normal(0, 0.1, (len(src), p * p))
    base = rng.rand(b_n, a_n) > np.linspace(0.1, 0.5, b_n)[:, None]
    if kind == "empty_base":
        base[:] = False
    if kind == "no_valid":
        valid[:] = False
    if kind == "three_valid":
        valid[:] = False
        valid[:3] = True
    if kind == "nan_row":
        X[5] = np.nan
    ops = (X.astype(np.float32), desc.astype(np.float32), base,
           pos.astype(np.int32), valid, det.astype(np.float32),
           T_prior.astype(np.float32), intr)
    kw = dict(r_wide=24.0, bmax=1.2, gate=0.35, rounds=2, pnp_iters=6,
              huber=4.0)
    return tuple(torch.from_numpy(v).to(device) for v in ops), kw


def _same_pnp_outputs(got, want, one_pair=False):
    """Shifts, j1, uv1 and inl bit-equal; T and err within 1e-4 (NaN where
    the plain version has NaN); n equal. With ``one_pair`` (every set has
    a single pair) T and err are held only where the plain version's are
    finite: one pair leaves four of the pose's six directions to the 1e-4
    damping, which float32 loses beside the 6x6's other terms, so rounding
    decides whether a factorisation fails, the plain one as K8's."""
    assert _same_bits(got.txy, want.txy) and _same_bits(got.uv1, want.uv1)
    assert torch.equal(got.j1, want.j1) and torch.equal(got.inl, want.inl)
    assert torch.equal(got.n, want.n)
    if one_pair:
        assert bool((want.inl.sum(1) == 1).all())
    for g, w in ((got.T, want.T), (got.err, want.err)):
        if not one_pair:
            assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        if bool(ok.any()):
            assert float((g[ok] - w[ok]).abs().max()) <= 1e-4


@pytest.mark.parametrize("a_n,q_n,b_n,kind", [
    (1024, 512, 2, "random"), (37, 3, 2, "random"), (1024, 4096, 2, "random"),
    (1000, 333, 1, "random"), (9000, 512, 1, "random"),
    (7, 1, 2, "random"), (1024, 512, 2, "ties"), (300, 40, 2, "ties"),
    (1024, 512, 2, "empty_base"),
    (1024, 512, 2, "no_valid"), (1024, 512, 2, "three_valid"),
    (1000, 333, 2, "nan_row")])
def test_map_vote_kernel_bit_equal(cuda, a_n, q_n, b_n, kind):
    """K8, one cluster launch for every match set, against
    ``_map_vote_pnp_plain`` on the card: the shifts, ``j1``, ``uv1`` and
    ``inl`` bit-equal, T and err within 1e-4, ``n`` equal, and two
    launches bit-identical."""
    from vpp_tpu_torch.slam import map_vote as mv
    ops, kw = _pnp_case(cuda, a_n, q_n, b_n, kind, a_n + q_n + b_n)
    want = mv._map_vote_pnp_plain(*ops, **kw)
    runs = []
    for _ in range(2):
        reset_launch_counts()
        runs.append(mv.map_vote_pnp(*ops, **kw))
        assert launch_counts()["map_vote"] == 1
        _same_pnp_outputs(runs[-1], want, one_pair=q_n == 1)
    assert all(_same_bits(a, b) if a.dtype == torch.float32
               else torch.equal(a, b) for a, b in zip(*runs))
    if kind in ("empty_base", "no_valid"):
        assert torch.equal(runs[0].T, ops[6].expand(b_n, 4, 4))
        assert bool((runs[0].err == 0).all() and (runs[0].n == 0).all())
    elif kind in ("random", "ties") and q_n > 40:
        assert int(runs[0].n.min()) > 50
    elif kind == "nan_row":
        assert bool(torch.isnan(runs[0].T).all())


@pytest.mark.parametrize("a_n,q_n,b_n,smem", [
    (1024, 4096, 2, 1024), (300, 40, 2, 64), (1024, 24000, 2, None)])
def test_map_vote_device_route(cuda, a_n, q_n, b_n, smem):
    """K8 on its device route (the detections and the inlier bit sets in
    device memory): where ``smem`` leaves the detections no room, and at
    Q 24000, past what a CTA's shared memory stages on the H100. Against
    ``_map_vote_pnp_plain`` as ``test_map_vote_kernel_bit_equal`` holds
    it; where the staged route also runs, the two routes' outputs are the
    same bits. Then the launch with every buffer, the bit sets included,
    between guard zones: no fault, every guard holds, the same bits."""
    import ctypes
    from vpp_tpu_torch.kernels import _build, stream_handle
    from vpp_tpu_torch.slam import map_vote as mv
    ops, kw = _pnp_case(cuda, a_n, q_n, b_n, "random", q_n)
    card = mv.smem_bytes(cuda)
    assert mv.k8_route(q_n, card if smem is None else smem) == "device"
    want = mv._map_vote_pnp_plain(*ops, **kw)
    reset_launch_counts()
    got = mv.map_vote_pnp(*ops, **kw, smem=smem)
    assert launch_counts()["map_vote"] == 1
    _same_pnp_outputs(got, want)
    if mv.k8_route(q_n, card) == "shared":
        staged = mv.map_vote_pnp(*ops, **kw)
        assert all(_same_bits(a, b) if a.dtype == torch.float32
                   else torch.equal(a, b) for a, b in zip(got, staged))
    held = []
    make, hold = _guarded(cuda, held)

    def copy(t):
        t = t.contiguous()
        if t.dtype == torch.bool:
            g = make((t.numel() + 3) // 4, torch.int32).view(torch.uint8)[
                :t.numel()].view(torch.bool).view(t.shape)
        else:
            g = make(t.numel(), t.dtype).view(t.shape)
        g.copy_(t)
        return g
    gops = [copy(t) for t in ops]
    rounds = kw["rounds"]
    outs = (make(16 * b_n), make(b_n), make(b_n, torch.int32),
            make(2 * b_n * rounds), make(b_n * a_n, torch.int32),
            make(2 * b_n * a_n), make((b_n * a_n + 3) // 4, torch.int32))
    code_buf = make(4 * b_n * a_n, torch.int32)
    pair_t = make(8 * b_n * a_n)
    bits = make(b_n * mv.CLUSTER * ((q_n + 31) // 32), torch.int32)
    bmax_f, step_f = mv._vote_steps(kw["bmax"])
    rc = _build.load().vpp_map_vote_pnp(
        *(t.data_ptr() for t in gops), a_n, q_n, b_n, ops[1].shape[1],
        rounds, kw["pnp_iters"], float(kw["r_wide"]) ** 2, bmax_f, step_f,
        (2.0 * mv.vote_step(kw["bmax"])) ** 2, 2.0 * kw["gate"],
        kw["huber"], kw["huber"] / 2, *(t.data_ptr() for t in outs),
        code_buf.data_ptr(), pair_t.data_ptr(), bits.data_ptr(), 0,
        stream_handle(gops[0]))
    _build.check(rc, "map_vote_pnp")
    assert hold()
    assert _same_bits(outs[0].view(b_n, 4, 4), got.T)
    assert _same_bits(outs[1], got.err) and torch.equal(outs[2], got.n)
    assert torch.equal(outs[4].view(b_n, a_n), got.j1)
    assert torch.equal(outs[6].view(torch.uint8)[:b_n * a_n].view(
        torch.bool).view(b_n, a_n), got.inl)


def test_full_slam_engine_on_card_matches_cpu(cuda):
    """``SlamConfig(intrinsics=...)`` at its defaults (recovery on) on a
    short run: K8 launches once a keyframe, and the card tracks the plain
    CPU path."""
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
        min_parallax=2.0, max_reproj=2.0, history=16,
        tracker=VideoExtruderConfig(capacity=256, detect_k=128, nscales=3,
                                    winsize=9, keypoint_spacing=8,
                                    detector_period=1, detector_th=8))
    boot = poses[[0, 4]]
    reset_launch_counts()
    sk = sp.slam_run(frames, cfg, bootstrap_poses=boot, device="cuda")
    assert launch_counts()["map_vote"] == sk.n_keyframes
    sc = sp.slam_run(frames, cfg, bootstrap_poses=boot, device="cpu")
    assert sk.n_keyframes == sc.n_keyframes == 7
    assert int(sk.lc_ptr) == int(sc.lc_ptr)
    assert torch.equal(sk.pg_w.cpu(), sc.pg_w)
    assert float((sk.hist_pose.cpu() - sc.hist_pose).abs().max()) < 1e-2


@pytest.fixture
def card_loop_keyframe(cuda):
    """The card's state and frame just before the last keyframe that
    accepts a closure in the first 29 frames of the out-and-back loop with
    a drift spike (tests/test_pose_graph_loop.py:59's scene)."""
    from vpp_tpu_torch.slam import pipeline as sp
    from vpp_tpu_torch.utils.synth import make_cloud, render_frames
    intr = (160.0, 160.0, 80.0, 60.0)
    pts = make_cloud(220, seed=0, extent=(6.0, 4.0, 3.0),
                     center=(0.4, 0.0, 5.0))
    xs = list(np.arange(20) * 0.06)
    xs += list(xs[-1] - np.arange(1, 21) * 0.06)
    poses = np.tile(np.eye(4, dtype=np.float32), (len(xs), 1, 1))
    poses[:, 0, 3] = -np.asarray(xs)
    frames = render_frames(pts, poses, intr, (120, 160), seed=0,
                           sigma=(1.0, 1.8)).copy()
    frames[10:13] = 0.0
    cfg = sp.SlamConfig(
        intrinsics=intr, keyframe_period=4, ring=6, ba_iters=3,
        min_parallax=2.0, max_reproj=2.0, history=24, lc_min_gap=8,
        lc_min_inliers=10, lc_max_err=4.5,
        tracker=VideoExtruderConfig(capacity=256, detect_k=128, nscales=3,
                                    winsize=9, keypoint_spacing=8,
                                    detector_period=1, detector_th=8))
    kept, do_kf = [], sp._do_keyframe

    def keep(state, frame2, cfg_, **kw):
        out = do_kf(state, frame2, cfg_, **kw)
        if int(out.lc_ptr) > int(state.lc_ptr):
            kept.append((state, frame2))
        return out

    sp._do_keyframe = keep
    try:
        sp.slam_run(frames[:29], cfg, bootstrap_poses=poses[[0, 4]],
                    device="cuda")
    finally:
        sp._do_keyframe = do_kf
    assert len(kept) >= 1
    return kept[-1] + (cfg,)


@pytest.mark.parametrize("branch", ["full", "refresh"])
def test_loop_closure_keyframe_on_card_matches_cpu(card_loop_keyframe,
                                                   branch, monkeypatch):
    """A closure keyframe of the loop scenario from one state on the card
    and on the plain CPU path: the ring (``lc_ptr``, ``lc_j``) equal, and
    ``lc_w``, ``lc_T``, the smoothed history and the window poses within
    1e-4 (the CPU tests' tolerance against JAX), in the smoother's full
    branch (a new closure) and its refresh branch."""
    from vpp_tpu_torch import convert
    from vpp_tpu_torch.core.image import Image2d
    from vpp_tpu_torch.slam import pipeline as sp
    state, frame, cfg = card_loop_keyframe
    if branch == "refresh":      # no new closure: the refresh branch
        cfg = dataclasses.replace(cfg, lc_min_inliers=10 ** 6)
    m = convert.slam_state_to_numpy(state)
    cframe = Image2d(data=frame.data.cpu(), border=frame.border)
    got = sp._do_keyframe(state, frame, cfg)
    want = sp._do_keyframe(convert.slam_state_from_numpy(m, device="cpu"),
                           cframe, cfg)
    assert int(got.lc_ptr) == int(want.lc_ptr) == int(state.lc_ptr) + (
        branch == "full")
    assert torch.equal(got.lc_j.cpu(), want.lc_j)
    for name in ("lc_w", "lc_T", "hist_pose", "kf_pose"):
        err = float((getattr(got, name).cpu()
                     - getattr(want, name)).abs().max())
        assert err <= 1e-4, (name, err)
    # the smoother ran: without it the history ends elsewhere
    monkeypatch.setattr(sp, "_smooth_history", lambda h, *a, **k: h)
    raw = sp._do_keyframe(convert.slam_state_from_numpy(m, device="cpu"),
                          cframe, cfg).hist_pose
    assert float((want.hist_pose - raw).abs().max()) > 0.05


# -- streams: each kernel on S streams in one launch ------------------------

STREAM_KERNELS = ["k1", "k2_image", "k2_cull", "k3", "k4", "k5", "k6"]


def _bits(a, b):
    if isinstance(a, (tuple, list)):
        return all(_bits(x, y) for x, y in zip(a, b))
    if a.dtype == torch.float32:
        return _same_bits(a, b)
    return a.shape == b.shape and torch.equal(a, b)


def _stream_frames(device, n, h=120, w=160, integer=False):
    frames = np.stack([make_clip(w, h, 3, seed=i)[2] for i in range(n)])
    if integer:
        frames = np.round(frames)
    return torch.from_numpy(frames.astype(np.float32)).to(device)


@pytest.mark.parametrize("kernel", STREAM_KERNELS)
def test_stream_kernels_one_launch_bit_equal(cuda, kernel):
    """Each of K1-K6 on S = 3 streams (K3 also 8 and 16) in one launch
    (K1: two a level), bit-equal to S separate launches and to its batched
    plain version (K1 and K4 on integer-valued frames). K6 against the
    plain LM loop on these synthetic windows: poses within 1e-4 and costs
    within 1e-4 as in phase 3, landmark reprojections within 1e-2 px: on
    these windows the plain loop's own pose solves (batched and one by
    one on the card, and the CPU's) move a landmark's reprojections by
    more than phase 3's 1e-3 px from each other."""
    pyr = importlib.import_module("vpp_tpu_torch.algorithms.pyramid")
    from vpp_tpu_torch.core import interp
    from vpp_tpu_torch.slam import ba, ba_cuda
    s3, b = 3, 9
    rng = np.random.RandomState(4)
    fr = _stream_frames(cuda, s3, integer=kernel in ("k1", "k4"))
    shapes = pyr.level_shapes((120, 160), 3)

    def one_launch(key, fn, n=1):
        reset_launch_counts()
        out = fn()
        assert launch_counts()[key] == n, key
        return out

    lv = pyr.pyramid_streams(fr, 3, border=b)
    if kernel == "k4":
        got = one_launch("pyramid_decim",
                         lambda: pyr.pyramid_streams(fr, 3, border=b))
        for i in range(s3):
            single = pyr._k4(fr[i], shapes, b, first=0)
            assert _bits([g[i] for g in got], [x.data for x in single])
        assert _bits(got, pyr._plain_levels(fr, shapes, b))
    elif kernel == "k1":
        lv2 = pyr.pyramid_streams(torch.roll(fr, (1, 2), (-2, -1)), 3,
                                  border=b)
        for lvl, R, pb in ((2, 5, 0), (1, 1, 10), (0, 1, 6)):
            h, w = shapes[lvl]
            g = flow.LevelGeometry(b=b, h=h, w=w, ws=9, patch=5,
                                   gh=max(h // 5, 1), gw=max(w // 5, 1), R=R,
                                   pred_bound=pb)
            pred = torch.from_numpy((rng.randint(-(pb // 2), pb // 2 + 1, (
                s3, g.gh, g.gw, 2)) * 2).astype(np.int32)).to(cuda)
            a1, a2 = torch.round(lv[lvl]), torch.round(lv2[lvl])
            got = one_launch("flow_level",
                             lambda: flow.flow_level(a1, a2, pred, g, 2), 2)
            for i in range(s3):
                assert _bits([x[i] for x in got],
                             flow.flow_level(a1[i], a2[i], pred[i], g, 2))
            f, d, v = flow._match_plain(a1, a2, pred, g)
            for _ in range(2):
                f, d = flow._propagate_plain(f, d, pred, v, g.R)
            assert _bits(got, (f, d))
            for shape in flow._VOLUME_SHAPES:      # both tiles, same bits
                plan = flow._k1_plan(g, 2, flow._sm_count(a1.device),
                                     (shape,), s3)
                vol, part = flow._launch_volume(a1, a2, pred, g, plan)
                assert _bits(flow._launch_select(
                    vol, pred, g.R, 2, plan.b_tile, part,
                    domain=(g.h, g.w, g.patch)), got)
    elif kernel == "k2_image":
        mask = torch.from_numpy((rng.rand(s3, 120, 160) > 0.3).astype(
            np.uint8)).to(cuda)
        got = one_launch("fast9",
                         lambda: fast.score_image(lv[0], b, 10, mask))
        for i in range(s3):
            assert _bits(got[i], fast.score_image(lv[0][i], b, 10, mask[i]))
        assert _bits(got, fast._score_image_plain(lv[0], b, 10, mask))
    elif kernel == "k2_cull":
        pos = torch.from_numpy((rng.rand(s3, 500, 2) * [130, 170] - 5)
                               .astype(np.float32)).to(cuda)
        got = one_launch("fast9", lambda: fast.cull_scores(lv[0], b, pos, 10))
        for i in range(s3):
            assert _bits(got[i], fast.cull_scores(lv[0][i], b, pos[i], 10))
        assert _bits(got, fast._cull_plain(lv[0], b, pos, 10))
    elif kernel == "k3":
        fr16 = _stream_frames(cuda, 16)
        img = fast.score_image(pyr.pyramid_streams(fr16, 1, border=b)[0], b,
                               8)
        for n in (s3, 8, 16):
            got = one_launch("block_topk",
                             lambda: fast.block_topk(img[:n], 1, 8, 128))
            for i in range(n):
                assert _bits([x[i] for x in got],
                             fast.block_topk(img[i], 1, 8, 128))
            assert _bits(got, fast._block_topk_plain(img[:n, 1:-1, 1:-1], 8,
                                                     128))
    elif kernel == "k5":
        ctr = torch.from_numpy(rng.randint(-4, 180, (s3, 300, 2)).astype(
            np.int32)).to(cuda)
        got = one_launch("patches",
                         lambda: interp.extract_patches(lv[0], ctr, 7))
        for i in range(s3):
            assert _bits(got[i], interp.extract_patches(lv[0][i], ctr[i], 7))
        assert _bits(got, interp.extract_patches_plain(lv[0], ctr, 7))
    else:
        probs = [_ring_problem(cuda, 512, 6, 10 + i) for i in range(s3)]
        p = ba.BATracks(*(probs[0][i] if i == 5 else torch.stack(
            [q[i] for q in probs]) for i in range(7)))
        got = one_launch("ba_tracks", lambda: ba_cuda.lm_tracks(
            p, 3, 4.0, 1e-4, "chol"))
        flat = got[:3] + tuple(got[3])
        for i, q in enumerate(probs):
            one = ba_cuda.lm_tracks(q, 3, 4.0, 1e-4, "chol")
            assert all(x is None and y is None or _same_bits(x[i], y)
                       for x, y in zip(flat, one[:3] + tuple(one[3])))
        sp, cp = ba._lm_tracks(p, 3, 4.0, 1e-4, True, "chol", kernel=False)
        assert float((got[0] - sp.poses).abs().max()) <= 1e-4
        sk = p._replace(poses=got[0], landmarks=got[1])
        assert float((ba.track_residuals(sk, True) - ba.track_residuals(
            sk._replace(landmarks=sp.landmarks), True)).abs().max()) <= 1e-2
        assert float(((got[2] - cp).abs() / cp.abs().amax(
            -1, keepdim=True)).max()) <= 1e-4
        assert ba_cuda.max_active_clusters(6) >= 1


def test_slam_run_streams_on_card(cuda):
    """Two 120x160 clips through ``slam_run_streams`` on the card: the
    launches of one stream, and each stream's tracker bit-equal to
    ``slam_run`` on its clip on the card, the history within 0.05."""
    from vpp_tpu_torch.slam import pipeline as sp
    from vpp_tpu_torch.utils.synth import (camera_path, make_cloud,
                                           render_frames)
    intr = (160.0, 160.0, 80.0, 60.0)
    poses = camera_path(16, step=(0.06, 0.0, 0.0))
    frames = np.stack([render_frames(make_cloud(
        220, seed=s, extent=(6.0, 4.0, 3.0), center=(0.8, 0.0, 5.0)), poses,
        intr, (120, 160), seed=s) for s in range(2)])
    cfg = sp.SlamConfig(
        intrinsics=intr, keyframe_period=4, ring=6, ba_iters=3,
        min_parallax=2.0, max_reproj=2.0, history=16, enable_recovery=False,
        tracker=VideoExtruderConfig(capacity=256, detect_k=128, nscales=3,
                                    winsize=9, keypoint_spacing=8,
                                    detector_period=1, detector_th=8))
    boot = np.stack([poses[[0, 4]]] * 2)
    reset_launch_counts()
    st = sp.slam_run_streams(frames, cfg, boot, device="cuda")
    streams = launch_counts()
    for s in range(2):
        reset_launch_counts()
        one = sp.slam_run(frames[s], cfg, bootstrap_poses=boot[s],
                          device="cuda")
        assert launch_counts() == streams
        assert torch.equal(one.tracker.keypoints.alive,
                           st.tracker.keypoints.alive[s])
        assert torch.equal(one.tracker.keypoints.position,
                           st.tracker.keypoints.position[s])
        assert one.n_keyframes == st.n_keyframes == 4
        assert float((one.hist_pose - st.hist_pose[s]).abs().max()) <= 0.05


# -- K10 (the LK level) and K11 (the jump-flooding pass) ----------------------

def _lk_frames(device, h, w, shift=2, border=9):
    clip = make_clip(w, h, 1 + shift, seed=h)
    return [from_array(torch.from_numpy(f).to(device), border=border,
                       border_mode="mirror") for f in (clip[0], clip[shift])]


@pytest.mark.parametrize("h,w,n,ws", [(128, 160, 48, 11), (61, 77, 17, 7),
                                      (96, 128, 64, 15)])
def test_lk_level_kernel_bit_equal(cuda, h, w, n, ws):
    """K10 against its plain version on the same inputs: asked for one
    level, one launch, the flow, err, every window sample and the Newton
    step counts bit-equal (the plain version sums in the kernel's lane
    order); a whole ``lucas_kanade`` call one K10 and two K4 launches, its
    levels (in the one launch, windows included) bit-equal to the plain
    level loop, and the call equal to the plain CPU path on the card's
    pyramids."""
    lk = importlib.import_module("vpp_tpu_torch.algorithms.lk")
    pyramid = importlib.import_module(
        "vpp_tpu_torch.algorithms.pyramid").pyramid
    i1, i2 = _lk_frames(cuda, h, w)
    rng = np.random.RandomState(n)
    kp = torch.from_numpy((rng.rand(n, 2) * [h - 1, w - 1]).astype(
        np.float32)).to(cuda)
    border = max(3, ws // 2)
    pp, pn = pyramid(i1, 3, border=border), pyramid(i2, 3, border=border)
    pg = lk.gradient_pyramid(pp)
    kw = dict(winsize=ws, min_ev=1e-4, niterations=21,
              convergence_delta=0.1)
    tr = torch.zeros_like(kp)
    for s in (2, 1, 0):
        tr = tr * 2.0
        args = (pp[s], pn[s], pg[s], kp / float(2 ** s), tr)
        reset_launch_counts()
        got = lk.lk_level(*args, windows=True, **kw)
        assert launch_counts()["lk_level"] == 1
        want = lk.lk_match_batch_plain(*args, windows=True, **kw)
        for g, x in zip(got, want):
            assert torch.equal(g, x), s
        assert torch.equal(lk.lk_match_batch(*args, **kw)[0], got[0])
        tr = got[0]
    reset_launch_counts()
    flow, dist = lk.lucas_kanade(i1, i2, kp, winsize=ws)
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts == {"lk_level": 1, "pyramid_decim": 2}
    assert torch.equal(flow, tr)
    levels = [(pp[s], pn[s], pg[s]) for s in (2, 1, 0)]
    got = lk.lk_levels(levels, [2, 1, 0], kp, torch.zeros_like(kp),
                       adopt="always", factor=2.0, windows=True, **kw)
    want = lk.lk_levels_plain(levels, [2, 1, 0], kp, torch.zeros_like(kp),
                              adopt="always", factor=2.0, windows=True, **kw)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert torch.equal(got[0], flow) and torch.equal(got[1], dist)
    cpu = [Image2d(data=lvl.data.cpu(), border=lvl.border) for lvl in pp]
    cpn = [Image2d(data=lvl.data.cpu(), border=lvl.border) for lvl in pn]
    cpg = lk.gradient_pyramid(type(pp)(levels=tuple(cpu)))
    tr = torch.zeros((n, 2))
    for s in (2, 1, 0):
        tr, err = lk.lk_match_batch(cpu[s], cpn[s], cpg[s],
                                    kp.cpu() / float(2 ** s), tr * 2.0, **kw)
    assert torch.equal(tr, flow.cpu()) and torch.equal(err, dist.cpu())


@pytest.mark.parametrize("nscales,pred,n", [(1, False, 13), (3, True, 33),
                                            (4, False, 31), (4, True, 4)])
def test_lk_levels_kernel_glue(cuda, nscales, pred, n):
    """K10 with every level in one launch, against the plain level loop on
    the same pyramids: both adopt rules (always; where err < max_err, with
    max_err equal to some keypoints' err), a prediction, and keypoint
    counts that are not a multiple of the 4 a CTA takes; every level's
    flow, err, windows and Newton steps bit-equal, and ``pyrlk_match`` one
    launch."""
    lk = importlib.import_module("vpp_tpu_torch.algorithms.lk")
    PY = importlib.import_module("vpp_tpu_torch.algorithms.pyramid")
    kps_mod = importlib.import_module("vpp_tpu_torch.core.keypoints")
    i1, i2 = _lk_frames(cuda, 128, 160)
    pp, pn = PY.pyramid(i1, nscales, border=9), PY.pyramid(i2, nscales,
                                                           border=9)
    pg = lk.gradient_pyramid(pp)
    rng = np.random.RandomState(n)
    kp = torch.from_numpy((rng.rand(n, 2) * [127, 159]).astype(
        np.float32)).to(cuda)
    tr0 = (torch.from_numpy(rng.randn(n, 2).astype(np.float32)).to(cuda)
           if pred else torch.zeros_like(kp))
    scales = list(range(nscales - 1, -1, -1))
    levels = [(pp[s], pn[s], pg[s]) for s in scales]
    kw = dict(winsize=11, min_ev=1e-4, niterations=21,
              convergence_delta=0.1)
    first = lk.lk_levels_plain(levels[:1], scales[:1], kp, tr0,
                               adopt="always", factor=pp.factor, **kw)[1]
    kept = first[first < 1e30]
    max_err = float(kept.median()) if kept.numel() else 2.0
    for adopt in ("always", "below"):
        reset_launch_counts()
        got = lk.lk_levels(levels, scales, kp, tr0, adopt=adopt,
                           factor=pp.factor, max_err=max_err, windows=True,
                           **kw)
        assert launch_counts()["lk_level"] == 1
        want = lk.lk_levels_plain(levels, scales, kp, tr0, adopt=adopt,
                                  factor=pp.factor, max_err=max_err,
                                  windows=True, **kw)
        for g, x in zip(got, want):
            assert torch.equal(g, x), adopt
        plain = lk.lk_levels(levels, scales, kp, tr0, adopt=adopt,
                             factor=pp.factor, max_err=max_err, **kw)
        assert torch.equal(plain[0], got[0]) and torch.equal(plain[1],
                                                             got[1])
    kps = kps_mod.keypoints_from_positions(kp, torch.ones(
        n, dtype=torch.bool, device=cuda))
    reset_launch_counts()
    moved = lk.pyrlk_match(pp, pg, pn, kps)
    assert launch_counts()["lk_level"] == 1
    cpu = [Image2d(data=lvl.data.cpu(), border=lvl.border) for lvl in pp]
    cpp = type(pp)(levels=tuple(cpu), factor=pp.factor)
    cpn = type(pp)(levels=tuple(Image2d(data=lvl.data.cpu(),
                                        border=lvl.border) for lvl in pn),
                   factor=pn.factor)
    cmoved = lk.pyrlk_match(cpp, lk.gradient_pyramid(cpp), cpn,
                            kps_mod.keypoints_from_positions(
                                kp.cpu(), torch.ones(n, dtype=torch.bool)))
    assert torch.equal(moved.alive.cpu(), cmoved.alive)
    assert torch.equal(moved.position.cpu(), cmoved.position)


def test_lk_level_kernel_edges(cuda):
    """Keypoints on and beyond the image edge, a prediction that leaves the
    search patch, no iteration, and no keypoint: bit-equal, one launch."""
    lk = importlib.import_module("vpp_tpu_torch.algorithms.lk")
    pyramid = importlib.import_module(
        "vpp_tpu_torch.algorithms.pyramid").pyramid
    i1, i2 = _lk_frames(cuda, 64, 80)
    pp, pn = pyramid(i1, 1, border=5), pyramid(i2, 1, border=5)
    pg = lk.gradient_pyramid(pp)
    kp = torch.tensor([[0.0, 0.0], [63.0, 79.0], [-3.5, 40.0], [70.0, -2.0],
                       [31.5, 40.5], [20.0, 20.0]], device=cuda)
    tr = torch.tensor([[0.0, 0.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0],
                       [30.0, -30.0], [0.5, 0.5]], device=cuda)
    for niter in (0, 1, 21):
        kw = dict(winsize=11, min_ev=1e-4, niterations=niter,
                  convergence_delta=0.1)
        got = lk.lk_level(pp[0], pn[0], pg[0], kp, tr, windows=True, **kw)
        want = lk.lk_match_batch_plain(pp[0], pn[0], pg[0], kp, tr,
                                       windows=True, **kw)
        for g, x in zip(got, want):
            assert torch.equal(g, x), niter
    reset_launch_counts()
    f, e = lk.lk_level(pp[0], pn[0], pg[0], kp[:0], tr[:0], winsize=11,
                       min_ev=1e-4, niterations=21, convergence_delta=0.1)
    assert f.shape == (0, 2) and e.shape == (0,)
    assert launch_counts()["lk_level"] == 0


@pytest.mark.parametrize("h,w,p,seed_at,seed", [
    (96, 128, 0.002, None, 96), (7, 90, 0.02, None, 7),
    (540, 960, 0.001, None, 540), (33, 17, 0.0, None, 33),
    (1, 300, 0.01, None, 301), (200, 1, 0.02, None, 201),
    (1, 31000, 0.0, (0, 0), 31001), (540, 960, 0.0, "tiles", 1500)])
def test_jfa_kernel_bit_equal(cuda, h, w, p, seed_at, seed):
    """K11: ``jfa_pass`` one launch at every stride of the schedule and at
    strides at or beyond a side, bit-equal to its plain version from the
    schedule's state and from random claims (every pixel some coordinate
    in the image, a fifth none); the whole transform one launch, bit-equal
    to the plain passes on the card and to the CPU. ``(1, 31000)`` puts
    its one seed at an end, so that real distances come near the JAX
    loop's 1e9 for "none"; ``"tiles"`` puts seeds on both sides of every
    tile edge of the finest pass."""
    dt = importlib.import_module("vpp_tpu_torch.algorithms.distance_transform")
    rng = np.random.RandomState(seed)
    m = rng.rand(h, w) < p
    if seed_at == "tiles":
        lg_lr, tr, lg_lc, tc = dt._jfa_plan(h, w, 1, dt._jfa_shape(cuda))
        for r in range(0, h, tr):
            m[r, ::tc] = True
            m[max(r - 1, 0), max(tc - 1, 0)::tc] = True
    elif seed_at is not None:
        m[seed_at] = True
    else:
        m[h // 2, w // 3] = True
    mask = torch.from_numpy(m).to(cuda)
    rr = torch.arange(h, dtype=torch.int32, device=cuda)[:, None].expand(h, w)
    cc = torch.arange(w, dtype=torch.int32, device=cuda)[None, :].expand(h, w)
    none = torch.full((h, w), -(1 << 20), dtype=torch.int32, device=cuda)
    br, bc = torch.where(mask, rr, none), torch.where(mask, cc, none)
    gone = torch.from_numpy(rng.rand(h, w) < 0.2).to(cuda)
    claims = tuple(torch.where(gone, none, torch.from_numpy(
        rng.randint(0, n, (h, w)).astype(np.int32)).to(cuda))
        for n in (h, w))
    steps = dt._steps(h, w)
    # the schedule's passes, then the larger strides on the final state
    for q, step in enumerate(steps + (h, w, max(h, w) + 3, 1 << 20)):
        for state in ((br, bc), claims):
            reset_launch_counts()
            got = dt.jfa_pass(*state, step)
            assert launch_counts()["jfa"] == 1
            want = dt.jfa_pass_plain(*state, step)
            assert torch.equal(got[0], want[0]), step
            assert torch.equal(got[1], want[1]), step
            if q < len(steps) and state[0] is br:
                nxt = got
        if q < len(steps):
            br, bc = nxt
    reset_launch_counts()
    d, v = dt.euclidean_distance_transform(mask)
    assert launch_counts()["jfa"] == 1
    pd, pv = dt._jump_flood(mask, dt.jfa_pass_plain)
    assert torch.equal(d, pd) and torch.equal(v, pv)
    dc, vc = dt.euclidean_distance_transform(m, device="cpu")
    assert torch.equal(d.cpu(), dc) and torch.equal(v.cpu(), vc)
    fr = torch.where(br <= -(1 << 20), 0, br - rr)
    assert torch.equal(fr, v[..., 0])


@pytest.mark.parametrize("h,w,p", [
    (1, 1, 1.0), (1, 5, 0.3), (5, 1, 0.3), (2, 3, 0.0), (33, 17, 0.05),
    (7, 90, 0.02), (129, 257, 0.003), (540, 960, 0.001),
    (1080, 1920, 0.0005)])
def test_jfa_kernel_stays_in_its_buffers(cuda, h, w, p):
    """K11 reads and writes only inside its buffers: every buffer of the
    transform (mask, distance, vectors, both scratch planes) and of each
    pass asked alone (two planes in, two out) lies between two guard
    zones of 64 Ki elements that hold a pattern; after each launch the
    card reports no fault, every guard still holds its pattern, and the
    result equals the plain version."""
    dt = importlib.import_module("vpp_tpu_torch.algorithms.distance_transform")
    guard, pattern = 1 << 16, -0x5A5A5A5B
    held = []

    def guarded(n, dtype=torch.int32):
        buf = torch.full((2 * guard + n,), pattern, dtype=torch.int32,
                         device=cuda)
        held.append(buf)
        return buf[guard:guard + n].view(dtype)

    def guards_hold():
        torch.cuda.synchronize()
        return all(bool((b[:guard] == pattern).all())
                   and bool((b[-guard:] == pattern).all()) for b in held)

    rng = np.random.RandomState(h * w)
    m = rng.rand(h, w) < p
    mbuf = torch.full((2 * guard + h * w,), 0xA5, dtype=torch.uint8,
                      device=cuda)
    mbuf[guard:guard + h * w] = torch.from_numpy(m.ravel()).to(cuda)
    mask = mbuf[guard:guard + h * w].view(torch.bool).view(h, w)
    steps = dt._steps(h, w)
    vec = guarded(2 * h * w).view(h, w, 2)
    dist = guarded(h * w, torch.float32).view(h, w)
    scratch = tuple(guarded(2 * h * w, torch.float32).view(h, w, 2)
                    for _ in range(2))
    dt._launch_k11(h, w, steps, (None, None), (dist, vec), scratch=scratch,
                   mask=mask)
    assert guards_hold()
    assert bool((mbuf[:guard] == 0xA5).all())
    assert bool((mbuf[guard + h * w:] == 0xA5).all())
    pd, pv = dt._jump_flood(mask, dt.jfa_pass_plain)
    assert torch.equal(dist, pd) and torch.equal(vec, pv)
    gone = torch.from_numpy(rng.rand(h, w) < 0.2).to(cuda)
    none = torch.full((h, w), -(1 << 20), dtype=torch.int32, device=cuda)
    for step in steps + (max(h, w) + 3,):
        planes = []
        for n in (h, w):
            plane = guarded(h * w).view(h, w)
            plane.copy_(torch.where(gone, none, torch.from_numpy(
                rng.randint(0, n, (h, w)).astype(np.int32)).to(cuda)))
            planes.append(plane)
        out = (guarded(h * w).view(h, w), guarded(h * w).view(h, w))
        dt._launch_k11(h, w, (step,), tuple(planes), out)
        assert guards_hold(), step
        want = dt.jfa_pass_plain(*planes, step)
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


def test_jfa_kernel_refuses_wide_images(cuda):
    """Past a squared diagonal of 1e9 the JAX loop takes neighbours wrapped
    around the image (its "no candidate" distance is 1e9); K11 refuses
    such an image, and launches nothing."""
    dt = importlib.import_module("vpp_tpu_torch.algorithms.distance_transform")
    m = torch.zeros((1, 40000), dtype=torch.bool, device=cuda)
    reset_launch_counts()
    with pytest.raises(ValueError, match="1e9"):
        dt.euclidean_distance_transform(m)
    planes = torch.zeros((2, 1, 40000), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="1e9"):
        dt.jfa_pass(planes[0], planes[1], 1)
    assert launch_counts()["jfa"] == 0


# (case of K1_CASES, col0, w_total): a column slice's origin left of the
# image (the sharded tracker's rank 0), at it, and inside it, each of a
# level wider than the slice
K1_SLICES = [(1, -40, 640), (1, 0, 321), (2, 60, 900), (4, -13, 130)]


@pytest.mark.parametrize("kind", ["float", "integer"])
@pytest.mark.parametrize("slice_", K1_SLICES)
def test_flow_level_kernel_column_slice(cuda, slice_, kind):
    """K1's rejection against a column slice of a wider level (``col0``,
    ``w_total``, the sharded tracker's levels): the match and the whole
    level against the plain version by the K1 rule (bit-equal on
    integer-valued buffers, the near-tie rule on float ones), and some
    cells really rejected at the slice's own edges or kept past them."""
    case, col0, w_total = slice_
    t1, t2, tp, g0 = _k1_inputs(K1_CASES[case], kind, cuda)
    g = dataclasses.replace(g0, col0=col0, w_total=w_total)
    assert g.domain == (g.h, g.w, g.patch, col0, w_total)
    fk, dk, vk = flow.flow_match(t1, t2, tp, g)
    fp, dp, vp = flow.flow_match_plain(t1, t2, tp, g)
    _, d0, _ = flow.flow_match_plain(t1, t2, tp, g0)
    assert not torch.equal(dp >= 1e29, d0 >= 1e29)     # the slice matters
    if kind == "float":
        two = torch.topk(vp, 2, dim=0, largest=False).values
        clear = (two[1] - two[0]) > 1e-5 * two[0].abs().clamp(min=1e-30)
        assert bool(((fk == fp).all(-1) | ~clear).all())
        assert torch.allclose(dk[clear], dp[clear], rtol=1e-5, atol=0)
    else:
        assert torch.equal(fk, fp) and torch.equal(dk, dp)
    lf, ld = flow.flow_level(t1, t2, tp, g, 2)
    pf, pd, _ = _level_by_plain(t1, t2, tp, g, 2)
    if kind == "integer":
        assert torch.equal(lf, pf) and torch.equal(ld, pd)
    else:
        sf, sd = flow.flow_propagate(fk, dk, tp, vk, g.R, iters=2)
        assert torch.equal(lf, sf) and torch.equal(ld, sd)


@pytest.fixture
def nccl_one_rank(cuda, tmp_path):
    """A process group of this process alone over NCCL."""
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    yield
    dist.destroy_process_group()


def test_sharded_update_one_rank_nccl(cuda, nccl_one_rank):
    """The sharded tracker at world size 1 over NCCL (the ring degenerates
    to the edge fills; the flow, cull and candidate collectives go through
    NCCL) against ``video_extruder_update`` on the card: ``age``,
    ``position`` and ``traj_len`` the same bits with the margin killed
    between steps, and one K4, six K1 and one K2 launch a frame plus a
    score image a detection."""
    from vpp_tpu_torch.core.keypoints import kp_kill_where
    from vpp_tpu_torch.parallel import make_mesh
    from vpp_tpu_torch.parallel.sharded_tracker import (
        sharded_video_extruder_update)
    ve = importlib.import_module("vpp_tpu_torch.algorithms.video_extruder")
    w, h = 240, 96
    cfg = VideoExtruderConfig(capacity=512, detect_k=256, nscales=3,
                              winsize=9, keypoint_spacing=10,
                              detector_period=2, detector_th=10)
    b = max(3, cfg.winsize)
    mesh = make_mesh((1,), ("sp",))
    clip = torch.from_numpy(make_clip(w, h, 5, seed=2)).to(cuda)

    def kill_margin(st):
        col = st.keypoints.position[:, 1]
        bad = st.keypoints.alive & ((col < 40) | (col >= w - 80))
        return dataclasses.replace(
            st, keypoints=kp_kill_where(st.keypoints, bad))

    ref = ve.video_extruder_init(cfg, device="cuda")
    sh = ve.video_extruder_init(cfg, device="cuda")
    for i in range(len(clip)):
        f1, f2 = clip[max(i - 1, 0)], clip[i]
        ref = ve.video_extruder_update(
            ref, from_array(f1, border=b, border_mode="mirror"),
            from_array(f2, border=b, border_mode="mirror"), cfg)
        reset_launch_counts()
        sh = sharded_video_extruder_update(mesh, sh, f1, f2, cfg)
        counts = launch_counts()
        assert counts["pyramid_decim"] == 1
        assert counts["flow_level"] == 2 * cfg.nscales
        assert counts["fast9"] == 1 + (sh.frame_id % 2 == 0)
        for name in ("age", "position"):
            assert torch.equal(getattr(ref.keypoints, name),
                               getattr(sh.keypoints, name)), (i, name)
        assert torch.equal(ref.traj_len, sh.traj_len)
        ref, sh = kill_margin(ref), kill_margin(sh)
    assert int(sh.keypoints.alive.sum()) > 50


# -- past the kernels' old limits: K10 at any winsize and depth, K1 at any
#    displacement count and window, K9 on a ring of streams -----------------

def _lk_setup(cuda, h, w, n, ws, nscales, frame_border=9):
    lk = importlib.import_module("vpp_tpu_torch.algorithms.lk")
    PY = importlib.import_module("vpp_tpu_torch.algorithms.pyramid")
    i1, i2 = _lk_frames(cuda, h, w, border=frame_border)
    border = max(3, ws // 2)
    pp, pn = PY.pyramid(i1, nscales, border=border), PY.pyramid(
        i2, nscales, border=border)
    pg = lk.gradient_pyramid(pp)
    scales = list(range(nscales - 1, -1, -1))
    levels = [(pp[s], pn[s], pg[s]) for s in scales]
    rng = np.random.RandomState(n + ws)
    kp = torch.from_numpy((rng.rand(n, 2) * [h - 1, w - 1]).astype(
        np.float32)).to(cuda)
    return lk, PY, (i1, i2), (pp, pn, pg), scales, levels, kp


# (h, w, keypoints, winsize): the staged route at OpenCV's 21 and 31, the
# global one at 121 (one warp's patches no longer fit 227 KB)
LK_WIDE = [(128, 160, 40, 21), (128, 160, 33, 31), (320, 400, 24, 121)]


@pytest.mark.parametrize("h,w,n,ws", LK_WIDE)
def test_lk_kernel_wide_windows(cuda, h, w, n, ws):
    """K10 past winsize 15: ``lk_levels`` over 3 levels one launch on the
    route ``_k10_plan`` names, every level's flow, err, windows and Newton
    steps bit-equal to ``lk_levels_plain`` on the same pyramids, with
    either adopt rule; ``lucas_kanade`` one K10 and two K4 launches, equal
    to that launch."""
    lk, _, (i1, i2), _, scales, levels, kp = _lk_setup(cuda, h, w, n, ws, 3)
    pad = max(lk._search_pad(B, ws) for _, B, _ in levels)
    assert lk._k10_plan(ws, pad)[0] == ("global" if ws > 112 else "staged")
    kw = dict(winsize=ws, min_ev=1e-4, niterations=21,
              convergence_delta=0.1, factor=2.0, max_err=2.0)
    tr0 = torch.zeros_like(kp)
    for adopt in ("always", "below"):
        reset_launch_counts()
        got = lk.lk_levels(levels, scales, kp, tr0, adopt=adopt,
                           windows=True, **kw)
        assert launch_counts()["lk_level"] == 1
        want = lk.lk_levels_plain(levels, scales, kp, tr0, adopt=adopt,
                                  windows=True, **kw)
        for g, x in zip(got, want):
            assert torch.equal(g, x), adopt
        if adopt == "always":
            always = got
    reset_launch_counts()
    flow, dist = lk.lucas_kanade(i1, i2, kp, winsize=ws, nscales=3)
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts == {"lk_level": 1, "pyramid_decim": 2}
    assert torch.equal(flow, always[0]) and torch.equal(dist, always[1])


def test_lk_kernel_eighteen_levels(cuda):
    """``lucas_kanade`` at 18 scales on 96x128: K4 builds the 18 levels in
    one launch (they stop shrinking at 2x2; within 1e-6 relative of the
    plain chain), K10 runs two chained launches (the 2 coarsest levels,
    then 16, on the staged route: the 2x2 levels are smaller than their
    patches), every level bit-equal to the plain level loop, and the call
    equal to the chain."""
    lk, PY, (i1, i2), (pp, pn, pg), scales, levels, kp = _lk_setup(
        cuda, 96, 128, 37, 11, 18)
    assert pp[17].shape == (2, 2)
    for g, wl in zip(pp.levels, PY.pyramid_plain(
            i1.interior, PY.level_shapes((96, 128), 18), pp[0].border)):
        assert _level_close(g.data, wl.data, False)
    pads = [lk._search_pad(B, 11) for _, B, _ in levels]
    assert lk._k10_plan(11, max(pads), False)[0] == "staged"
    kw = dict(winsize=11, min_ev=1e-4, niterations=21,
              convergence_delta=0.1, adopt="always", factor=2.0)
    tr0 = torch.zeros_like(kp)
    reset_launch_counts()
    got = lk.lk_levels(levels, scales, kp, tr0, windows=True, **kw)
    assert launch_counts()["lk_level"] == 2
    want = lk.lk_levels_plain(levels, scales, kp, tr0, windows=True, **kw)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    reset_launch_counts()
    flow, dist = lk.lucas_kanade(i1, i2, kp, nscales=18)
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts == {"lk_level": 2, "pyramid_decim": 2}
    assert torch.equal(flow, got[0]) and torch.equal(dist, got[1])


def _guarded(cuda, held, guard=1 << 16, pattern=-0x5A5A5A5B):
    """A factory of buffers that lie between two guard zones of ``guard``
    int32 holding ``pattern``; ``held`` collects the backing buffers."""
    def make(n, dtype=torch.float32):
        buf = torch.full((2 * guard + n,), pattern, dtype=torch.int32,
                         device=cuda)
        held.append(buf)
        return buf[guard:guard + n].view(dtype)

    def hold():
        torch.cuda.synchronize()
        return all(bool((b[:guard] == pattern).all())
                   and bool((b[-guard:] == pattern).all()) for b in held)
    return make, hold


@pytest.mark.parametrize("ws,nscales,route", [(31, 3, "staged"),
                                              (121, 3, "global"),
                                              (11, 18, "staged"),
                                              (11, 18, "global")])
def test_lk_kernel_stays_in_its_buffers(cuda, ws, nscales, route):
    """K10's staged and global routes read and write only inside their
    buffers: every level buffer, p, tr0 and each output between guard
    zones; after each launch the card reports no fault, every guard holds,
    and the outputs equal the plain level loop's (at 18 levels, the 2x2
    levels' patches reach past their buffers, which reads 0 there)."""
    lk, _, _, _, scales, levels, kp = _lk_setup(
        cuda, 96 if ws < 100 else 320, 128 if ws < 100 else 400, 21, ws,
        nscales)
    held = []
    make, hold = _guarded(cuda, held)

    def copy(t):
        g = make(t.numel()).view(t.shape)
        g.copy_(t)
        return g

    glevels = [tuple(Image2d(data=copy(img.data.contiguous()),
                             border=img.border) for img in lvl)
               for lvl in levels]
    p = copy(kp)
    tr0 = copy(torch.zeros_like(kp))
    n, nw = kp.shape[0], ws * ws
    kw = dict(winsize=ws, min_ev=1e-4, niterations=21,
              convergence_delta=0.1, adopt="below", factor=2.0, max_err=2.0)
    want = lk.lk_levels_plain(levels, scales, kp, torch.zeros_like(kp),
                              windows=True, **kw)
    lo, hi = (0, len(levels)) if len(levels) <= 16 else (2, len(levels))
    rows, pads = [], []
    for (A, B, G), s in zip(glevels[lo:hi], scales[lo:hi]):
        _, row, pad, _ = lk._level_row(A, B, G, s, ws)
        rows += row
        pads.append(pad)
    if lo:                        # the chain's second launch
        tr0.copy_(lk.lk_levels_plain(levels[:lo], scales[:lo], kp,
                                     torch.zeros_like(kp), **kw)[0])
    nl = hi - lo
    tr, dist = make(2 * n).view(n, 2), make(n)
    per = (make(nl * n * 2).view(nl, n, 2), make(nl * n).view(nl, n),
           make(nl * n * 4 * nw).view(nl, n, 4, nw),
           make(nl * n, torch.int32).view(nl, n))
    plan = lk._k10_plan(ws, max(pads), False)
    if route == "global":
        plan = ("global", 4, 0)
    assert plan[0] == route
    lk._launch_k10(rows, nl, p, tr0, n, ws, 1e-4, 21, 0.1, "below", 2.0,
                   2.0, plan, tr, dist, per)
    assert hold()
    assert torch.equal(tr, want[0]) and torch.equal(dist, want[1])
    for g, x in zip(per, want[2:]):
        assert torch.equal(g, x[lo:hi])


def test_flow_level_kernel_global_route(cuda):
    """K1 at ws 151 on 40 px cells (no tile shape's regions fit 227 KB):
    launch A's global route, every buffer between guard zones; the volume,
    flow and dist bit-equal to the plain level on integer-valued buffers,
    and no guard touched."""
    hb, wb, b, ws, patch, R = 390, 470, 75, 151, 40, 5
    rng = np.random.RandomState(151)
    a1 = rng.randint(0, 256, (hb, wb)).astype(np.float32)
    a2 = (np.roll(a1, (2, -1), (0, 1))
          + rng.randint(0, 3, (hb, wb))).astype(np.float32)
    h, w = hb - 2 * b, wb - 2 * b
    g = flow.LevelGeometry(b=b, h=h, w=w, ws=ws, patch=patch, gh=h // patch,
                           gw=w // patch, R=R, pred_bound=8)
    pred = (rng.randint(-5, 6, (g.gh, g.gw, 2)) * 2).astype(np.int32)
    t1, t2, tp = (torch.from_numpy(x).to(cuda) for x in (a1, a2, pred))
    plan = flow._k1_plan(g, 2, flow._sm_count(cuda))
    assert plan.a_route == "global" and plan.a_smem == 0
    fp, dp, vp = _level_by_plain(t1, t2, tp, g, 2)
    held = []
    make, hold = _guarded(cuda, held)
    ga1, ga2 = make(hb * wb).view(hb, wb), make(hb * wb).view(hb, wb)
    ga1.copy_(t1)
    ga2.copy_(t2)
    gp = make(tp.numel(), torch.int32).view(tp.shape)
    gp.copy_(tp)
    reset_launch_counts()
    fk, dk = flow.flow_level(ga1, ga2, gp, g, 2)
    assert launch_counts()["flow_level"] == 2
    assert hold()
    assert torch.equal(fk, fp) and torch.equal(dk, dp)
    _, _, vk = flow.flow_match(ga1, ga2, gp, g)
    assert torch.equal(vk, vp)


def test_flow_propagate_table_in_device_memory(cuda):
    """Launch B with 38 passes at R 21: its tile and halo leave no room for
    the 1849-entry flat_to_k table, which it then reads in device memory;
    bit-equal to 38 plain passes."""
    R, iters, gh, gw = 21, 38, 20, 24
    assert flow._select_plan(flow._SELECT_TILE, iters, R)[1] == "global"
    rng = np.random.RandomState(38)
    d2 = (2 * R + 1) ** 2
    vol = torch.from_numpy(rng.randint(0, 1000, (d2, gh, gw)).astype(
        np.float32)).to(cuda)
    pred = torch.from_numpy((rng.randint(-3, 4, (gh, gw, 2)) * 2).astype(
        np.int32)).to(cuda)
    f0 = pred + torch.from_numpy(rng.randint(-R, R + 1, (gh, gw, 2)).astype(
        np.int32)).to(cuda)
    d0 = torch.from_numpy(rng.rand(gh, gw).astype(np.float32) * 2000).to(cuda)
    reset_launch_counts()
    fk, dk = flow.flow_propagate(f0, d0, pred, vol, R, iters=iters)
    assert launch_counts()["flow_level"] == 1
    fp, dp = f0, d0
    for _ in range(iters):
        fp, dp = flow.flow_propagate_plain(fp, dp, pred, vol, R)
    assert torch.equal(fk, fp) and torch.equal(dk, dp)


def test_flow_select_chain_past_its_halo(cuda):
    """Launch B past the passes whose halo fits a block (38 at the 8-cell
    tile): 48 passes are a chain of two launches (38, then 10 from the
    first one's flow and dist), bit-equal to 48 plain passes; a level at
    ``prop_iters`` 48 is launch A and that chain, bit-equal to the plain
    level."""
    R, iters, gh, gw = 5, 48, 20, 24
    assert flow._select_links(flow._SELECT_TILE, iters) == (38, 10)
    rng = np.random.RandomState(48)
    d2 = (2 * R + 1) ** 2
    vol = torch.from_numpy(rng.randint(0, 1000, (d2, gh, gw)).astype(
        np.float32)).to(cuda)
    pred = torch.from_numpy((rng.randint(-2, 3, (gh, gw, 2)) * 2).astype(
        np.int32)).to(cuda)
    f0 = pred + torch.from_numpy(rng.randint(-R, R + 1, (gh, gw, 2)).astype(
        np.int32)).to(cuda)
    d0 = torch.from_numpy(rng.rand(gh, gw).astype(np.float32) * 2000).to(cuda)
    reset_launch_counts()
    fk, dk = flow.flow_propagate(f0, d0, pred, vol, R, iters=iters)
    assert launch_counts()["flow_level"] == 2
    fp, dp = f0, d0
    for _ in range(iters):
        fp, dp = flow.flow_propagate_plain(fp, dp, pred, vol, R)
    assert torch.equal(fk, fp) and torch.equal(dk, dp)
    hb, wb, b = 96, 128, 9
    g = flow.LevelGeometry(b=b, h=hb - 2 * b, w=wb - 2 * b, ws=9, patch=6,
                           gh=(hb - 2 * b) // 6, gw=(wb - 2 * b) // 6, R=3,
                           pred_bound=0)
    a1 = torch.from_numpy(rng.randint(0, 256, (hb, wb)).astype(
        np.float32)).to(cuda)
    a2 = torch.roll(a1, (1, -2), (0, 1)).contiguous()
    pz = torch.zeros((g.gh, g.gw, 2), dtype=torch.int32, device=cuda)
    reset_launch_counts()
    fk, dk = flow.flow_level(a1, a2, pz, g, iters)
    assert launch_counts()["flow_level"] == 3
    fp, dp, _ = _level_by_plain(a1, a2, pz, g, iters)
    assert torch.equal(fk, fp) and torch.equal(dk, dp)


@pytest.mark.parametrize("linalg", ["chol", "lu"])
def test_ring_of_48_runs_k9(cuda, linalg):
    """A ring problem of 48 poses (``SlamConfig(ring=48)``'s window, past
    K9's old 32 slots a landmark): one K9 launch with ``obs_pose =
    arange(M)`` and no K6 launch, the generic route's bits, held to its
    plain version as ``_check_generic`` holds K9 (the ring's obs_pose is
    that arange already)."""
    from vpp_tpu_torch.slam import ba
    p = _ring_problem(cuda, 600, 48, 48)
    reset_launch_counts()
    sr, cr = ba.ba_solve_tracks(p, iters=3, lam0=1e-4, ring_layout=True,
                                linalg=linalg)
    assert launch_counts()["ba_generic"] == 1
    assert launch_counts()["ba_tracks"] == 0
    sg, cg = ba.ba_solve_tracks(p, iters=3, lam0=1e-4, linalg=linalg)
    assert _same_bits(sr.poses, sg.poses) and _same_bits(cr, cg)
    _, _, costs, _ = _check_generic(p, 3, 1e-4, linalg)
    assert _same_bits(costs, cr)


@pytest.mark.parametrize("linalg", ["chol", "lu"])
def test_ring_of_twenty_streams_one_k9_launch_a_stream(cuda, linalg):
    """``ba_solve_tracks(ring_layout=True)`` on S = 3 rings of M = 20 poses
    (more than K6 holds): three K9 launches, one a stream in stream order,
    and no K6 launch; each stream's poses, landmarks and costs bit-equal to
    a single-problem call on that stream."""
    from vpp_tpu_torch.slam import ba
    probs = [_ring_problem(cuda, 400, 20, seed) for seed in (1, 2, 3)]
    batched = ba.BATracks(*(probs[0][i] if i == 5 else torch.stack(
        [p[i] for p in probs]) for i in range(7)))
    reset_launch_counts()
    got, costs = ba.ba_solve_tracks(batched, iters=3, lam0=1e-4,
                                    ring_layout=True, linalg=linalg)
    assert launch_counts()["ba_generic"] == 3
    assert launch_counts()["ba_tracks"] == 0
    assert costs.shape == (3, 3)
    for i, p in enumerate(probs):
        one, c1 = ba.ba_solve_tracks(p, iters=3, lam0=1e-4,
                                     ring_layout=True, linalg=linalg)
        assert _same_bits(got.poses[i], one.poses), i
        assert _same_bits(got.landmarks[i], one.landmarks), i
        assert _same_bits(costs[i], c1), i
