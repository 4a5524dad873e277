"""The CUDA kernels against their plain versions, on a card.

These tests need a CUDA card and skip without one. They import neither JAX
nor vpp_tpu, so they also run on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

Tolerances are chip_smoke.py's: K2 bit-equal; K1 flow equal wherever the
best and second-best SAD differ by more than 1e-5 relative, dist and
volume within rtol 1e-5, the whole level bit-equal on integer-valued
buffers, propagation exactly equal on equal inputs; K7 bit-reproducible
and within 1e-4 * max of the float32 scatter.
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


@pytest.mark.parametrize("shape,border", [((96, 128), 9), ((37, 53), 3)])
def test_fast9_kernel_bit_equal(cuda, shape, border):
    frame = make_clip(shape[1], shape[0], 1, seed=shape[0])[0]
    img = from_array(torch.from_numpy(frame).to(cuda), border=border,
                     border_mode="mirror")
    for th in (5, 10, 20):
        sk, dk = fast.fast9_cuda(img, th)
        sp, dp = fast.fast9_plain(img, th)
        assert torch.equal(sk, sp) and torch.equal(dk, dp)


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
