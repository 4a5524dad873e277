"""The CUDA kernels against their plain versions, on a card.

These tests need a CUDA card and skip without one. They import neither JAX
nor vpp_tpu, so they also run on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

Tolerances are chip_smoke.py's: K2 bit-equal; K1 flow equal wherever the
best and second-best SAD differ by more than 1e-5 relative, dist within
rtol 1e-5 there, propagation exactly equal on equal inputs; K7
bit-reproducible and within 1e-4 * max of the float32 scatter.
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


@pytest.mark.parametrize("R,pred_bound,extra", [(1, 10, 0), (5, 0, 0),
                                                (1, 22, 1), (3, 6, 1)])
def test_flow_level_kernel_matches_plain(cuda, R, pred_bound, extra):
    rng = np.random.RandomState(R + pred_bound)
    hb, wb, b = 71, 93, 9
    h, w = hb - 2 * b, wb - 2 * b
    gh, gw = h // 5 + extra, w // 5 + extra
    a1 = (rng.rand(hb, wb) * 255).astype(np.float32)
    a2 = (np.roll(a1, (1, 2), (0, 1)) + rng.rand(hb, wb) * 3).astype(
        np.float32)
    pred = np.zeros((gh, gw, 2), np.int32)
    if pred_bound:
        pred = (rng.randint(-pred_bound // 2 - 1, pred_bound // 2 + 2,
                            (gh, gw, 2)) * 2).astype(np.int32)
    g = flow.LevelGeometry(b=b, h=h, w=w, ws=9, patch=5, gh=gh, gw=gw, R=R,
                           pred_bound=pred_bound)
    t1, t2, tp = (torch.from_numpy(x).to(cuda) for x in (a1, a2, pred))
    fk, dk, vk = flow.flow_match(t1, t2, tp, g)
    fp, dp, vp = flow.flow_match_plain(t1, t2, tp, g)
    two = torch.topk(vp, 2, dim=0, largest=False).values
    clear = (two[1] - two[0]) > 1e-5 * two[0].abs().clamp(min=1e-30)
    assert bool(((fk == fp).all(-1) | ~clear).all())
    assert torch.allclose(dk[clear], dp[clear], rtol=1e-5, atol=0)
    assert torch.allclose(vk, vp, rtol=1e-5, atol=0)
    for _ in range(2):
        fpk, dpk = flow.flow_propagate(fp, dp, tp, vp, R)
        fpp, dpp = flow.flow_propagate_plain(fp, dp, tp, vp, R)
        assert torch.equal(fpk, fpp) and torch.equal(dpk, dpp)
        fp, dp = fpp, dpp


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
