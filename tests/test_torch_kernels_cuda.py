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


# -- K3 block top-K, K4 pyramid decimation, K5 patches, K6 window BA --------
#
# K3 and K5 are bit-equal to their plain versions; K4 is bit-equal on
# integer-valued frames (every partial sum is exact) and within 1e-6
# relative on float frames; K6's S and cost are within 1e-4 of the plain
# assembly relative to their largest magnitude, rhs within 1e-4 of the
# magnitude of its terms (``ba.rhs_term_scale``), two launches give
# the same bits, and its LM solve lands within 1e-4 (poses) and 1e-3
# (landmarks) of the plain LM loop on the same problem.


def _score_image(device, h, w, seed, zero_frac=0.6):
    rng = np.random.RandomState(seed)
    s = rng.randint(1, 256, (h, w)) * (rng.rand(h, w) > zero_frac)
    return from_array(torch.from_numpy(s.astype(np.uint8)).to(device),
                      border=1)


@pytest.mark.parametrize("h,w,bs,k", [(480, 640, 10, 512), (37, 53, 7, 64),
                                      (128, 256, 1, 1000),
                                      (30, 40, 10, 100)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_block_topk_kernel_bit_equal(cuda, h, w, bs, k, dtype):
    """(128, 256, 1): nb = 32768, the most K3 takes; (30, 40, 10):
    k > nb, padded."""
    img = _score_image(cuda, h, w, h + bs)
    img = from_array(img.interior.to(dtype), border=1)
    got = fast._blockwise_keypoints(img, bs, k)
    want = fast._blockwise_keypoints_plain(img, bs, k)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        fast._blockwise_keypoints(_score_image(cuda, 129, 256, 0), 1, 8)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8, torch.int32,
                                   torch.float64, torch.int16])
@pytest.mark.parametrize("channels", [0, 3])
def test_patches_kernel_bit_equal(cuda, dtype, channels):
    from vpp_tpu_torch.core import interp
    rng = np.random.RandomState(channels)
    shape = (498, 658) + ((channels,) if channels else ())
    data = torch.from_numpy(rng.rand(*shape) * 255).to(dtype).to(cuda)
    ctr = torch.from_numpy(rng.randint(-5, 670, (1024, 2))).to(cuda)
    for size in (7, 9):
        got = interp.extract_patches(data, ctr, size)
        want = interp.extract_patches_at_tl_plain(
            data, interp._clamp_tl(ctr - size // 2, 498, 658, size), size)
        assert got.shape == want.shape and torch.equal(got, want)


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


@pytest.mark.parametrize("n,m", [(1024, 6), (1000, 16), (37, 3)])
@pytest.mark.parametrize("linalg", ["chol", "lu"])
def test_ba_tracks_kernel_matches_plain(cuda, n, m, linalg):
    from vpp_tpu_torch.slam import ba, ba_cuda
    p = _ring_problem(cuda, n, m, n + m)
    lam = torch.full((), 1e-4, device=cuda)
    (S, rhs, cost), loc = ba_cuda.tracks_assemble(p, lam, 4.0, linalg)
    (S2, rhs2, cost2), loc2 = ba_cuda.tracks_assemble(p, lam, 4.0, linalg)
    (Sp, rhsp, costp), locp = ba._tracks_assemble(p, lam, 4.0, True, linalg)
    assert torch.equal(S, S2) and torch.equal(rhs, rhs2)
    assert torch.equal(cost, cost2)
    assert _rel(S, Sp) <= 1e-4 and _rel(cost, costp) <= 1e-4
    assert float((rhs - rhsp).abs().max()) <= 1e-4 * ba.rhs_term_scale(
        p, 4.0, True)
    for a, b in zip((loc[0], loc[1], loc[2]), (locp[0], locp[1], locp[2])):
        assert _rel(a, b) <= 1e-4
    assert torch.equal(loc[4], locp[4])
    dp = ba._tracks_solve_poses(Sp, rhsp, p.fixed_poses, lam, linalg)
    cand = ba.apply_pose_step(p.poses, dp, p.fixed_poses)
    lms_k, c_k = ba_cuda.tracks_backsub_cost(p, locp, dp, cand, 4.0)
    lms_p = p.landmarks + ba._tracks_backsub(locp, dp)
    c_p = ba._tracks_cost(p._replace(poses=cand, landmarks=lms_p), 4.0, True)
    assert _rel(lms_k, lms_p) <= 1e-5 and _rel(c_k, c_p) <= 1e-4
    reset_launch_counts()
    sk, ck = ba.ba_solve_tracks(p, iters=3, huber=4.0, lam0=1e-4,
                                ring_layout=True, linalg=linalg)
    assert launch_counts()["ba_tracks"] == 12
    sp, cp = ba._lm_tracks(p, 3, 4.0, 1e-4, True, linalg, kernel=False)
    assert float((sk.poses - sp.poses).abs().max()) <= 1e-4
    assert float((sk.landmarks - sp.landmarks).abs().max()) <= 1e-3
    assert _rel(ck, cp) <= 1e-4
    with pytest.raises(NotImplementedError):
        ba.ba_solve_tracks(p, iters=1, ring_layout=False)


def test_ba_tracks_kernel_rejects_large_windows(cuda):
    from vpp_tpu_torch.slam import ba_cuda
    p = _ring_problem(cuda, 64, 17, 0)
    with pytest.raises(ValueError):
        ba_cuda.tracks_assemble(p, torch.ones((), device=cuda), 4.0, "chol")


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
