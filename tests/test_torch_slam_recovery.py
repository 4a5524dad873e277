"""Parity of the port's full SLAM engine (recovery, loop closure, the
pose-graph smoother, ``relocalize``, sub-pixel observations) with vpp_tpu's
on the CPU, on tests/test_pipeline.py's 120x160 scene and config (the JAX
defaults: ``enable_recovery=True``).

* ``slam_run`` at the defaults, and with ``subpix_refine=True``: the same
  ``n_keyframes``, ``lc_ptr`` and lost keyframes (the down-weighted
  odometry edges), ``hist_pose`` atol 1e-3, ``lm_valid`` equal.
* ``_archive_pnp`` (recovery and revisit PnP) and ``_map_vote_pnp``
  against the live map, from one state carried across by ``convert``:
  T atol 1e-4, ``n`` equal, err atol 1e-3; from the same state, kernel
  K8's plain version ``_map_vote_pnp_plain`` with both archive sets at
  once (B = 2) against the JAX call per set, and with no usable entry, no
  valid detection, three valid detections and a NaN map entry, at the same
  tolerances.
* ``relocalize`` at frame 24, from the JAX run's state carried across: the
  same tolerances; and on the port's own run, tests/test_pipeline.py:71's
  gates (``n >= lc_min_inliers``, err < 2.5, centre error < 0.1).
* ``_do_keyframe`` at a loop-closure keyframe of
  tests/test_pose_graph_loop.py:59's scenario, from the port's state
  carried across: a new closure (the ring write and the full double
  smoother solve) and, with closures gated off, the 2-iteration refresh;
  ``lc_ptr`` and ``lc_j`` equal, ``lc_w``, ``lc_T`` and ``hist_pose`` atol
  1e-4.
* ``SlamConfig(intrinsics=...)`` alone runs on the CPU.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpp_tpu.algorithms.video_extruder import (
    VideoExtruderConfig as JVConfig)
from vpp_tpu.core.image import from_array as j_from_array
from vpp_tpu_torch import convert
from vpp_tpu_torch.algorithms.fast import fast9
from vpp_tpu_torch.algorithms.video_extruder import (
    VideoExtruderConfig as TVConfig)
from vpp_tpu_torch.core.image import from_array as t_from_array
from vpp_tpu_torch.slam import map_vote as tmv
from vpp_tpu_torch.utils import synth as tsynth

from test_torch_pose_graph import _loop_cfg, _out_and_back
from test_torch_slam_pipeline import _jax_mapping, _jax_state

jp = importlib.import_module("vpp_tpu.slam.pipeline")
tp = importlib.import_module("vpp_tpu_torch.slam.pipeline")

torch.set_num_threads(1)

H, W = 120, 160
INTR = (160.0, 160.0, 80.0, 60.0)
TRACKER = dict(capacity=256, detect_k=128, nscales=3, winsize=9,
               keypoint_spacing=8, detector_period=1, detector_th=8)
BACK = dict(intrinsics=INTR, keyframe_period=4, ring=6, ba_iters=3,
            min_parallax=2.0, max_reproj=2.0, history=16)
B = max(3, TRACKER["winsize"])


def _scene(n_frames=25):
    """tests/test_pipeline.py:23, rendered by the port's copy of synth."""
    pts = tsynth.make_cloud(220, seed=0, extent=(6.0, 4.0, 3.0),
                            center=(0.8, 0.0, 5.0))
    poses = tsynth.camera_path(n_frames, step=(0.06, 0.0, 0.0))
    return poses, tsynth.render_frames(pts, poses, INTR, (H, W), seed=0)


def _cfgs(**kw):
    return (jp.SlamConfig(tracker=JVConfig(**TRACKER), **BACK, **kw),
            tp.SlamConfig(tracker=TVConfig(**TRACKER), **BACK, **kw))


def _both_runs(**kw):
    poses, frames = _scene()
    jcfg, tcfg = _cfgs(**kw)
    boot = poses[[0, 4]]
    js = jax.jit(lambda f, b: jp.slam_run(f, jcfg, bootstrap_poses=b))(
        jnp.asarray(frames), jnp.asarray(boot))
    ts = tp.slam_run(frames, tcfg, bootstrap_poses=boot, device="cpu")
    return poses, frames, js, ts


@pytest.fixture(scope="module")
def runs():
    return _both_runs()


def _check_runs(js, ts):
    assert ts.n_keyframes == int(js.n_keyframes) == 7
    assert int(ts.lc_ptr) == int(js.lc_ptr)
    np.testing.assert_array_equal(ts.pg_w.numpy(), np.asarray(js.pg_w))
    np.testing.assert_array_equal(ts.hist_frame.numpy(),
                                  np.asarray(js.hist_frame))
    np.testing.assert_allclose(ts.hist_pose.numpy(), np.asarray(js.hist_pose),
                               atol=1e-3)
    np.testing.assert_array_equal(ts.lm_valid.numpy(),
                                  np.asarray(js.lm_valid))
    np.testing.assert_array_equal(ts.lc_w.numpy() > 0,
                                  np.asarray(js.lc_w) > 0)


def test_slam_run_with_recovery_matches(runs):
    poses, _, js, ts = runs
    assert tp.SlamConfig(intrinsics=INTR).enable_recovery
    _check_runs(js, ts)
    te, tf = tp.keyframe_trajectory(ts)
    assert float(tp.ate_rmse(te, torch.from_numpy(poses[tf.numpy()]))) < 0.065


def test_slam_run_subpix_refine_matches():
    _, _, js, ts = _both_runs(subpix_refine=True)
    _check_runs(js, ts)


def _carried(runs, n_frames):
    """The JAX state after ``n_frames`` frames, as both packages' states."""
    poses, frames, _, _ = runs
    jcfg, _ = _cfgs()
    js = jax.jit(lambda f, b: jp.slam_run(f, jcfg, bootstrap_poses=b))(
        jnp.asarray(frames[:n_frames]), jnp.asarray(poses[[0, 4]]))
    m = _jax_mapping(js)
    return js, convert.slam_state_from_numpy(m, device="cpu")


def _frame(frames, k):
    return (j_from_array(jnp.asarray(frames[k]), border=B,
                         border_mode="mirror"),
            t_from_array(torch.from_numpy(frames[k]), border=B,
                         border_mode="mirror"))


def _same_pnp(j, t):
    (jT, jerr, jn), (tT, terr, tn) = j, t
    assert int(tn) == int(jn)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-4)
    np.testing.assert_allclose(float(terr), float(jerr), atol=1e-3)


def test_archive_and_map_vote_pnp_from_one_state(runs):
    """Keyframe 5's state (frame 20) crosses from JAX; the frame's archive
    PnP (full and revisit sets) and a map-vote PnP against the live map
    run on both."""
    _, frames, _, _ = runs
    js, ts = _carried(runs, 21)
    jcfg, tcfg = _cfgs()
    jf, tf = _frame(frames, 20)
    jintr = jnp.asarray(INTR, jnp.float32)
    tintr = torch.tensor(INTR)
    T0 = js.kf_pose[(int(js.n_keyframes) - 1) % jcfg.ring]
    tT0 = ts.kf_pose[(ts.n_keyframes - 1) % tcfg.ring]
    jrec, jlc = jax.jit(lambda s, f: jp._archive_pnp(
        s, f, jcfg, T0, jintr, jcfg.lc_min_gap))(js, jf)
    trec, tlc = tp._archive_pnp(ts, tf, tcfg, tT0, tintr, tcfg.lc_min_gap)
    assert int(trec[2]) >= 10 and int(tlc[2]) > 0
    _same_pnp(jrec, trec)
    _same_pnp(jlc, tlc)
    pos, _, valid = fast9(tf, 10, k=128, blockwise=True, block_size=8)
    jmap = jax.jit(lambda s, f, p, v: jp._map_vote_pnp(
        s.lm_X, s.lm_desc, s.lm_valid, p, v, f, jcfg, T0, jintr))(
        js, jf, jnp.asarray(pos.numpy()), jnp.asarray(valid.numpy()))
    tmap = tp._map_vote_pnp(ts.lm_X, ts.lm_desc, ts.lm_valid, pos, valid,
                            tf, tcfg, tT0, tintr)
    assert int(tmap[2]) >= 10
    _same_pnp(jmap, tmap)


@pytest.fixture(scope="module")
def pnp_state(runs):
    """Keyframe 5's state (frame 20) carried from JAX, the frame's
    detections and shifted patches (the port's, handed to both), the prior
    pose, and the JAX ``_map_vote_pnp`` jitted once for these shapes."""
    _, frames, _, _ = runs
    js, ts = _carried(runs, 21)
    jcfg, tcfg = _cfgs()
    _, tf = _frame(frames, 20)
    pos, _, valid = fast9(tf, tcfg.tracker.detector_th,
                          k=tcfg.tracker.detect_k, blockwise=True,
                          block_size=tcfg.tracker.keypoint_spacing)
    det = tp._det_shift_patches(tf, pos, tcfg.desc_patch)
    jintr = jnp.asarray(INTR, jnp.float32)
    jfn = jax.jit(lambda X, D, base, p, v, d, T0: jp._map_vote_pnp(
        X, D, base, p, v, None, jcfg, T0, jintr, det_patches=d))
    col = (ts.n_keyframes - 1) % tcfg.ring

    def jax_pnp(X, base, v):
        return jfn(*(jnp.asarray(t.numpy()) for t in (
            X, ts.arch_desc, base, pos, v, det, ts.kf_pose[col])))

    return dict(ts=ts, cfg=tcfg, pos=pos, valid=valid, det=det,
                T0=ts.kf_pose[col], jax_pnp=jax_pnp)


def _plain_pnp(st, X, base, valid):
    return tmv._map_vote_pnp_plain(
        X, st["ts"].arch_desc, base, st["pos"], valid, st["det"], st["T0"],
        torch.tensor(INTR), **tp._vote_args(st["cfg"]))


def test_map_vote_pnp_plain_two_sets_match_jax(pnp_state):
    """K8's plain version on the archive's two match sets at once (B = 2)
    against the JAX ``_map_vote_pnp`` run once per set."""
    st = pnp_state
    ts, cfg = st["ts"], st["cfg"]
    filled = ts.arch_frame >= 0
    old = filled & (ts.arch_frame <= ts.tracker.frame_id - cfg.lc_min_gap)
    out = _plain_pnp(st, ts.arch_X, torch.stack([filled, old]), st["valid"])
    assert int(out.n[0]) >= 10 and int(out.n[1]) > 0
    for i, base in enumerate((filled, old)):
        _same_pnp(st["jax_pnp"](ts.arch_X, base, st["valid"]),
                  (out.T[i], out.err[i], out.n[i]))
        j1 = out.j1[i][out.inl[i]].long()
        assert int(out.n[i]) == len(set(j1.tolist()))
        assert bool((out.inl[i] <= base).all())
    assert out.txy.shape == (2, 2, 2) and bool((out.txy[0] != 0).any())


@pytest.mark.parametrize("case", ["empty_base", "no_valid", "three_valid",
                                  "nan_row"])
def test_map_vote_pnp_plain_edge_cases_match_jax(pnp_state, case):
    """No usable entry, no valid detection, three valid detections (every
    row short of candidates), a NaN map entry (its row picks the first
    valid detections; its zero-weighted NaN poisons the normal equations,
    as in the JAX body): the same (T, err, n) as JAX."""
    st = pnp_state
    ts = st["ts"]
    X, base, valid = ts.arch_X.clone(), ts.arch_frame >= 0, st["valid"]
    first = int(torch.nonzero(base)[0, 0])
    if case == "empty_base":
        base = torch.zeros_like(base)
    elif case == "no_valid":
        valid = torch.zeros_like(valid)
    elif case == "three_valid":
        keep = torch.nonzero(valid)[:3, 0]
        valid = torch.zeros_like(valid)
        valid[keep] = True
    else:
        X[first] = float("nan")
    out = _plain_pnp(st, X, base[None], valid)
    T, err, n = out.T[0], out.err[0], out.n[0]
    _same_pnp(st["jax_pnp"](X, base, valid), (T, err, n))
    if case in ("empty_base", "no_valid"):
        assert torch.equal(T, st["T0"]) and float(err) == 0.0
        assert int(n) == 0 and not bool(out.inl.any())
        assert bool((out.txy == 0).all())
    elif case == "three_valid":
        assert 0 < int(n) <= 3
        assert set(out.j1[0].tolist()) <= set(keep.tolist())
    else:
        assert bool(torch.isnan(T).all()) and bool(torch.isnan(err))
        assert int(out.j1[0, first]) == int(torch.nonzero(valid)[0, 0])


def test_relocalize_matches(runs):
    poses, frames, js, ts = runs
    jcfg, tcfg = _cfgs()
    jf, tf = _frame(frames, 24)
    jout = jax.jit(lambda s, f: jp.relocalize(s, f, jcfg))(js, jf)
    carried = convert.slam_state_from_numpy(_jax_mapping(js), device="cpu")
    _same_pnp(jout, tp.relocalize(carried, tf, tcfg))
    # tests/test_pipeline.py:71's gates on the port's own run
    T, err, n = tp.relocalize(ts, tf, tcfg)
    assert float(err) < 2.5, float(err)
    assert int(n) >= tcfg.lc_min_inliers, int(n)
    c_est = -T[:3, :3].T.numpy() @ T[:3, 3].numpy()
    c_gt = -poses[24][:3, :3].T @ poses[24][:3, 3]
    assert np.linalg.norm(c_est - c_gt) < 0.1, (c_est, c_gt)


def test_default_config_runs():
    _, frames = _scene(n_frames=9)
    st = tp.slam_run(frames, tp.SlamConfig(intrinsics=INTR), device="cpu")
    assert st.n_keyframes == 3 and int(st.lc_ptr) == 0
    assert bool(torch.isfinite(st.hist_pose).all())


@pytest.fixture(scope="module")
def loop_keyframe():
    """The port's state and frame just before the fourth keyframe that
    accepts a closure in the out-and-back loop with a drift spike (frame
    28: three closures stored, a new one accepted; there the smoother
    moves the history by ~0.1–0.2, where the first closures agree with the
    odometry and move it by ~1e-7)."""
    pts = tsynth.make_cloud(220, seed=0, extent=(6.0, 4.0, 3.0),
                            center=(0.4, 0.0, 5.0))
    xs = list(np.arange(20) * 0.06)
    poses = _out_and_back(xs + list(xs[-1] - np.arange(1, 21) * 0.06))
    frames = tsynth.render_frames(pts, poses, INTR, (H, W), seed=0,
                                  sigma=(1.0, 1.8)).copy()
    frames[10:13] = 0.0
    cfg = _loop_cfg(history=24, lc_max_err=4.5, lc_min_gap=8)
    kept, do_kf = [], tp._do_keyframe

    def keep(state, frame2, cfg_, **kw):
        out = do_kf(state, frame2, cfg_, **kw)
        if int(out.lc_ptr) > int(state.lc_ptr):
            kept.append((state, frame2))
        return out

    tp._do_keyframe = keep
    try:
        tp.slam_run(frames[:29], cfg, bootstrap_poses=poses[[0, 4]],
                    device="cpu")
    finally:
        tp._do_keyframe = do_kf
    assert len(kept) == 4
    state, frame = kept[3]
    assert int(state.lc_ptr) == 3
    return state, frame, frames[state.tracker.frame_id], cfg


@pytest.mark.parametrize("branch", ["full", "refresh"])
def test_loop_closure_keyframe_matches(loop_keyframe, branch, monkeypatch):
    state, tframe, raw, cfg = loop_keyframe
    if branch == "refresh":      # no new closure: the refresh branch
        cfg = dataclasses.replace(cfg, lc_min_inliers=10 ** 6)
    jcfg = jp.SlamConfig(tracker=JVConfig(**dataclasses.asdict(cfg.tracker)),
                         **{k: v for k, v in dataclasses.asdict(cfg).items()
                            if k != "tracker"})
    m = convert.slam_state_to_numpy(state)
    js = jax.jit(lambda s, f: jp._do_keyframe(
        s, j_from_array(f, border=B, border_mode="mirror"), jcfg))(
        _jax_state(m), jnp.asarray(raw))
    ts = tp._do_keyframe(convert.slam_state_from_numpy(m, device="cpu"),
                         tframe, cfg)
    assert int(ts.lc_ptr) == int(js.lc_ptr) == (4 if branch == "full" else 3)
    np.testing.assert_array_equal(ts.lc_j.numpy(), np.asarray(js.lc_j))
    for name in ("lc_w", "lc_T", "hist_pose", "kf_pose"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=1e-4,
                                   err_msg=name)
    # the smoother ran: without it the history ends elsewhere
    monkeypatch.setattr(tp, "_smooth_history", lambda h, *a, **k: h)
    raw_hist = tp._do_keyframe(convert.slam_state_from_numpy(
        m, device="cpu"), tframe, cfg).hist_pose
    moved = float((ts.hist_pose - raw_hist).abs().max())
    assert moved > 0.05, moved
