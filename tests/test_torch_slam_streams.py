"""The port's ``slam_run_streams`` (S clips at once) on the CPU, on
tests/test_pipeline.py's 120x160 scene and streams config (seeds 0 and 1,
T cut to 16 frames):

* against the JAX ``slam_run_streams``: per stream the tracker
  (``keypoints.alive``, ``position``) bit-equal, ``n_keyframes`` equal,
  ``hist_pose[:n]`` within 0.05 and ATE < 0.08, the JAX test's own bounds;
* against the port's ``slam_run`` on each clip: the tracker bit-equal, the
  keyframe history within 1e-3 (batched and unbatched linear algebra may
  round differently);
* each kernel's plain version at S = 3 (K1-K6, the window BA on the ring
  layout) bit-equal to three unbatched calls;
* the guards (``enable_recovery=True``, ``T % keyframe_period != 0``);
* ``convert`` carrying a JAX streams state across: 8 frames on JAX, 8
  more on both from that state, held to the bounds above, and the state
  back to the JAX layout.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpp_tpu.algorithms.video_extruder import (
    VideoExtruderConfig as JVConfig, VideoExtruderState as JVState)
from vpp_tpu.core.image import from_array as j_from_array
from vpp_tpu.core.keypoints import Keypoints as JKeypoints
from vpp_tpu_torch import convert
from vpp_tpu_torch.algorithms import fast, flow
from vpp_tpu_torch.algorithms.video_extruder import (
    VideoExtruderConfig as TVConfig)
from vpp_tpu_torch.core import interp
from vpp_tpu_torch.slam import ba
from vpp_tpu_torch.utils import synth as tsynth

jp = importlib.import_module("vpp_tpu.slam.pipeline")
tp = importlib.import_module("vpp_tpu_torch.slam.pipeline")
pyramid = importlib.import_module("vpp_tpu_torch.algorithms.pyramid")

torch.set_num_threads(1)

H, W = 120, 160
INTR = (160.0, 160.0, 80.0, 60.0)
T = 16
TRACKER = dict(capacity=256, detect_k=128, nscales=3, winsize=9,
               keypoint_spacing=8, detector_period=1, detector_th=8)
BACK = dict(intrinsics=INTR, keyframe_period=4, ring=6, ba_iters=3,
            min_parallax=2.0, max_reproj=2.0, history=16,
            enable_recovery=False)
B = 9


def _cfgs():
    return (jp.SlamConfig(tracker=JVConfig(**TRACKER), **BACK),
            tp.SlamConfig(tracker=TVConfig(**TRACKER), **BACK))


def _scene(seed):
    """tests/test_pipeline.py:23, rendered by the port's copy of synth."""
    pts = tsynth.make_cloud(220, seed=seed, extent=(6.0, 4.0, 3.0),
                            center=(0.8, 0.0, 5.0))
    poses = tsynth.camera_path(24, step=(0.06, 0.0, 0.0))
    frames = tsynth.render_frames(pts, poses, INTR, (H, W), seed=seed)
    return poses, frames


@pytest.fixture(scope="module")
def clips():
    scenes = [_scene(s) for s in range(2)]
    frames = np.stack([f[:T] for _, f in scenes])
    boot = np.stack([p[[0, 4]] for p, _ in scenes])
    return frames, boot, [p for p, _ in scenes]


@pytest.fixture(scope="module")
def runs(clips):
    frames, boot, _ = clips
    jcfg, tcfg = _cfgs()
    js = jax.jit(lambda f, b: jp.slam_run_streams(f, jcfg, b))(
        jnp.asarray(frames), jnp.asarray(boot))
    ts = tp.slam_run_streams(frames, tcfg, boot, device="cpu")
    return js, ts


def _ate(est, gt):
    def centres(T_):
        return -(np.swapaxes(T_[:, :3, :3], 1, 2) @ T_[:, :3, 3:])[..., 0]
    d = centres(est) - centres(gt)
    return float(np.sqrt((d * d).sum(1).mean()))


def test_streams_match_jax(clips, runs):
    _, _, gts = clips
    js, ts = runs
    assert ts.n_keyframes == T // 4 and isinstance(ts.n_keyframes, int)
    assert ts.tracker.frame_id == T - 1
    for s in range(2):
        np.testing.assert_array_equal(
            ts.tracker.keypoints.alive[s].numpy(),
            np.asarray(js.tracker.keypoints.alive[s]))
        np.testing.assert_array_equal(
            ts.tracker.keypoints.position[s].numpy(),
            np.asarray(js.tracker.keypoints.position[s]))
        n = int(js.n_keyframes[s])
        assert n == ts.n_keyframes
        np.testing.assert_array_equal(ts.hist_frame[s, :n].numpy(),
                                      np.asarray(js.hist_frame[s, :n]))
        np.testing.assert_allclose(ts.hist_pose[s, :n].numpy(),
                                   np.asarray(js.hist_pose[s, :n]),
                                   atol=0.05)
        gt = gts[s][ts.hist_frame[s, :n].numpy()]
        assert _ate(ts.hist_pose[s, :n].numpy(), gt) < 0.08


def test_streams_match_slam_run_per_stream(clips, runs):
    frames, boot, _ = clips
    _, tcfg = _cfgs()
    _, ts = runs
    for s in range(2):
        one = tp.slam_run(frames[s], tcfg, bootstrap_poses=boot[s],
                          device="cpu")
        assert torch.equal(one.tracker.keypoints.alive,
                           ts.tracker.keypoints.alive[s])
        assert torch.equal(one.tracker.keypoints.position,
                           ts.tracker.keypoints.position[s])
        assert one.n_keyframes == ts.n_keyframes
        np.testing.assert_allclose(one.hist_pose.numpy(),
                                   ts.hist_pose[s].numpy(), atol=1e-3)
        assert torch.equal(one.hist_frame, ts.hist_frame[s])


def test_streams_ring_of_twenty_match_jax(clips):
    """``ring = 20`` (a BA window of more poses than K6 holds; on the card
    one K9 launch a stream) at S = 2 on this file's clips, against the JAX
    ``slam_run_streams`` with ``test_streams_match_jax``'s bounds."""
    frames, boot, gts = clips
    jcfg, tcfg = (dataclasses.replace(c, ring=20) for c in _cfgs())
    js = jax.jit(lambda f, b: jp.slam_run_streams(f, jcfg, b))(
        jnp.asarray(frames), jnp.asarray(boot))
    ts = tp.slam_run_streams(frames, tcfg, boot, device="cpu")
    assert tuple(ts.kf_pose.shape[:2]) == (2, 20)
    for s in range(2):
        np.testing.assert_array_equal(
            ts.tracker.keypoints.alive[s].numpy(),
            np.asarray(js.tracker.keypoints.alive[s]))
        np.testing.assert_array_equal(
            ts.tracker.keypoints.position[s].numpy(),
            np.asarray(js.tracker.keypoints.position[s]))
        n = int(js.n_keyframes[s])
        assert n == ts.n_keyframes == T // 4
        np.testing.assert_array_equal(ts.hist_frame[s, :n].numpy(),
                                      np.asarray(js.hist_frame[s, :n]))
        np.testing.assert_allclose(ts.hist_pose[s, :n].numpy(),
                                   np.asarray(js.hist_pose[s, :n]),
                                   atol=0.05)
        gt = gts[s][ts.hist_frame[s, :n].numpy()]
        assert _ate(ts.hist_pose[s, :n].numpy(), gt) < 0.08


def test_streams_guards():
    jcfg, tcfg = _cfgs()
    f = np.zeros((1, 8, H, W), np.float32)
    b = np.broadcast_to(np.eye(4, dtype=np.float32), (1, 2, 4, 4))
    with pytest.raises(ValueError):
        tp.slam_run_streams(f, dataclasses.replace(tcfg,
                                                   enable_recovery=True),
                            b, device="cpu")
    with pytest.raises(ValueError):
        tp.slam_run_streams(f[:, :7], tcfg, b, device="cpu")


# -- kernels' plain versions: S = 3 in one call against three calls ------

S3 = 3


def _frames3():
    return torch.from_numpy(np.stack([_scene(s)[1][5] for s in range(S3)]))


def _same(batched, singles):
    for i, one in enumerate(singles):
        if isinstance(one, tuple):
            for a, b in zip(batched, one):
                assert torch.equal(a[i], b), i
        else:
            assert torch.equal(batched[i], one), i


def test_plain_k4_pyramid_streams():
    fr = _frames3()
    lv = pyramid.pyramid_streams(fr, 3, border=B)
    for i in range(S3):
        one = pyramid.pyramid(pyramid.Image2d(data=fr[i], border=0), 3,
                              border=B)
        for lvl in range(3):
            assert torch.equal(lv[lvl][i], one[lvl].data)


def test_plain_k2_score_image_and_cull_streams():
    lv0 = pyramid.pyramid_streams(_frames3(), 1, border=B)[0]
    rng = np.random.RandomState(0)
    mask = torch.from_numpy((rng.rand(S3, H, W) > 0.3).astype(np.uint8))
    pos = torch.from_numpy((rng.rand(S3, 200, 2) * [H + 10, W + 10]
                            - 5).astype(np.float32))
    img = fast.score_image(lv0, B, 8, mask)
    cull = fast.cull_scores(lv0, B, pos, 8)
    for i in range(S3):
        assert torch.equal(img[i], fast.score_image(lv0[i], B, 8, mask[i]))
        assert torch.equal(cull[i], fast.fast9_cull_scores(
            fast.Image2d(data=lv0[i], border=B), pos[i], 8))


def test_plain_k3_block_topk_streams():
    lv0 = pyramid.pyramid_streams(_frames3(), 1, border=B)[0]
    img = fast.score_image(lv0, B, 8)
    for k in (64, 400):
        got = fast.block_topk(img, 1, 8, k)
        _same(got, [fast._blockwise_keypoints(fast.Image2d(
            data=img[i], border=1), 8, k) for i in range(S3)])


def test_plain_k1_flow_level_streams():
    fr = _frames3()
    lv1 = pyramid.pyramid_streams(fr, 3, border=B)
    lv2 = pyramid.pyramid_streams(torch.roll(fr, 2, dims=-1), 3, border=B)
    for s in (0, 1):
        h, w = lv1[s].shape[-2] - 2 * B, lv1[s].shape[-1] - 2 * B
        gh, gw = max(h // 5, 1), max(w // 5, 1)
        g = flow.LevelGeometry(b=B, h=h, w=w, ws=9, patch=5, gh=gh, gw=gw,
                               R=5 if s == 1 else 1,
                               pred_bound=0 if s == 1 else 6)
        rng = np.random.RandomState(s)
        pred = torch.from_numpy(rng.randint(-6, 7, (S3, gh, gw, 2)).astype(
            np.int32))
        got = flow.flow_level(lv1[s], lv2[s], pred, g, 2)
        _same(got, [flow.flow_level(lv1[s][i], lv2[s][i], pred[i], g, 2)
                    for i in range(S3)])
        m = flow.flow_match_plain(lv1[s], lv2[s], pred, g)
        _same(m, [flow.flow_match_plain(lv1[s][i], lv2[s][i], pred[i], g)
                  for i in range(S3)])


def test_plain_k5_patches_streams():
    lv0 = pyramid.pyramid_streams(_frames3(), 1, border=B)[0]
    rng = np.random.RandomState(1)
    ctr = torch.from_numpy(rng.randint(-3, W + 20, (S3, 100, 2)).astype(
        np.int32))
    got = interp.extract_patches(lv0, ctr, 7)
    _same(got, [interp.extract_patches(lv0[i], ctr[i], 7)
                for i in range(S3)])


def _ba_problems(n=150, m=6, seed=0):
    rng = np.random.RandomState(seed)
    intr = torch.tensor(INTR)
    probs = []
    for _ in range(S3):
        X = rng.randn(n, 3).astype(np.float32) * [2, 1.5, 1] + [0, 0, 6]
        poses = np.tile(np.eye(4, dtype=np.float32), (m, 1, 1))
        poses[:, 0, 3] = -0.1 * np.arange(m)
        poses[1:, :3, 3] += rng.randn(m - 1, 3) * 0.01
        Xt = torch.from_numpy(X.astype(np.float32))
        P = torch.from_numpy(poses)
        uv = ba.project(P[None], Xt[:, None], intr)
        uv = uv + torch.from_numpy(rng.randn(n, m, 2).astype(np.float32))
        valid = torch.from_numpy(rng.rand(n, m) > 0.3)
        fixed = torch.zeros(m, dtype=torch.bool)
        fixed[:2] = True
        probs.append(ba.BATracks(
            poses=P, landmarks=Xt + 0.05, obs_pose=torch.arange(
                m, dtype=torch.int32).expand(n, m), obs_uv=uv,
            obs_valid=valid, intrinsics=intr, fixed_poses=fixed))
    batched = ba.BATracks(*(probs[0][i] if i == 5 else torch.stack(
        [p[i] for p in probs]) for i in range(7)))
    return batched, probs


@pytest.mark.parametrize("linalg", ["chol", "lu"])
def test_plain_k6_ba_streams(linalg):
    batched, probs = _ba_problems()
    got, costs = ba.ba_solve_tracks(batched, iters=3, huber=4.0, lam0=1e-4,
                                    ring_layout=True, linalg=linalg)
    assert costs.shape == (S3, 3)
    for i, p in enumerate(probs):
        one, c1 = ba.ba_solve_tracks(p, iters=3, huber=4.0, lam0=1e-4,
                                     ring_layout=True, linalg=linalg)
        assert torch.equal(got.poses[i], one.poses), i
        assert torch.equal(got.landmarks[i], one.landmarks), i
        assert torch.equal(costs[i], c1), i


@pytest.mark.parametrize("linalg", ["chol", "lu"])
def test_ring_of_twenty_one_k9_call_a_stream(monkeypatch, linalg):
    """The card's route for a ring of S = 3 streams of M = 20 poses (more
    than K6 holds), held on the CPU: ``_lm_tracks(kernel=True)`` calls
    K9's ``lm_generic`` once a stream, in stream order, on the stream's
    own problem with ``obs_pose = arange(M)``, and stacks the results.
    With ``lm_generic`` standing in as the plain LM loop on one problem,
    the result is bit-equal to the plain S = 3 streams path."""
    from vpp_tpu_torch.slam import ba_generic_cuda
    batched, probs = _ba_problems(m=20)
    calls = []

    def plain_one(prob, iters, huber, lam0, linalg):
        calls.append(prob)
        out, costs = ba._lm_plain(prob, iters, huber, lam0, True, linalg)
        return out.poses, out.landmarks, costs, None

    monkeypatch.setattr(ba_generic_cuda, "lm_generic", plain_one)
    got, costs = ba._lm_tracks(batched, 3, 4.0, 1e-4, True, linalg,
                               kernel=True)
    want, wcosts = ba._lm_tracks(batched, 3, 4.0, 1e-4, True, linalg,
                                 kernel=False)
    assert len(calls) == S3
    ar = torch.arange(20, dtype=torch.int32).expand(150, 20)
    for i, (call, prob) in enumerate(zip(calls, probs)):
        assert torch.equal(call.landmarks, prob.landmarks), i
        assert torch.equal(call.obs_uv, prob.obs_uv), i
        assert torch.equal(call.obs_pose, ar), i
    assert costs.shape == (S3, 3)
    assert torch.equal(got.poses, want.poses)
    assert torch.equal(got.landmarks, want.landmarks)
    assert torch.equal(costs, wcosts)


# -- convert: a JAX streams state across, and back -------------------------

def _jax_state(m):
    """A batched JAX ``SlamState`` from a ``state_to_numpy(streams=S)``
    mapping (or the JAX mapping itself)."""
    tr = m["tracker"]
    tracker = JVState(
        keypoints=JKeypoints(**{k: jnp.asarray(v)
                                for k, v in tr["keypoints"].items()}),
        traj=jnp.asarray(tr["traj"]), traj_len=jnp.asarray(tr["traj_len"]),
        frame_id=jnp.asarray(tr["frame_id"]))
    fields = {f.name: jnp.asarray(m[f.name])
              for f in dataclasses.fields(jp.SlamState)
              if f.name != "tracker"}
    return jp.SlamState(tracker=tracker, **fields)


def _jax_mapping(st):
    m = {f.name: np.asarray(getattr(st, f.name))
         for f in dataclasses.fields(st) if f.name != "tracker"}
    tr = st.tracker
    m["tracker"] = {f.name: np.asarray(getattr(tr, f.name))
                    for f in dataclasses.fields(tr) if f.name != "keypoints"}
    m["tracker"]["keypoints"] = {
        n: np.asarray(getattr(tr.keypoints, n))
        for n in ("position", "velocity", "age")}
    return m


def test_convert_streams_state_and_continue(clips):
    frames, boot, gts = clips
    jcfg, tcfg = _cfgs()
    half = 8
    js = jax.jit(lambda f, b: jp.slam_run_streams(f, jcfg, b))(
        jnp.asarray(frames[:, :half]), jnp.asarray(boot))
    m = _jax_mapping(js)
    assert m["n_keyframes"].shape == (2,)
    ts = convert.slam_state_from_numpy(m, device="cpu")
    assert ts.n_keyframes == 2 and ts.tracker.frame_id == half - 1
    assert ts.lm_X.shape == (2, 256, 3)
    back = convert.state_to_numpy(ts, streams=2)
    for f in dataclasses.fields(jp.SlamState):
        if f.name != "tracker":
            np.testing.assert_array_equal(back[f.name], m[f.name], f.name)
    np.testing.assert_array_equal(back["tracker"]["frame_id"],
                                  m["tracker"]["frame_id"])

    # 8 more frames on both from that state
    def one(st, prev, clip):
        def step(carry, fr2):
            s_, f1 = carry
            s_ = jp.slam_step(s_, j_from_array(f1, border=B,
                                               border_mode="mirror"),
                              j_from_array(fr2, border=B,
                                           border_mode="mirror"), jcfg)
            return (s_, fr2), None
        (st, _), _ = jax.lax.scan(step, (st, prev), clip)
        return st
    jf = jax.jit(jax.vmap(one))(_jax_state(m),
                                jnp.asarray(frames[:, half - 1]),
                                jnp.asarray(frames[:, half:]))
    fr = torch.from_numpy(frames)
    lv1 = pyramid.pyramid_streams(fr[:, half - 1], 3, border=B)
    for i in range(half, T):
        lv2 = pyramid.pyramid_streams(fr[:, i], 3, border=B)
        ts = tp._slam_step_streams(ts, lv2[0], B, tcfg, lv1, lv2, B)
        lv1 = lv2
    for s in range(2):
        np.testing.assert_array_equal(
            ts.tracker.keypoints.alive[s].numpy(),
            np.asarray(jf.tracker.keypoints.alive[s]))
        np.testing.assert_array_equal(
            ts.tracker.keypoints.position[s].numpy(),
            np.asarray(jf.tracker.keypoints.position[s]))
        n = int(jf.n_keyframes[s])
        assert n == ts.n_keyframes == T // 4
        np.testing.assert_allclose(ts.hist_pose[s, :n].numpy(),
                                   np.asarray(jf.hist_pose[s, :n]),
                                   atol=0.05)
        gt = gts[s][ts.hist_frame[s, :n].numpy()]
        assert _ate(ts.hist_pose[s, :n].numpy(), gt) < 0.08
    bad = dict(m, n_keyframes=np.array([2, 3], np.int32))
    with pytest.raises(ValueError):
        convert.slam_state_from_numpy(bad, device="cpu")
