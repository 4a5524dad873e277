"""Parity of the port's SLAM pipeline (tracking+BA, ``enable_recovery=
False``) with vpp_tpu's on the CPU, on tests/test_pipeline.py's 120x160
scene and config.

* ``_do_keyframe`` from one state carried across by ``convert``: poses
  atol 1e-4, ``lm_X`` rtol 1e-3 where both are valid, ``lm_valid`` equal
  on at least 99% of slots (a float32 gate can fall the other way).
* ``slam_run``: the same keyframe count, ATE < 0.065 on both (the JAX
  test's bound) and within 0.01 of each other.
* ``slam_run`` with ``ba_iters=0``: the same keyframes, poses atol 1e-4.
* ``convert`` round trip of a JAX state after two keyframes; every JAX
  configuration runs, ``mesh=`` too (on a one-rank mesh the same state as
  without one; tests/test_torch_slam_sharded.py holds it on 4 ranks).
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
from vpp_tpu_torch.algorithms.video_extruder import (
    VideoExtruderConfig as TVConfig, video_extruder_update)
from vpp_tpu_torch.core.image import from_array as t_from_array
from vpp_tpu_torch.utils import synth as tsynth

jp = importlib.import_module("vpp_tpu.slam.pipeline")
tp = importlib.import_module("vpp_tpu_torch.slam.pipeline")
jsynth = importlib.import_module("vpp_tpu.utils.synth")

torch.set_num_threads(1)

H, W = 120, 160
INTR = (160.0, 160.0, 80.0, 60.0)
TRACKER = dict(capacity=256, detect_k=128, nscales=3, winsize=9,
               keypoint_spacing=8, detector_period=1, detector_th=8)
BACK = dict(intrinsics=INTR, keyframe_period=4, ring=6, ba_iters=3,
            min_parallax=2.0, max_reproj=2.0, history=16,
            enable_recovery=False)


def _scene(n_frames=25, seed=0):
    """tests/test_pipeline.py:23, rendered by the port's copy of synth."""
    pts = tsynth.make_cloud(220, seed=seed, extent=(6.0, 4.0, 3.0),
                            center=(0.8, 0.0, 5.0))
    poses = tsynth.camera_path(n_frames, step=(0.06, 0.0, 0.0))
    return poses, tsynth.render_frames(pts, poses, INTR, (H, W), seed=seed)


def _cfgs():
    return (jp.SlamConfig(tracker=JVConfig(**TRACKER), **BACK),
            tp.SlamConfig(tracker=TVConfig(**TRACKER), **BACK))


@pytest.fixture(scope="module")
def runs():
    """The JAX and the port's ``slam_run`` on the 25-frame clip."""
    poses, frames = _scene()
    jcfg, tcfg = _cfgs()
    boot = poses[[0, 4]]
    js = jax.jit(lambda f, b: jp.slam_run(f, jcfg, bootstrap_poses=b))(
        jnp.asarray(frames), jnp.asarray(boot))
    ts = tp.slam_run(frames, tcfg, bootstrap_poses=boot, device="cpu")
    return poses, frames, js, ts


def test_synth_copy_matches():
    pts = jsynth.make_cloud(50, seed=3)
    np.testing.assert_array_equal(pts, tsynth.make_cloud(50, seed=3))
    poses = jsynth.camera_path(5, step=(0.1, 0.0, 0.02), yaw_per_frame=0.01)
    np.testing.assert_array_equal(
        poses, tsynth.camera_path(5, step=(0.1, 0.0, 0.02),
                                  yaw_per_frame=0.01))
    for sigma in (1.3, (1.0, 2.0)):
        np.testing.assert_array_equal(
            jsynth.render_frames(pts, poses, INTR, (40, 50), sigma=sigma),
            tsynth.render_frames(pts, poses, INTR, (40, 50), sigma=sigma))


def test_slam_run_matches(runs):
    poses, _, js, ts = runs
    je, jf = jp.keyframe_trajectory(js)
    te, tf = tp.keyframe_trajectory(ts)
    assert ts.n_keyframes == int(js.n_keyframes) == 7
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    ate_j = float(jp.ate_rmse(je, jnp.asarray(poses[np.asarray(jf)])))
    ate_t = float(tp.ate_rmse(te, torch.from_numpy(poses[tf.numpy()])))
    assert ate_j < 0.065 and ate_t < 0.065, (ate_j, ate_t)
    assert abs(ate_j - ate_t) < 0.01, (ate_j, ate_t)
    assert int(ts.lm_valid.sum()) > 30


def _jax_state(m):
    """A JAX ``SlamState`` from a ``slam_state_to_numpy`` mapping."""
    tr = m["tracker"]
    tracker = JVState(
        keypoints=JKeypoints(**{k: jnp.asarray(v)
                                for k, v in tr["keypoints"].items()}),
        traj=jnp.asarray(tr["traj"]), traj_len=jnp.asarray(tr["traj_len"]),
        frame_id=jnp.int32(tr["frame_id"]))
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


def test_do_keyframe_from_one_state(runs):
    """The port tracks 12 frames and one more tracker step; that state
    crosses to JAX through ``convert``, and both run the keyframe."""
    poses, frames, _, _ = runs
    jcfg, tcfg = _cfgs()
    b = max(3, tcfg.tracker.winsize)
    st = tp.slam_run(frames[:12], tcfg, bootstrap_poses=poses[[0, 4]],
                     device="cpu")
    f1 = t_from_array(frames[11], border=b, border_mode="mirror")
    f2 = t_from_array(frames[12], border=b, border_mode="mirror")
    st = dataclasses.replace(st, tracker=video_extruder_update(
        st.tracker, f1, f2, tcfg.tracker))
    assert st.tracker.frame_id % tcfg.keyframe_period == 0
    m = convert.slam_state_to_numpy(st)
    js = jax.jit(lambda s, f: jp._do_keyframe(
        s, j_from_array(f, border=b, border_mode="mirror"), jcfg))(
        _jax_state(m), jnp.asarray(frames[12]))
    ts = tp._do_keyframe(convert.slam_state_from_numpy(m, device="cpu"), f2,
                         tcfg)
    assert ts.n_keyframes == int(js.n_keyframes) == 4
    np.testing.assert_allclose(ts.kf_pose.numpy(), np.asarray(js.kf_pose),
                               atol=1e-4)
    np.testing.assert_allclose(ts.hist_pose.numpy(),
                               np.asarray(js.hist_pose), atol=1e-4)
    jv, tv = np.asarray(js.lm_valid), ts.lm_valid.numpy()
    assert (jv == tv).mean() >= 0.99
    both = jv & tv
    assert both.sum() > 30
    np.testing.assert_allclose(ts.lm_X.numpy()[both],
                               np.asarray(js.lm_X)[both], rtol=1e-3)
    for name in ("lm_desc", "desc_ctr", "age_at_kf", "kf_valid",
                 "hist_frame", "arch_frame", "arch_ptr"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    assert (np.asarray(js.obs_valid) == ts.obs_valid.numpy()).mean() >= 0.99


def test_convert_round_trip_after_two_keyframes():
    poses, frames = _scene(n_frames=5)
    jcfg, _ = _cfgs()
    js = jp.slam_run(jnp.asarray(frames), jcfg,
                     bootstrap_poses=jnp.asarray(poses[[0, 4]]))
    assert int(js.n_keyframes) == 2
    m = _jax_mapping(js)
    ts = convert.slam_state_from_numpy(m, device="cpu")
    assert ts.n_keyframes == 2 and isinstance(ts.n_keyframes, int)
    assert ts.tracker.frame_id == 4
    back = convert.slam_state_to_numpy(ts)
    for f in dataclasses.fields(jp.SlamState):
        if f.name == "tracker":
            continue
        np.testing.assert_array_equal(back[f.name], m[f.name], f.name)
        if f.name != "n_keyframes":
            assert getattr(ts, f.name).dtype == torch.from_numpy(
                np.ascontiguousarray(m[f.name])).dtype, f.name
    for k in ("traj", "traj_len"):
        np.testing.assert_array_equal(back["tracker"][k], m["tracker"][k])
    np.testing.assert_array_equal(back["tracker"]["keypoints"]["position"],
                                  m["tracker"]["keypoints"]["position"])


def test_slam_run_without_ba_iterations():
    """``SlamConfig(ba_iters=0)``: every keyframe's window BA returns its
    problem unchanged, so the keyframe poses are PnP's: the JAX package's
    within 1e-4."""
    poses, frames = _scene(n_frames=13)
    jcfg, tcfg = (dataclasses.replace(c, ba_iters=0) for c in _cfgs())
    boot = poses[[0, 4]]
    js = jax.jit(lambda f, b: jp.slam_run(f, jcfg, bootstrap_poses=b))(
        jnp.asarray(frames), jnp.asarray(boot))
    ts = tp.slam_run(frames, tcfg, bootstrap_poses=boot, device="cpu")
    assert ts.n_keyframes == int(js.n_keyframes) == 4
    je, jf = jp.keyframe_trajectory(js)
    te, tf = tp.keyframe_trajectory(ts)
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    assert bool(torch.isfinite(te).all())
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-4)


def test_unported_configurations_raise():
    """No configuration raises: the JAX defaults (``enable_recovery=
    True``), ``subpix_refine=True`` and the landmark-sharded BA (``mesh=``,
    here a one-rank mesh: the same state as without one) run."""
    from vpp_tpu_torch.parallel import make_mesh
    _, frames = _scene(n_frames=2)
    _, tcfg = _cfgs()
    tp.slam_init(tp.SlamConfig(intrinsics=INTR), device="cpu")
    for kw in (dict(enable_recovery=True), dict(subpix_refine=True)):
        st = tp.slam_run(frames, dataclasses.replace(tcfg, **kw),
                         device="cpu")
        assert st.tracker.frame_id == 1
    plain = tp.slam_run(frames, tcfg, device="cpu")
    meshed = tp.slam_run(frames, tcfg, mesh=make_mesh((1,), ("lm",)),
                         axis="lm", device="cpu")
    assert meshed.n_keyframes == plain.n_keyframes
    for name in ("kf_pose", "lm_X", "lm_valid", "obs_valid"):
        assert torch.equal(getattr(meshed, name), getattr(plain, name))
    assert tp.SlamConfig(intrinsics=INTR) == tp.SlamConfig(
        **{k: v for k, v in dataclasses.asdict(jp.SlamConfig(
            intrinsics=INTR)).items() if k != "tracker"},
        tracker=TVConfig(**dataclasses.asdict(jp.SlamConfig(
            intrinsics=INTR).tracker)))
