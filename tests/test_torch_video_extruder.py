"""Parity of vpp_tpu_torch's video_extruder tracker with vpp_tpu's on the
CPU: a 6-frame clip end to end, and a mid-clip hand-over of the JAX state
through ``vpp_tpu_torch.convert``.

Alive flags and positions are compared slot by slot; at most 1% of the
live slots may differ, because the flow's SAD sums run in another order
and can break a near-tie the other way (on these clips they agree
exactly).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpp_tpu.core.image import from_array as j_from_array
from vpp_tpu_torch import convert
from vpp_tpu_torch.core.image import from_array as t_from_array
from vpp_tpu_torch.utils.clips import make_clip

jv = importlib.import_module("vpp_tpu.algorithms.video_extruder")
tv = importlib.import_module("vpp_tpu_torch.algorithms.video_extruder")
j_kp = importlib.import_module("vpp_tpu.core.keypoints")
t_kp = importlib.import_module("vpp_tpu_torch.core.keypoints")

torch.set_num_threads(1)

CFG = dict(capacity=256, detect_k=128, nscales=3, winsize=9,
           keypoint_spacing=10, detector_period=2)
H, W = 96, 128


def _assert_close_states(j_alive, j_pos, t_alive, t_pos):
    j_alive, j_pos = np.asarray(j_alive), np.asarray(j_pos)
    t_alive, t_pos = t_alive.numpy(), t_pos.numpy()
    live = j_alive | t_alive
    differ = (j_alive != t_alive) | (np.abs(j_pos - t_pos).max(-1) > 0)
    differ &= live
    assert live.sum() > 0
    assert differ.sum() <= 0.01 * live.sum(), (differ.sum(), live.sum())


@pytest.fixture(scope="module")
def jax_step():
    """One jitted JAX tracker step, compiled once for the module."""
    jcfg = jv.VideoExtruderConfig(**CFG)
    b = max(3, jcfg.winsize)
    return jax.jit(lambda st, f1, f2: jv.video_extruder_update(
        st, j_from_array(f1, border=b, border_mode="mirror"),
        j_from_array(f2, border=b, border_mode="mirror"), jcfg))


def test_video_extruder_run_matches(jax_step):
    """``video_extruder_run`` against the JAX steps it scans (the first
    step tracks frame 0 against itself)."""
    clip = make_clip(W, H, 6, seed=3)
    ts, (tp, ta) = tv.video_extruder_run(clip, tv.VideoExtruderConfig(**CFG),
                                         device="cpu")
    assert tuple(tp.shape) == (6, 256, 2) and tuple(ta.shape) == (6, 256)
    js = jv.video_extruder_init(jv.VideoExtruderConfig(**CFG))
    for t in range(6):
        js = jax_step(js, jnp.asarray(clip[max(t - 1, 0)]),
                      jnp.asarray(clip[t]))
        _assert_close_states(js.keypoints.alive, js.keypoints.position,
                             ta[t], tp[t])
    assert ts.frame_id == int(js.frame_id) == 5
    same = np.asarray(js.keypoints.alive) == ts.keypoints.alive.numpy()
    np.testing.assert_array_equal(np.asarray(js.traj_len)[same],
                                  ts.traj_len.numpy()[same])


def _jax_state_mapping(st):
    m = {f.name: np.asarray(getattr(st, f.name))
         for f in dataclasses.fields(st) if f.name != "keypoints"}
    m["keypoints"] = {n: np.asarray(getattr(st.keypoints, n))
                      for n in ("position", "velocity", "age")}
    return m


def test_handover_mid_clip_through_convert(jax_step):
    """Three frames in JAX, then the state crosses over and both packages
    track three more frames."""
    clip = make_clip(W, H, 7, seed=5)
    jcfg = jv.VideoExtruderConfig(**CFG)
    tcfg = tv.VideoExtruderConfig(**CFG)
    b = max(3, jcfg.winsize)
    jstep = jax_step
    js = jv.video_extruder_init(jcfg)
    for t in range(3):
        js = jstep(js, jnp.asarray(clip[t]), jnp.asarray(clip[t + 1]))
    ts = convert.video_extruder_state_from_numpy(_jax_state_mapping(js),
                                                 device="cpu")
    back = convert.video_extruder_state_to_numpy(ts)
    for name in ("traj", "traj_len"):
        np.testing.assert_array_equal(back[name],
                                      np.asarray(getattr(js, name)))
    np.testing.assert_array_equal(back["keypoints"]["age"],
                                  np.asarray(js.keypoints.age))
    assert ts.frame_id == 2
    for t in range(3, 6):
        js = jstep(js, jnp.asarray(clip[t]), jnp.asarray(clip[t + 1]))
        ts = tv.video_extruder_update(
            ts, t_from_array(clip[t], border=b, border_mode="mirror"),
            t_from_array(clip[t + 1], border=b, border_mode="mirror"), tcfg)
    _assert_close_states(js.keypoints.alive, js.keypoints.position,
                         ts.keypoints.alive, ts.keypoints.position)
    assert ts.frame_id == int(js.frame_id)


def _random_kps(seed, k=128):
    rng = np.random.RandomState(seed)
    pos = np.stack([rng.rand(k) * (H + 4) - 2, rng.rand(k) * (W + 4) - 2],
                   -1).astype(np.float32)
    age = (rng.randint(1, 6, k) * (rng.rand(k) > 0.2)).astype(np.int32)
    vel = np.zeros((k, 2), np.float32)
    return (j_kp.Keypoints(position=jnp.asarray(pos),
                           velocity=jnp.asarray(vel), age=jnp.asarray(age)),
            t_kp.Keypoints(position=torch.from_numpy(pos),
                           velocity=torch.from_numpy(vel),
                           age=torch.from_numpy(age)))


@pytest.mark.parametrize("spacing", [7, 10])
def test_merge_and_occupancy_bit_equal(spacing):
    jk, tk = _random_kps(spacing)
    jm = jv._merge_collided(jk, (H, W), spacing)
    tm = tv._merge_collided(tk, (H, W), spacing)
    np.testing.assert_array_equal(np.asarray(jm.age), tm.age.numpy())
    np.testing.assert_array_equal(
        np.asarray(jv._occupancy_mask(jk, (H, W), spacing)),
        tv._occupancy_mask(tk, (H, W), spacing).numpy())


def test_config_defaults_and_init():
    assert tv.VideoExtruderConfig() == tv.VideoExtruderConfig(
        **dataclasses.asdict(jv.VideoExtruderConfig()))
    st = tv.video_extruder_init(tv.VideoExtruderConfig(capacity=32),
                                device="cpu")
    js = jv.video_extruder_init(jv.VideoExtruderConfig(capacity=32))
    assert st.frame_id == int(js.frame_id) == -1
    assert tuple(st.traj.shape) == js.traj.shape
