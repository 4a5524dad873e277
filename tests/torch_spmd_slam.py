"""SPMD cases of the port's sharded BA and ``slam_run(mesh=)``, on every
rank of an 8-rank gloo group (``torch_spmd.run_group``); the problems come
in the payload as numpy arrays (tests/test_torch_slam_sharded.py makes them
with the JAX tests' recipes). A case on a mesh of fewer ranks returns None
on the ranks it leaves out. Imports only numpy, torch and vpp_tpu_torch."""

import numpy as np
import torch

from vpp_tpu_torch.algorithms.video_extruder import VideoExtruderConfig
from vpp_tpu_torch.parallel import make_mesh
from vpp_tpu_torch.slam import ba as tba
from vpp_tpu_torch.slam import pipeline as tp
from vpp_tpu_torch.utils.synth import camera_path, make_cloud, render_frames

# __graft_entry__.dryrun_multichip's SLAM run: 4 "lm" ranks, capacity 32
SLAM_RANKS = 4
SLAM_INTR = (80.0, 80.0, 64.0, 32.0)


def slam_cfg():
    return tp.SlamConfig(
        intrinsics=SLAM_INTR, keyframe_period=2, ring=4, ba_iters=2,
        min_parallax=1.0, history=8,
        tracker=VideoExtruderConfig(capacity=8 * SLAM_RANKS, detect_k=32,
                                    nscales=2, winsize=7,
                                    keypoint_spacing=8, detector_period=1,
                                    detector_th=8))


def slam_clip():
    pts = make_cloud(40, seed=0, extent=(4.0, 2.0, 2.0),
                     center=(0.3, 0.0, 4.0))
    poses_gt = camera_path(7, step=(0.08, 0.0, 0.0))
    clip = render_frames(pts, poses_gt, SLAM_INTR, (32, 128), seed=0)
    return clip, poses_gt[[0, 2]]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _problem(cls, arrays):
    return cls(**{k: _t(v) for k, v in arrays.items()})


def _arrays(prob, costs):
    return {"poses": prob.poses.numpy(), "landmarks": prob.landmarks.numpy(),
            "costs": costs.numpy()}


def flat(payload):
    """The flat ``ba_solve``, observations over 4 "obs" ranks (a mesh of
    the first 4 of the 8)."""
    mesh = make_mesh((4,), ("obs",), devices=range(4))
    if mesh.coords is None:
        return None
    prob = _problem(tba.BAProblem, payload["flat"])
    return _arrays(*tba.ba_solve(prob, iters=4, mesh=mesh, axis="obs"))


def tracks(payload):
    """``ba_solve_tracks`` over 8 "lm" ranks: the generic layout with both
    linalg choices, and the ring layout."""
    mesh = make_mesh((8,), ("lm",))
    out = {}
    for name, ring in (("generic", False), ("ring", True)):
        prob = _problem(tba.BATracks, payload[name])
        for linalg in ("lu", "chol"):
            out[f"{name}_{linalg}"] = _arrays(*tba.ba_solve_tracks(
                prob, iters=4, mesh=mesh, axis="lm", ring_layout=ring,
                linalg=linalg))
    return out


def _state_arrays(st):
    return {"kf_pose": st.kf_pose.numpy(), "lm_X": st.lm_X.numpy(),
            "lm_valid": st.lm_valid.numpy(), "hist_pose": st.hist_pose.numpy(),
            "position": st.tracker.keypoints.position.numpy(),
            "age": st.tracker.keypoints.age.numpy(),
            "n_keyframes": st.n_keyframes}


def slam(payload=None):
    """``slam_run`` with the window BA's landmarks over 4 "lm" ranks."""
    mesh = make_mesh((SLAM_RANKS,), ("lm",), devices=range(SLAM_RANKS))
    if mesh.coords is None:
        return None
    clip, boot = slam_clip()
    st = tp.slam_run(clip, slam_cfg(), bootstrap_poses=boot, mesh=mesh,
                     axis="lm", device="cpu")
    return _state_arrays(st)

