"""SPMD cases of the port's sharded tracker, one call a case on every rank
of an 8-rank gloo group (``torch_spmd.run_group``); each returns numpy
arrays. Inputs are tests/test_sharded_tracker.py's, through
``torch_spmd``'s recipes. Imports only numpy, torch and vpp_tpu_torch."""

import dataclasses
import os

import numpy as np
import torch

from torch_spmd import points, scene
from vpp_tpu_torch.algorithms.video_extruder import (VideoExtruderConfig,
                                                     video_extruder_init)
from vpp_tpu_torch.core.keypoints import kp_kill_where
from vpp_tpu_torch.parallel import (make_mesh, sharded_fast9_score,
                                    sharded_tracker_batch_step)
from vpp_tpu_torch.parallel.mesh import collective_routes, distributed_mesh
from vpp_tpu_torch.parallel.sharded_tracker import (
    _flow_locals, sharded_semi_dense_flow, sharded_video_extruder_update)

KW = dict(winsize=7, nscales=2, propagation=2, patchsize=5, search_niters=3)
UPDATE_CFG = dict(capacity=128, detect_k=64, nscales=2, winsize=7,
                  patchsize=5, keypoint_spacing=10, detector_period=2,
                  detector_th=8)
W = 320

_MESH = {}


def _mesh():
    if "sp" not in _MESH:
        _MESH["sp"] = make_mesh((8,), ("sp",))
    return _MESH["sp"]


def _flow_on(mesh, f1, f2, pts, val):
    m, d, ok = sharded_semi_dense_flow(
        mesh, torch.from_numpy(pts), torch.from_numpy(val),
        torch.from_numpy(f1), torch.from_numpy(f2), **KW)
    return m.numpy(), d.numpy(), ok.numpy()


def _flow(f1, f2, pts, val):
    return _flow_on(_mesh(), f1, f2, pts, val)


def flow_ring():
    f1, f2 = scene((3, -2))
    return _flow(f1, f2, points(120), np.ones((120,), bool))


def dead_points():
    """Keypoints straddling every shard boundary, and dead ones."""
    cols = [41.0, 79.0, 81.0, 119.0, 160.0, 201.0, 239.0, 250.0, 255.0]
    pts = points(120, seed=4)
    pts[:len(cols)] = [[30.0, c] for c in cols]
    val = np.zeros((120,), bool)
    val[:8] = True
    return pts, val


def flow_dead():
    f1, f2 = scene((1, 1), seed=3)
    return _flow(f1, f2, *dead_points())


def allgather_points():
    rng = np.random.RandomState(2)
    return np.stack([rng.randint(8, 40, 48),
                     rng.randint(40, 104, 48)], -1).astype(np.float32)


def flow_allgather():
    """W 160 on 8 ranks: shard width 20 < halo 40, the all-gather route."""
    f1, f2 = scene((2, -1), seed=9, h=48, w=160)
    return _flow(f1, f2, allgather_points(), np.ones((48,), bool))


def geometry():
    """The halo each geometry gets (the conservative switch past
    nscales 3)."""
    _, deep = _flow_locals(_mesh(), "sp", (64, 640), 7, 4, 2, 5, 3, 1)
    _, three = _flow_locals(_mesh(), "sp", (64, 320), 7, 3, 2, 5, 3, 1)
    return {"deep": deep["halo"], "three": three["halo"],
            "routes": collective_routes(_mesh(), "sp", torch.device("cpu"))}


def update_frames():
    f0, f1 = scene((2, -1), seed=7)
    _, f2 = scene((4, -2), seed=7)
    return ((f0, f0), (f0, f1), (f1, f2))


def kill_margin(st):
    """Kill the keypoints in the right-margin band (and the left one), where
    the sharded flow may differ (module docstring of sharded_tracker)."""
    col = st.keypoints.position[..., 1]
    bad = st.keypoints.alive & ((col < 40) | (col >= W - 56))
    return dataclasses.replace(st, keypoints=kp_kill_where(st.keypoints,
                                                           bad))


def _state_arrays(st):
    return {"age": st.keypoints.age.numpy().copy(),
            "position": st.keypoints.position.numpy().copy(),
            "traj_len": st.traj_len.numpy().copy(),
            "traj": st.traj.numpy().copy()}


def update():
    """Three complete sharded tracker steps, the margin killed between."""
    cfg = VideoExtruderConfig(**UPDATE_CFG)
    st = video_extruder_init(cfg, device="cpu")
    out = []
    for fr1, fr2 in update_frames():
        st = sharded_video_extruder_update(
            _mesh(), st, torch.from_numpy(fr1), torch.from_numpy(fr2), cfg)
        out.append(_state_arrays(st))
        st = kill_margin(st)
    return out


def dryrun_frames():
    rng = np.random.RandomState(0)
    f1 = rng.randint(0, 255, (2, 64, 128)).astype(np.float32)
    f2 = rng.randint(0, 255, (2, 64, 128)).astype(np.float32)
    return f1, f2


def dp_sp():
    """``sharded_fast9_score`` over "sp" and ``sharded_tracker_batch_step``
    over "dp" of a 2 x 4 mesh (``__graft_entry__.dryrun_multichip(8)``)."""
    mesh = make_mesh((2, 4), ("dp", "sp"))
    f1, f2 = dryrun_frames()
    total = sharded_fast9_score(mesh, torch.from_numpy(f1[0]), th=10)
    alive = sharded_tracker_batch_step(mesh, torch.from_numpy(f1),
                                       torch.from_numpy(f2))
    return {"total": total.numpy(), "alive": alive.numpy()}


def multihost_inputs():
    """evaluation/multihost_check.py's scene and keypoints."""
    from numpy.lib.stride_tricks import sliding_window_view
    rng = np.random.RandomState(11)
    base = rng.randint(0, 256, (128, 640)).astype(np.float32)
    sm = sliding_window_view(np.pad(base, 1, mode="wrap"), (3, 3))
    sm = (sm.sum(axis=(2, 3)) // 9).astype(np.float32)
    f1 = np.ascontiguousarray(sm[32:96, 32:352])
    f2 = np.ascontiguousarray(sm[35:99, 30:350])
    rng2 = np.random.RandomState(12)
    pts = np.stack([rng2.randint(8, 56, 120),
                    rng2.randint(40, 264, 120)], -1).astype(np.float32)
    return f1, f2, pts


def multihost():
    """The multi-process recipe: each process calls ``distributed_mesh``
    with the coordinator (a ``file://`` store here), the process count and
    its id, then the sharded flow over the 2-rank mesh."""
    mesh = distributed_mesh((2,), ("sp",),
                            coordinator=f"file://{os.environ['SPMD_STORE']}",
                            num_processes=2,
                            process_id=int(os.environ["SPMD_RANK"]))
    f1, f2, pts = multihost_inputs()
    return _flow_on(mesh, f1, f2, pts, np.ones((120,), bool))
