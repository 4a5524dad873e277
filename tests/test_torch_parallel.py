"""The port's sharded tracker (``vpp_tpu_torch.parallel``) on an 8-rank gloo
group on the CPU, against the port's single-device tracker and the JAX
package's sharded tracker on its 8-device CPU mesh.

One group runs every case (``torch_spmd_tracker``) once for the module.
Each sharded result is held
- bit-equal to the port's single-device result away from the right margin,
  with every rank's result the same bits;
- bit-equal to JAX's sharded result: ``_scene``'s frames are
  integer-valued, so every pyramid level and window sum is exact.
Inputs are tests/test_sharded_tracker.py's: the ring route at W 320 and
shard width 40, dead and boundary keypoints, the all-gather route at W 160,
the complete update over three steps with the margin killed between, and
the 2 x 4 ("dp", "sp") mesh of ``__graft_entry__.dryrun_multichip``.
"""

import ast
import importlib
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import torch_spmd as S
import torch_spmd_tracker as C
from vpp_tpu.parallel import mesh as j_mesh
from vpp_tpu.parallel import sharded as j_sharded
from vpp_tpu.parallel import sharded_tracker as j_st
from vpp_tpu_torch.algorithms.flow import semi_dense_optical_flow
from vpp_tpu_torch.algorithms.video_extruder import (VideoExtruderConfig,
                                                     video_extruder_init,
                                                     video_extruder_update)
from vpp_tpu_torch.core.image import from_array
from vpp_tpu_torch.parallel import mesh as t_mesh
from vpp_tpu_torch.parallel import sharded_tracker as t_st

jve = importlib.import_module("vpp_tpu.algorithms.video_extruder")
jkp = importlib.import_module("vpp_tpu.core.keypoints")

CASES = ["flow_ring", "flow_dead", "flow_allgather", "geometry", "update",
         "dp_sp"]
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results, one 8-rank gloo group for the module."""
    return S.run_group(8, "torch_spmd_tracker", CASES)


def _same_on_every_rank(ranks, name):
    def flat(x):
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in flat(x[k])]
        if isinstance(x, (list, tuple)):
            return [v for item in x for v in flat(item)]
        return [np.asarray(x)]
    first = flat(ranks[0][name])
    for r, res in enumerate(ranks[1:], 1):
        for a, b in zip(first, flat(res[name])):
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, r)
    return ranks[0][name]


def _port_flow(f1, f2, pts, val):
    b = max(3, C.KW["winsize"])
    m, d, ok = semi_dense_optical_flow(
        torch.from_numpy(pts), torch.from_numpy(val),
        from_array(torch.from_numpy(f1), border=b, border_mode="mirror"),
        from_array(torch.from_numpy(f2), border=b, border_mode="mirror"),
        **C.KW)
    return m.numpy(), d.numpy(), ok.numpy()


def _jax_flow(f1, f2, pts, val):
    mesh = JMesh(np.array(jax.devices()[:8]), ("sp",))
    out = j_st.sharded_semi_dense_flow(mesh, jnp.asarray(pts),
                                       jnp.asarray(val), jnp.asarray(f1),
                                       jnp.asarray(f2), **C.KW)
    return tuple(np.asarray(x) for x in out)


def _assert_flow(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("case,inputs", [
    ("flow_ring", lambda: (*S.scene((3, -2)), S.points(120),
                           np.ones((120,), bool))),
    ("flow_dead", lambda: (*S.scene((1, 1), seed=3), *C.dead_points())),
    ("flow_allgather", lambda: (*S.scene((2, -1), seed=9, h=48, w=160),
                                C.allgather_points(), np.ones((48,), bool))),
])
def test_sharded_flow(ranks, case, inputs):
    """The ring route (halo 40 = shard width 40), boundary and dead
    keypoints, and the all-gather route (shard width 20 < halo 40): the
    port's sharded flow against its single-device flow and JAX's sharded
    flow, the same bits on every rank."""
    got = _same_on_every_rank(ranks, case)
    f1, f2, pts, val = inputs()
    _assert_flow(got, _port_flow(f1, f2, pts, val))
    _assert_flow(got, _jax_flow(f1, f2, pts, val))
    assert got[2].sum() == val.sum()
    if case == "flow_dead":
        assert not got[2][8]
    if case != "flow_dead":
        fl = got[0] - pts
        shift = {"flow_ring": [-3.0, 2.0], "flow_allgather": [-2.0, 1.0]}
        assert (np.abs(np.median(fl, axis=0) - shift[case]) <= 0.5).all()


def test_halo_geometry(ranks):
    """``flow_halo`` and the conservative switch equal JAX's, and the
    geometry a rank derives takes the conservative halo past nscales 3;
    the default config's halo fits the shard (the ring route)."""
    for args in [(9, 3, 5, 2, 5), (7, 2, 5, 2, 3), (7, 4, 5, 2, 3),
                 (11, 3, 4, 3, 2)]:
        for cons in (False, True):
            assert (t_st.flow_halo(*args, conservative=cons)
                    == j_st.flow_halo(*args, conservative=cons))
    for ns, prop in [(3, 2), (4, 2), (3, 3), (2, 1)]:
        assert (t_st.needs_conservative_halo(ns, prop)
                == j_st.needs_conservative_halo(ns, prop))
    h = t_st.flow_halo(9, 3, 5, 2, 5)
    assert h >= 5 * 7 + 9 + 10 and h % 20 == 0
    assert t_st.flow_halo(C.KW["winsize"], 2, 5, 2, 3) <= C.W // 8
    geom = _same_on_every_rank(ranks, "geometry")
    assert geom["deep"] == t_st.flow_halo(7, 4, 5, 2, 3, conservative=True)
    assert geom["three"] == t_st.flow_halo(7, 3, 5, 2, 3)
    assert geom["routes"]["exchange"] == "gloo batch_isend_irecv, direct"


def _jax_update_states():
    cfg = jve.VideoExtruderConfig(**C.UPDATE_CFG)
    mesh = JMesh(np.array(jax.devices()[:8]), ("sp",))
    st = jve.video_extruder_init(cfg)
    out = []
    for fr1, fr2 in C.update_frames():
        st = j_st.sharded_video_extruder_update(mesh, st, jnp.asarray(fr1),
                                                jnp.asarray(fr2), cfg)
        out.append({"age": np.asarray(st.keypoints.age),
                    "position": np.asarray(st.keypoints.position),
                    "traj_len": np.asarray(st.traj_len),
                    "traj": np.asarray(st.traj)})
        col = st.keypoints.position[:, 1]
        bad = st.keypoints.alive & ((col < 40) | (col >= C.W - 56))
        st = st.replace(keypoints=jkp.kp_kill_where(st.keypoints, bad))
    return out


def _port_update_states():
    cfg = VideoExtruderConfig(**C.UPDATE_CFG)
    b = max(3, cfg.winsize)
    st = video_extruder_init(cfg, device="cpu")
    out = []
    for fr1, fr2 in C.update_frames():
        st = video_extruder_update(
            st, from_array(torch.from_numpy(fr1), border=b,
                           border_mode="mirror"),
            from_array(torch.from_numpy(fr2), border=b,
                       border_mode="mirror"), cfg)
        out.append(C._state_arrays(st))
        st = C.kill_margin(st)
    return out


def test_sharded_update(ranks):
    """Three complete sharded tracker steps (flow, cull, detection every
    second frame, lifecycle): ``age``, ``position`` and ``traj_len`` the same
    bits as the port's single-device update and as JAX's sharded update,
    ``traj`` equal, every rank's state the same bits."""
    got = _same_on_every_rank(ranks, "update")
    for want in (_port_update_states(), _jax_update_states()):
        for g, w in zip(got, want):
            for key in ("age", "position", "traj_len", "traj"):
                assert np.array_equal(g[key], w[key]), key
    assert (got[-1]["age"] > 0).sum() > 50


def test_dp_sp_mesh(ranks):
    """A 2 x 4 ("dp", "sp") mesh: the column-sharded FAST score total and
    the data-parallel tracker step equal JAX's on the same frames."""
    got = _same_on_every_rank(ranks, "dp_sp")
    f1, f2 = C.dryrun_frames()
    mesh = j_mesh.make_mesh((2, 4), ("dp", "sp"))
    # jitted: an un-jitted shard_map runs op by op, a collective an op
    total = jax.jit(lambda f: j_sharded.sharded_fast9_score(
        mesh, f, th=10))(jnp.asarray(f1[0]))
    alive = jax.jit(lambda a, b: j_sharded.sharded_tracker_batch_step(
        mesh, a, b))(jnp.asarray(f1), jnp.asarray(f2))
    assert got["total"].dtype == np.int32 and int(got["total"]) == int(total)
    assert np.array_equal(got["alive"], np.asarray(alive))
    assert got["alive"].dtype == np.int32 and (got["alive"] > 0).all()


def test_tracker_comm_report():
    rep = t_mesh.tracker_comm_report(8, 480, 640, halo=80, capacity=4096,
                                     spacing=10, ring=8)
    assert rep == j_mesh.tracker_comm_report(8, 480, 640, halo=80,
                                             capacity=4096, spacing=10,
                                             ring=8)
    assert rep["owned_cols_per_device"] == 80
    assert rep["halo_ppermute_bytes"] == 2 * 2 * 480 * 80 * 4
    assert rep["total_comm_bytes_per_frame"] == (
        rep["halo_ppermute_bytes"] + rep["flow_psum_bytes"]
        + rep["cull_psum_bytes"] + rep["detect_allgather_bytes"])
    assert rep["ba_psum_bytes_per_iter"] == (8 * 6 * 8 * 6 + 8 * 6 + 1) * 4
    assert (t_mesh.tracker_comm_report(4, 480, 640, halo=80, capacity=4096,
                                       spacing=10, n_landmarks=1001)
            == j_mesh.tracker_comm_report(4, 480, 640, halo=80,
                                          capacity=4096, spacing=10,
                                          n_landmarks=1001))


def test_distributed_mesh_two_processes():
    """evaluation/multihost_check.py's recipe with the port: two processes
    each call ``distributed_mesh`` with a coordinator, the process count
    and their id, run the sharded flow over the 2-rank mesh, and get the
    single-device flow's bits; with no process and no ``torchrun``
    environment it is ``make_mesh`` without a group."""
    got = S.run_group(2, "torch_spmd_tracker", ["multihost"], init=False)
    f1, f2, pts = C.multihost_inputs()
    want = _port_flow(f1, f2, pts, np.ones((120,), bool))
    for res in got:
        _assert_flow(res["multihost"], want)
    assert want[2].sum() > 100
    one = t_mesh.distributed_mesh((1,), ("sp",))
    assert one.get_group("sp") is None


def test_one_rank_mesh_without_a_group():
    """A mesh of one rank runs without a process group: the ring
    degenerates to the edge fills, and the sharded flow is the
    single-device flow on the whole frame."""
    mesh = t_mesh.make_mesh((1,), ("sp",))
    assert mesh.get_group("sp") is None and mesh.get_local_rank("sp") == 0
    f1, f2 = S.scene((3, -2), w=160, h=48)
    pts = np.stack([np.arange(8, 40, 4), np.arange(40, 104, 8)],
                   -1).astype(np.float32)
    val = np.ones((len(pts),), bool)
    m, d, ok = t_st.sharded_semi_dense_flow(
        mesh, torch.from_numpy(pts), torch.from_numpy(val),
        torch.from_numpy(f1), torch.from_numpy(f2), **C.KW)
    _assert_flow((m.numpy(), d.numpy(), ok.numpy()),
                 _port_flow(f1, f2, pts, val))
    with pytest.raises(ValueError):
        t_mesh.make_mesh((2,), ("sp",))


def test_parallel_imports_neither_jax_nor_vpp_tpu():
    """``vpp_tpu_torch.parallel`` imports no module of JAX or of vpp_tpu,
    in its source or at run time."""
    pkg = ROOT / "vpp_tpu_torch" / "parallel"
    for path in pkg.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "vpp_tpu", "flax"), (
                    path.name, name)
    code = ("import sys, vpp_tpu_torch.parallel, "
            "vpp_tpu_torch.parallel.sharded_tracker\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'vpp_tpu', 'flax')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
