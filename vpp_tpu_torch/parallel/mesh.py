"""Process meshes and the collectives of the sharded paths (port of
``vpp_tpu.parallel.mesh``).

JAX's ``shard_map`` is single-controller: one program holds every device.
``torch.distributed`` runs one process a rank, so the port's sharded
functions are SPMD programs that every rank of a mesh calls with the same
arguments a JAX caller passes (global frames, replicated state). Each rank
takes its own columns, batch elements, landmarks or observations, and every
output that JAX returns replicated (``out_specs=P()``) comes back on every
rank; what JAX returns sharded over an axis is all-gathered back, so a rank
holds the whole result as a JAX caller holds a global array. Tensors stay on
the device they came in on: a CUDA tensor runs the kernels, a CPU tensor
their plain versions.

The mesh is the port's own small class, ``Mesh``, not
``torch.distributed.device_mesh.DeviceMesh``: a ``DeviceMesh`` is bound to
one device type and, for ``"cuda"``, to one card a rank, while the one-card
runs put several ranks on one card over gloo. ``Mesh`` holds, for each named
axis (``"sp"``, ``"dp"``, ``"lm"``, ``"obs"``), the process group of the
ranks that share this rank's coordinates on the other axes
(``mesh.get_group(name)``). A mesh of one rank needs no process group.

Collectives (``all_reduce_sum``, ``all_gather_stack``, ``exchange_cols``) go
through the axis's group: ``all_reduce``, an ``all_gather`` into a list
(the form every backend takes without a deprecation warning) and
``batch_isend_irecv`` for the ring. Gloo takes CUDA tensors in its
all-reduce and all-gather, but its point-to-point send and receive read the
buffer as host memory (on the H100 machine's PyTorch 2.11 a CUDA send kills
the rank): there ``exchange_cols`` copies the edges into pinned host buffers
and the received columns back, explicitly. ``collective_routes`` names the
route each collective takes; ``COMM`` counts the calls, bytes and host
seconds spent in each (a blocking gloo call includes its copies and
waits; an NCCL call returns once it is queued on the stream).
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# op -> [calls, bytes sent by this rank, host seconds]
COMM: Dict[str, List[float]] = {"all_reduce": [0, 0, 0.0],
                                "all_gather": [0, 0, 0.0],
                                "exchange": [0, 0, 0.0]}


def reset_comm_stats() -> None:
    for v in COMM.values():
        v[:] = [0, 0, 0.0]


def comm_stats() -> Dict[str, Dict[str, float]]:
    return {k: {"calls": int(v[0]), "bytes": int(v[1]), "seconds": v[2]}
            for k, v in COMM.items()}


class Mesh:
    """A named grid of ranks, row-major over ``ranks`` (global ranks of
    the default process group). ``shape`` maps each axis name to its size,
    as JAX's ``Mesh.shape`` does."""

    def __init__(self, shape: Tuple[int, ...], names: Tuple[str, ...],
                 ranks: Sequence[int]):
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} and names {names} differ "
                             "in length")
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.ranks = np.asarray(list(ranks), dtype=np.int64).reshape(shape)
        rank = dist.get_rank() if dist.is_initialized() else 0
        where = np.argwhere(self.ranks == rank)
        # this rank's coordinates (None: a rank the mesh leaves out)
        self.coords = tuple(int(c) for c in where[0]) if len(where) else None
        self._groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        for ax, name in enumerate(self.axis_names):
            self._groups[name] = self._axis_group(ax)

    def _axis_group(self, ax: int):
        """The group of this rank's line along axis ``ax``. Every rank of the
        world creates every line's group, in one order, as ``new_group``
        requires; a line that is the whole world reuses the default
        group."""
        if not dist.is_initialized():
            return None
        world = dist.get_world_size()
        mine = None
        others = [range(s) for i, s in enumerate(self.ranks.shape)
                  if i != ax]
        for rest in itertools.product(*others):
            idx = list(rest)
            idx.insert(ax, slice(None))
            line = [int(r) for r in self.ranks[tuple(idx)]]
            if line == list(range(world)):
                group = dist.group.WORLD
            else:
                group = dist.new_group(line)
            if dist.get_rank() in line:
                mine = group
        return mine

    def size(self, name: str) -> int:
        return self.shape[name]

    def get_group(self, name: str):
        """The process group of ``name`` (None on a mesh of one rank run
        without a process group)."""
        return self._groups[name]

    def get_local_rank(self, name: str) -> int:
        """This rank's index along ``name``."""
        if self.coords is None:
            raise ValueError("this rank is not in the mesh")
        return self.coords[self.axis_names.index(name)]


def make_mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the first ``prod(shape)`` of ``devices`` (global ranks;
    default every rank in order), as JAX's over the first devices. Every
    rank of the default group calls it; a mesh of one rank also runs
    without a process group."""
    n = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(devices) if devices is not None else list(range(world))
    if len(ranks) < n:
        raise ValueError(f"need {n} ranks, have {len(ranks)}")
    if not dist.is_initialized() and n != 1:
        raise ValueError(f"a mesh of {n} ranks needs an initialised "
                         "process group (distributed_mesh)")
    return Mesh(shape, names, ranks[:n])


def shard_image_cols(mesh: Mesh, arr: torch.Tensor,
                     axis: str = "sp") -> torch.Tensor:
    """This rank's column block of an (H, W...) array sharded over
    ``axis`` (W divisible by the axis size)."""
    n, r = mesh.size(axis), mesh.get_local_rank(axis)
    w = arr.shape[1]
    if w % n:
        raise ValueError(f"{w} columns do not shard over {n} ranks")
    return arr[:, r * (w // n):(r + 1) * (w // n)]


def shard_batch(mesh: Mesh, arr: torch.Tensor,
                axis: str = "dp") -> torch.Tensor:
    """This rank's block of the leading (batch) dimension."""
    n, r = mesh.size(axis), mesh.get_local_rank(axis)
    b = arr.shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} does not shard over {n} ranks")
    return arr[r * (b // n):(r + 1) * (b // n)]


def distributed_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], *,
                     coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Mesh:
    """Multi-process mesh: initialise the default process group, then
    ``make_mesh`` over every rank. ``coordinator`` is ``host:port`` (or a
    ``tcp://``/``file://`` URL) of rank 0, ``num_processes`` the world size
    and ``process_id`` this rank. With none of the three, the environment
    that ``torchrun`` sets is read (``env://``) where it names more than one
    process. With one process nothing is initialised and this is
    ``make_mesh``. The group takes ``init_process_group``'s default
    backends, gloo for CPU tensors and NCCL for CUDA ones; NCCL refuses two
    ranks of one communicator on one GPU, so several ranks on one card
    initialise a gloo group themselves and call ``make_mesh``.

        # host 0 and host 1, one process each:
        mesh = distributed_mesh((16,), ("sp",), coordinator="HOST0:8476",
                                num_processes=2, process_id=RANK)
    """
    if not dist.is_initialized():
        if num_processes is not None and num_processes > 1:
            url = coordinator if "://" in coordinator else (
                f"tcp://{coordinator}")
            dist.init_process_group(init_method=url,
                                    world_size=num_processes,
                                    rank=process_id)
        elif (coordinator is None and num_processes is None
              and process_id is None
              and int(os.environ.get("WORLD_SIZE", "1")) > 1):
            dist.init_process_group(init_method="env://")
    return make_mesh(shape, names)


def _backend(group, device: torch.device) -> str:
    """The backend that carries ``device``'s tensors in ``group``."""
    b = str(dist.get_backend(group))
    if ":" not in b:
        return b
    table = dict(part.split(":") for part in b.split(","))
    return table.get(device.type, next(iter(table.values())))


def _staged(group, device: torch.device) -> bool:
    """Point-to-point on gloo with CUDA tensors goes through host buffers."""
    return device.type == "cuda" and _backend(group, device) == "gloo"


def collective_routes(mesh: Mesh, axis: str,
                      device: torch.device) -> Dict[str, str]:
    """Backend and route of each collective on ``axis`` for ``device``'s
    tensors."""
    group = mesh.get_group(axis)
    if group is None:
        return {k: "none (one rank)" for k in COMM}
    b = _backend(group, torch.device(device))
    ring = ("staged through pinned host buffers"
            if _staged(group, torch.device(device)) else "direct")
    return {"all_reduce": f"{b}, direct", "all_gather": f"{b}, direct",
            "exchange": f"{b} batch_isend_irecv, {ring}"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``t`` over ``axis`` on every rank (in place; returns
    ``t``). Every rank gets the same bits."""
    group = mesh.get_group(axis)
    if group is None:
        return t
    t0 = time.perf_counter()
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    stat = COMM["all_reduce"]
    stat[0] += 1
    stat[1] += _nbytes(t)
    stat[2] += time.perf_counter() - t0
    return t


def all_gather_stack(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, stacked in rank order: (n, ...)."""
    group = mesh.get_group(axis)
    if group is None:
        return t[None]
    t0 = time.perf_counter()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, t, group=group)
    out = torch.stack(parts)
    stat = COMM["all_gather"]
    stat[0] += 1
    stat[1] += _nbytes(t)
    stat[2] += time.perf_counter() - t0
    return out


def exchange_cols(send_right: torch.Tensor, send_left: torch.Tensor,
                  mesh: Mesh, axis: str, wrap: bool
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One hop along ``axis``: each rank sends ``send_right`` to its right
    neighbour and ``send_left`` to its left one, and returns (from_left,
    from_right), what its neighbours sent it. ``wrap`` closes the ring; an
    open line leaves the outermost ranks' missing sides None. One
    ``batch_isend_irecv``; on gloo, CUDA tensors are staged through pinned
    host buffers (gloo's send and receive read host memory only)."""
    n, r = mesh.size(axis), mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    if n == 1:
        return ((send_right, send_left) if wrap else (None, None))
    t0 = time.perf_counter()
    dev = send_right.device
    staged = _staged(group, dev)

    def buf(like):
        return torch.empty(like.shape, dtype=like.dtype,
                           device="cpu" if staged else dev,
                           pin_memory=staged)

    def out(t):
        if not staged:
            return t.contiguous()
        b = buf(t)
        b.copy_(t)
        return b

    left = (r - 1) % n if (wrap or r > 0) else None
    right = (r + 1) % n if (wrap or r < n - 1) else None
    ops, recv = [], {}
    peer = lambda i: dist.get_global_rank(group, i)  # noqa: E731
    # tag 0 travels rightward, tag 1 leftward: with two ranks both
    # neighbours are one rank, and the tags keep the two messages apart
    if right is not None:
        ops.append(dist.P2POp(dist.isend, out(send_right), peer(right),
                              group, tag=0))
        recv["right"] = buf(send_left)
        ops.append(dist.P2POp(dist.irecv, recv["right"], peer(right),
                              group, tag=1))
    if left is not None:
        recv["left"] = buf(send_right)
        ops.append(dist.P2POp(dist.irecv, recv["left"], peer(left),
                              group, tag=0))
        ops.append(dist.P2POp(dist.isend, out(send_left), peer(left),
                              group, tag=1))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    got = {k: v.to(dev, non_blocking=True) if staged else v
           for k, v in recv.items()}
    stat = COMM["exchange"]
    stat[0] += 1
    stat[1] += (_nbytes(send_right) * (right is not None)
                + _nbytes(send_left) * (left is not None))
    stat[2] += time.perf_counter() - t0
    return got.get("left"), got.get("right")


def tracker_comm_report(n_devices: int, h: int, w: int, *, halo: int,
                        capacity: int, spacing: int, ring: int = 8,
                        n_landmarks: Optional[int] = None,
                        dtype_bytes: int = 4) -> dict:
    """Per-device work / per-frame communication volumes for the sharded
    tracker + landmark-sharded BA — the quantities a scaling-efficiency
    measurement compares against wall clock once multi-host hardware
    exists. All entries in bytes (per device, per frame or per BA
    iteration) except the counts.

    Communication inventory (see parallel/sharded_tracker.py and
    slam/ba.py):
      * halo ppermute: 2 neighbour exchanges of (H, halo) frame columns,
        x2 frames per step;
      * flow psum: match (K, 2) f32 + distance (K,) f32 + matched (K,) i32;
      * cull psum: scores (K,) i32;
      * detect all_gather: one (score i32, pos 2xi32) candidate per
        ``spacing`` block of the owned columns;
      * BA psum per iteration: S (R, 6, R, 6) + rhs (R, 6) + cost, f32.
    """
    wl = w // n_devices
    n_blocks_local = (-(-h // spacing)) * (wl // spacing)
    k = capacity
    report = {
        "n_devices": n_devices,
        "owned_cols_per_device": wl,
        "pixels_per_device": h * wl,
        "halo_ppermute_bytes": 2 * 2 * h * halo * dtype_bytes,
        "flow_psum_bytes": k * (2 * 4 + 4 + 4),
        "cull_psum_bytes": k * 4,
        "detect_allgather_bytes": n_blocks_local * 3 * 4,
        "ba_psum_bytes_per_iter": (ring * 6 * ring * 6 + ring * 6 + 1) * 4,
    }
    if n_landmarks is not None:
        report["landmarks_per_device"] = -(-n_landmarks // n_devices)
    report["total_comm_bytes_per_frame"] = (
        report["halo_ppermute_bytes"] + report["flow_psum_bytes"]
        + report["cull_psum_bytes"] + report["detect_allgather_bytes"])
    return report
