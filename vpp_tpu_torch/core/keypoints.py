"""Fixed-capacity keypoint set (port of ``vpp_tpu.core.keypoints``).

A static-capacity struct of arrays: per-slot position (row, col), velocity
and age, with ``age == 0`` meaning dead. Death is a mask, ``compact`` a
stable alive-first permutation, spawn fills dead slots in slot order.

Where the JAX package scatters with ``mode="drop"`` (out-of-range indices
silently ignored), torch would raise; the port scatters into one extra
trailing slot instead and slices it off, which keeps the op free of host
synchronisation on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class Keypoints:
    """SoA keypoint set of static capacity K."""

    position: torch.Tensor   # (K, 2) float32, (row, col)
    velocity: torch.Tensor   # (K, 2) float32
    age: torch.Tensor        # (K,) int32; 0 = dead

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    @property
    def alive(self) -> torch.Tensor:
        return self.age > 0

    def size(self) -> torch.Tensor:
        """Number of live keypoints (a 0-d tensor)."""
        return self.alive.sum(dtype=torch.int32)


def keypoints_empty(capacity: int, device=None) -> Keypoints:
    return Keypoints(
        position=torch.zeros((capacity, 2), dtype=torch.float32,
                             device=device),
        velocity=torch.zeros((capacity, 2), dtype=torch.float32,
                             device=device),
        age=torch.zeros((capacity,), dtype=torch.int32, device=device))


def drop_scatter(out: torch.Tensor, index: torch.Tensor,
                 src: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``out.at[where(keep, index, n)].set(src, mode="drop")`` along dim 0:
    entries with ``keep`` false are dropped. The scatter goes into a
    buffer with one spare slot that absorbs them."""
    n = out.shape[0]
    buf = torch.cat([out, out[:1]], dim=0)
    idx = torch.where(keep, index, torch.full_like(index, n)).long()
    idx = idx.view((-1,) + (1,) * (src.dim() - 1)).expand_as(src)
    buf.scatter_(0, idx, src.to(buf.dtype))
    return buf[:n]


def kp_move_all(kps: Keypoints, new_pos: torch.Tensor,
                ok: torch.Tensor) -> Keypoints:
    """Slots with ``ok`` move to ``new_pos`` and age; other live slots
    die."""
    alive = kps.alive
    ok = ok & alive
    pos = torch.where(ok[:, None], new_pos.to(torch.float32), kps.position)
    vel = torch.where(ok[:, None], pos - kps.position, kps.velocity)
    age = torch.where(ok, kps.age + 1,
                      torch.where(alive, torch.zeros_like(kps.age), kps.age))
    return Keypoints(position=pos, velocity=vel, age=age)


def kp_kill_where(kps: Keypoints, dead_mask: torch.Tensor) -> Keypoints:
    return dataclasses.replace(
        kps, age=torch.where(dead_mask, torch.zeros_like(kps.age), kps.age))


def kp_compact(kps: Keypoints) -> Tuple[Keypoints, torch.Tensor]:
    """Stable alive-first compaction. Returns (compacted, matches) with
    ``matches[old_slot] = new_slot`` or -1 if dead."""
    k = kps.capacity
    alive = kps.alive
    order = torch.argsort((~alive).to(torch.int32), stable=True)
    compacted = Keypoints(position=kps.position[order],
                          velocity=kps.velocity[order], age=kps.age[order])
    inv = torch.empty((k,), dtype=torch.int32, device=alive.device)
    inv[order] = torch.arange(k, dtype=torch.int32, device=alive.device)
    matches = torch.where(alive, inv, torch.full_like(inv, -1))
    return compacted, matches


def sync_attributes(attr: torch.Tensor, matches: torch.Tensor,
                    fill_value=0) -> torch.Tensor:
    """Permute a per-keypoint array through a ``kp_compact`` mapping; new
    (unmapped) slots get ``fill_value``."""
    out = torch.full_like(attr, fill_value)
    return drop_scatter(out, matches, attr, matches >= 0)


def kp_add(kps: Keypoints, new_pos: torch.Tensor,
           new_valid: torch.Tensor) -> Keypoints:
    """Spawn up to N new keypoints into dead slots, in slot order; new
    keypoints start with age 1 and excess candidates are dropped."""
    n = new_pos.shape[0]
    dev = kps.age.device
    dead = ~kps.alive
    dead_rank = torch.cumsum(dead.to(torch.int32), 0, dtype=torch.int32) - 1
    cand_rank = torch.cumsum(new_valid.to(torch.int32), 0,
                             dtype=torch.int32) - 1
    n_valid = new_valid.sum(dtype=torch.int32)
    cand_by_rank = drop_scatter(
        torch.zeros((n,), dtype=torch.int32, device=dev), cand_rank,
        torch.arange(n, dtype=torch.int32, device=dev), new_valid)
    take = dead & (dead_rank < n_valid)
    src = cand_by_rank[dead_rank.clamp(0, n - 1).long()]
    pos = torch.where(take[:, None], new_pos.to(torch.float32)[src.long()],
                      kps.position)
    vel = torch.where(take[:, None], torch.zeros_like(kps.velocity),
                      kps.velocity)
    age = torch.where(take, torch.ones_like(kps.age), kps.age)
    return Keypoints(position=pos, velocity=vel, age=age)


def occupancy_grid(kps: Keypoints, shape: Tuple[int, int],
                   cell: int = 1) -> torch.Tensor:
    """(ceil(H/cell), ceil(W/cell)) int32 grid of slot ids (+1), 0 = empty;
    the largest slot id wins collisions."""
    h, w = shape
    gh, gw = -(-h // cell), -(-w // cell)
    r = (kps.position[:, 0] / cell).to(torch.int32).clamp(0, gh - 1)
    c = (kps.position[:, 1] / cell).to(torch.int32).clamp(0, gw - 1)
    ids = torch.where(kps.alive,
                      torch.arange(1, kps.capacity + 1, dtype=torch.int32,
                                   device=r.device),
                      torch.zeros_like(kps.age))
    grid = torch.zeros((gh * gw,), dtype=torch.int32, device=r.device)
    grid.scatter_reduce_(0, (r * gw + c).long(), ids, "amax",
                         include_self=True)
    return grid.view(gh, gw)
