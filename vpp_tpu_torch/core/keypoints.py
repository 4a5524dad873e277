"""Fixed-capacity keypoint set (port of ``vpp_tpu.core.keypoints``).

A static-capacity struct of arrays: per-slot position (row, col), velocity
and age, with ``age == 0`` meaning dead. Death is a mask, ``compact`` a
stable alive-first permutation, spawn fills dead slots in slot order.

Where the JAX package scatters with ``mode="drop"`` (out-of-range indices
silently ignored), torch would raise; the port scatters into one extra
trailing slot instead and slices it off, which keeps the op free of host
synchronisation on the card. Where a JAX ``.at[i].set`` may see an index
twice, the port writes the entry that comes last in index order
(``scatter_last``), on the card as on the CPU; ``.at[i].add`` counts every
repeat (``index_put_`` with ``accumulate=True``).

Every operation also takes leading stream dimensions (fields (S, K, ...)):
each stream's slots are its own, and no scatter or compaction crosses a
stream (``core/streams.py``).
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
        return self.position.shape[-2]

    @property
    def alive(self) -> torch.Tensor:
        return self.age > 0

    def size(self) -> torch.Tensor:
        """Number of live keypoints (a 0-d tensor; (S,) for streams)."""
        return self.alive.sum(-1, dtype=torch.int32)


def keypoints_empty(capacity: int, device=None) -> Keypoints:
    return Keypoints(
        position=torch.zeros((capacity, 2), dtype=torch.float32,
                             device=device),
        velocity=torch.zeros((capacity, 2), dtype=torch.float32,
                             device=device),
        age=torch.zeros((capacity,), dtype=torch.int32, device=device))


def drop_scatter(out: torch.Tensor, index: torch.Tensor,
                 src: torch.Tensor, keep: torch.Tensor,
                 dim: int = 0) -> torch.Tensor:
    """``out.at[where(keep, index, n)].set(src, mode="drop")`` along
    ``dim``: entries with ``keep`` false are dropped. The scatter goes into
    a buffer with one spare slot that absorbs them. ``index`` and ``keep``
    broadcast to ``src``'s dimensions up to ``dim``; with ``dim`` 1 each
    leading index (a stream) scatters into its own row."""
    n = out.shape[dim]
    buf = torch.cat([out, out.narrow(dim, 0, 1)], dim=dim)
    idx = torch.where(keep, index, torch.full_like(index, n)).long()
    idx = idx.view(idx.shape + (1,) * (src.dim() - idx.dim())).expand_as(src)
    buf.scatter_(dim, idx, src.to(buf.dtype))
    return buf.narrow(dim, 0, n)


def scatter_last(out: torch.Tensor, index: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """``out.at[index].set(src, mode="drop")`` along dim 0, deterministic
    where ``index`` repeats: the entry last in index order is written.
    Indices outside [0, len(out)) are dropped; ``src`` has one row per
    index (its leading dims flattened). The winner of each row is the
    ``amax`` of the writers' positions (``scatter_reduce``), then one
    gather: no host read, the same result on the card as on the CPU."""
    n = out.shape[0]
    idx = index.reshape(-1).long()
    m = idx.numel()
    idx = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    order = torch.arange(m, device=idx.device)
    win = torch.full((n + 1,), -1, dtype=torch.int64,
                     device=idx.device).scatter_reduce(
        0, idx, order, "amax", include_self=True)[:n]
    rows = src.reshape((m,) + out.shape[1:]).to(out.dtype)
    picked = rows[win.clamp(min=0)] if m else torch.zeros_like(out)
    written = (win >= 0).view((n,) + (1,) * (out.dim() - 1))
    return torch.where(written, picked, out)


def _slot_index(i, k: int, device) -> torch.Tensor:
    """Slot index (an int or an index array) as int64, negative slots
    counted from the end as in numpy."""
    idx = torch.as_tensor(i, device=device).reshape(-1).long()
    return torch.where(idx < 0, idx + k, idx)


def keypoints_from_positions(pos: torch.Tensor,
                             valid: torch.Tensor) -> Keypoints:
    """Build from detector output; invalid slots are dead."""
    return Keypoints(position=pos.to(torch.float32),
                     velocity=torch.zeros(pos.shape, dtype=torch.float32,
                                          device=pos.device),
                     age=valid.to(torch.int32))


def kp_move(kps: Keypoints, i, new_pos) -> Keypoints:
    """Move slot(s) ``i`` to ``new_pos``: position and velocity set, age
    +1. ``i`` may be an index array; a slot named twice ages twice and
    takes the last of its new positions."""
    dev = kps.position.device
    idx = _slot_index(i, kps.capacity, dev)
    new_pos = torch.as_tensor(new_pos, dtype=torch.float32,
                              device=dev).reshape(-1, 2)
    vel = new_pos - kps.position[idx]
    age = kps.age.clone()
    age.index_put_((idx,), torch.ones_like(idx, dtype=age.dtype),
                   accumulate=True)
    return Keypoints(position=scatter_last(kps.position, idx, new_pos),
                     velocity=scatter_last(kps.velocity, idx, vel),
                     age=age)


def kp_remove(kps: Keypoints, i) -> Keypoints:
    """Kill slot(s) ``i``."""
    idx = _slot_index(i, kps.capacity, kps.age.device)
    return dataclasses.replace(kps, age=kps.age.index_fill(0, idx, 0))


def kp_move_all(kps: Keypoints, new_pos: torch.Tensor,
                ok: torch.Tensor) -> Keypoints:
    """Slots with ``ok`` move to ``new_pos`` and age; other live slots
    die."""
    alive = kps.alive
    ok = ok & alive
    pos = torch.where(ok[..., None], new_pos.to(torch.float32), kps.position)
    vel = torch.where(ok[..., None], pos - kps.position, kps.velocity)
    age = torch.where(ok, kps.age + 1,
                      torch.where(alive, torch.zeros_like(kps.age), kps.age))
    return Keypoints(position=pos, velocity=vel, age=age)


def kp_kill_where(kps: Keypoints, dead_mask: torch.Tensor) -> Keypoints:
    return dataclasses.replace(
        kps, age=torch.where(dead_mask, torch.zeros_like(kps.age), kps.age))


def _take_slots(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, :]`` per stream: (..., K, C) rows at (..., M) slots."""
    return x.gather(-2, idx[..., None].expand(idx.shape + x.shape[-1:]))


def kp_compact(kps: Keypoints) -> Tuple[Keypoints, torch.Tensor]:
    """Stable alive-first compaction, per stream. Returns (compacted,
    matches) with ``matches[old_slot] = new_slot`` or -1 if dead."""
    k = kps.age.shape[-1]
    alive = kps.alive
    order = torch.argsort((~alive).to(torch.int32), dim=-1, stable=True)
    compacted = Keypoints(position=_take_slots(kps.position, order),
                          velocity=_take_slots(kps.velocity, order),
                          age=kps.age.gather(-1, order))
    ar = torch.arange(k, dtype=torch.int32, device=alive.device)
    inv = torch.empty_like(kps.age).scatter_(-1, order,
                                             ar.expand_as(kps.age))
    matches = torch.where(alive, inv, torch.full_like(inv, -1))
    return compacted, matches


def sync_attributes(attr: torch.Tensor, matches: torch.Tensor,
                    fill_value=0) -> torch.Tensor:
    """Permute a per-keypoint array through a ``kp_compact`` mapping; new
    (unmapped) slots get ``fill_value``."""
    out = torch.full_like(attr, fill_value)
    return drop_scatter(out, matches, attr, matches >= 0,
                        dim=matches.dim() - 1)


def kp_add(kps: Keypoints, new_pos: torch.Tensor,
           new_valid: torch.Tensor) -> Keypoints:
    """Spawn up to N new keypoints into dead slots, in slot order; new
    keypoints start with age 1 and excess candidates are dropped."""
    n = new_pos.shape[-2]
    dev = kps.age.device
    dead = ~kps.alive
    dead_rank = torch.cumsum(dead.to(torch.int32), -1, dtype=torch.int32) - 1
    cand_rank = torch.cumsum(new_valid.to(torch.int32), -1,
                             dtype=torch.int32) - 1
    n_valid = new_valid.sum(-1, keepdim=True, dtype=torch.int32)
    cand_by_rank = drop_scatter(
        torch.zeros_like(cand_rank), cand_rank,
        torch.arange(n, dtype=torch.int32, device=dev).expand_as(cand_rank),
        new_valid, dim=cand_rank.dim() - 1)
    take = dead & (dead_rank < n_valid)
    src = cand_by_rank.gather(-1, dead_rank.clamp(0, n - 1).long())
    pos = torch.where(take[..., None],
                      _take_slots(new_pos.to(torch.float32), src.long()),
                      kps.position)
    vel = torch.where(take[..., None], torch.zeros_like(kps.velocity),
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
