"""Descriptor matching: bruteforce and spatially local matchers (port of
``vpp_tpu.algorithms.matcher``).

One dense (Q, T) distance table, then a row argmin: SAD as a broadcast
reduction, squared L2 through the ``|a|² - 2ab + |b|²`` expansion (one
``torch.matmul``, as the JAX package leaves it to XLA's product) and
Hamming through bit expansion and one product. Spatial locality is a mask
on the table (Chebyshev radius), not a grid walk. ``torch.argmin`` takes
the first minimum, as ``jnp.argmin`` does, so a row with no candidate
(all ``_INF``) gives index 0.

SAD and Hamming of integer-valued descriptors sum integers below 2^24 in
float32, so they are exact in any order: the tables equal the JAX
package's bit for bit. All of it is plain PyTorch on the operands' device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# np.float32(3.4e38) as a Python float: a comparison in any precision
# then sees the float32 value the table holds
_INF = 3.3999999521443642e+38


# -- distance kernels -------------------------------------------------------

def sad_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of absolute differences between (D,) descriptors (float32)."""
    return (a.to(torch.float32) - b.to(torch.float32)).abs().sum()


def _unpackbits(x: torch.Tensor) -> torch.Tensor:
    """``np.unpackbits`` along the last axis (most significant bit first)
    of a uint8 tensor: (..., D) -> (..., 8 D) uint8."""
    x = x.to(torch.uint8)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=x.device)
    bits = (x[..., None] >> shifts) & 1
    return bits.reshape(x.shape[:-1] + (x.shape[-1] * 8,))


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Popcount Hamming distance between uint8 descriptor vectors (int32)."""
    x = torch.as_tensor(a).to(torch.uint8) ^ torch.as_tensor(b).to(
        torch.uint8)
    return _unpackbits(x.reshape(-1)).sum(dtype=torch.int32)


def _pairwise_sad(query: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """(Q, T) SAD table by broadcast."""
    q = query.to(torch.float32)[:, None, :]
    t = train.to(torch.float32)[None, :, :]
    return (q - t).abs().sum(-1)


def _pairwise_l2sq(query: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """(Q, T) squared L2 via the product expansion."""
    q = query.to(torch.float32)
    t = train.to(torch.float32)
    qq = (q * q).sum(1, keepdim=True)
    tt = (t * t).sum(1)[None, :]
    return torch.clamp(qq - 2.0 * (q @ t.T) + tt, min=0.0)


def _pairwise_hamming(query: torch.Tensor,
                      train: torch.Tensor) -> torch.Tensor:
    """(Q, T) Hamming: popcount(a) + popcount(b) - 2 a_bits . b_bits."""
    qb = _unpackbits(query).to(torch.float32)
    tb = _unpackbits(train).to(torch.float32)
    qc = qb.sum(1, keepdim=True)
    tc = tb.sum(1)[None, :]
    return qc + tc - 2.0 * (qb @ tb.T)


_PAIRWISE = {"sad": _pairwise_sad, "l2": _pairwise_l2sq,
             "hamming": _pairwise_hamming}


def pairwise_distances(query: torch.Tensor, train: torch.Tensor,
                       distance: str = "sad") -> torch.Tensor:
    """Dense (Q, T) distance table for ``distance`` in {'sad', 'l2',
    'hamming'} ('l2' is squared L2)."""
    return _PAIRWISE[distance](query, train)


def _best(d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row argmin (first minimum) as int32 and its value."""
    idx = torch.argmin(d, dim=1)
    return idx.to(torch.int32), d.gather(1, idx[:, None])[:, 0]


# -- matchers ---------------------------------------------------------------

def bruteforce_match(query: torch.Tensor, train: torch.Tensor, *,
                     distance: str = "sad",
                     train_block: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best train match per query: (indices (Q,) int32, distances (Q,)
    float32). With ``train_block``, the train set is taken in blocks of
    that many rows (the last zero-padded and masked): each block's first
    minimum, then the first block holding the best, as the JAX package's
    ``lax.map`` over blocks does."""
    pw = _PAIRWISE[distance]
    t = train.shape[0]
    if train_block is None or t <= train_block:
        return _best(pw(query, train))
    idxs, dists = [], []
    for start in range(0, t, train_block):
        blk = train[start:start + train_block]
        if blk.shape[0] < train_block:
            pad = torch.zeros((train_block - blk.shape[0],)
                              + tuple(train.shape[1:]), dtype=train.dtype,
                              device=train.device)
            blk = torch.cat([blk, pad])
        d = pw(query, blk)
        valid = torch.arange(start, start + train_block,
                             device=d.device) < t
        i, di = _best(torch.where(valid[None, :], d,
                                  torch.full_like(d, _INF)))
        idxs.append(start + i)
        dists.append(di)
    idxs, dists = torch.stack(idxs), torch.stack(dists)       # (B, Q)
    best_b = torch.argmin(dists, dim=0)
    return (idxs.gather(0, best_b[None])[0],
            dists.gather(0, best_b[None])[0])


def local_match(query: torch.Tensor, query_pos: torch.Tensor,
                train: torch.Tensor, train_pos: torch.Tensor, *,
                search_radius: float = 300.0, distance: str = "sad",
                query_valid: Optional[torch.Tensor] = None,
                train_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spatially local best match: only train descriptors within
    ``search_radius`` (Chebyshev) of the query position compete. Returns
    (indices, distances, found); ``found`` is False where no candidate lay
    in the radius (index 0 there, distance ``_INF``)."""
    d = _PAIRWISE[distance](query, train)
    dp = (query_pos.to(torch.float32)[:, None, :]
          - train_pos.to(torch.float32)[None, :, :]).abs().amax(-1)
    ok = dp <= search_radius
    if train_valid is not None:
        ok = ok & train_valid[None, :]
    idx, best = _best(torch.where(ok, d, torch.full_like(d, _INF)))
    found = best < _INF
    if query_valid is not None:
        found = found & query_valid
    return idx, best, found


def cross_check_match(query: torch.Tensor, train: torch.Tensor, *,
                      distance: str = "sad"
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mutual-best filtering: (forward indices, distances, mutual)."""
    d = _PAIRWISE[distance](query, train)
    fwd, best = _best(d)
    bwd = torch.argmin(d, dim=0).to(torch.int32)
    mutual = bwd[fwd.long()] == torch.arange(query.shape[0],
                                             dtype=torch.int32,
                                             device=d.device)
    return fwd, best, mutual
