"""Sparse optical flow: detect in both frames, match, refine with LK (port
of ``vpp_tpu.algorithms.sparse_flow``).

1. FAST9 keypoints on both frames (blockwise budgets, fixed capacity): K2
   and K3 on the card;
2. 7x7 patch descriptors (K5) matched within a spatial search radius: one
   masked (K1, K2) SAD table and a row argmin (``matcher.local_match``);
3. sub-pixel Lucas-Kanade refinement of each matched displacement
   (``lk.lucas_kanade``: K4 and K10), kept where it stays within
   ``max_refine`` px of the descriptor match.

A query with no candidate in the radius matches train index 0 (the
argmin of an all-``_INF`` row) and is not ``valid``, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.image import Image2d
from ..core.interp import extract_patches
from .fast import fast9
from .lk import lucas_kanade
from .matcher import local_match


class SparseFlow(NamedTuple):
    pos1: torch.Tensor      # (K, 2) float32 keypoints in frame 1
    pos2: torch.Tensor      # (K, 2) float32 matched + refined positions
    distance: torch.Tensor  # (K,) descriptor distance of the match
    valid: torch.Tensor     # (K,) bool


def sparse_optical_flow(i1: Image2d, i2: Image2d, *,
                        detector_th: int = 10, k: int = 512,
                        block_size: int = 10, patch_radius: int = 3,
                        search_radius: float = 30.0,
                        winsize: int = 11, nscales: int = 3,
                        max_refine: float = 3.0) -> SparseFlow:
    """Match FAST keypoints between two frames; a SparseFlow of static
    capacity ``k``. ``max_refine`` caps how far the LK refinement may move
    a match (px) before falling back to the descriptor match."""
    pos1, _, ok1 = fast9(i1, detector_th, k=k, blockwise=True,
                         block_size=block_size)
    pos2, _, ok2 = fast9(i2, detector_th, k=k, blockwise=True,
                         block_size=block_size)
    side = 2 * patch_radius + 1
    d1 = extract_patches(i1.data, pos1 + i1.border, side).reshape(k, -1)
    d2 = extract_patches(i2.data, pos2 + i2.border, side).reshape(k, -1)
    p1 = pos1.to(torch.float32)
    idx, dist, found = local_match(
        d1, p1, d2, pos2.to(torch.float32), search_radius=search_radius,
        distance="sad", query_valid=ok1, train_valid=ok2)
    p2 = pos2[idx.long()].to(torch.float32)
    flow, err = lucas_kanade(i1, i2, p1, winsize=winsize, nscales=nscales,
                             prediction=p2 - p1)
    refined = p1 + flow
    keep_lk = ((torch.linalg.vector_norm(refined - p2, dim=1) <= max_refine)
               & (err < 1e30))
    p2 = torch.where(keep_lk[:, None], refined, p2)
    return SparseFlow(pos1=p1, pos2=p2, distance=dist, valid=found)
