"""Spatially and data-sharded front-end ops over a process mesh (port of
``vpp_tpu.parallel.sharded``).

* column-sharded stencils with an explicit halo exchange over the ``"sp"``
  axis (``exchange_cols``: ring neighbours only);
* data-parallel batched tracker steps over ``"dp"``;
* reductions by all-reduce.

Every rank calls these with the global arrays (``parallel/mesh.py``'s
convention) and gets the global result back.
"""

from __future__ import annotations

import torch

from ..algorithms.fast import fast9_score
from ..algorithms.pyramid import pyramid_streams
from ..algorithms.video_extruder import (VideoExtruderConfig,
                                         _tracker_step, video_extruder_init)
from ..core.image import from_array
from ..core.streams import lift, map_tensors
from .mesh import (Mesh, all_gather_stack, all_reduce_sum, exchange_cols,
                   shard_batch, shard_image_cols)


def halo_exchange_cols(local: torch.Tensor, halo: int, axis: str, *,
                       mesh: Mesh) -> torch.Tensor:
    """Concatenate ``halo`` columns from ring neighbours on both sides of
    this rank's (H, wl...) slice along ``axis`` of ``mesh``.

    Ring (wraparound) exchange over the mesh axis; callers mask or mirror
    the outermost shards if open boundaries are needed."""
    from_left, from_right = exchange_cols(local[:, -halo:], local[:, :halo],
                                          mesh, axis, wrap=True)
    return torch.cat([from_left, local, from_right], dim=1)


def sharded_fast9_score(mesh: Mesh, frame: torch.Tensor,
                        th: int) -> torch.Tensor:
    """Total FAST score of an (H, W) frame, columns sharded over ``"sp"``:
    each rank scores its slice (K2 on a CUDA frame) with a 3-column halo
    from its ring neighbours, then the partial sums all-reduce. Returns a
    0-d int32 tensor, the same on every rank."""
    halo = 3
    padded = halo_exchange_cols(shard_image_cols(mesh, frame, "sp"), halo,
                                "sp", mesh=mesh)
    img = from_array(padded, border=3, border_mode="mirror")
    s = fast9_score(img, th)[:, halo:-halo].sum(dtype=torch.int32)
    return all_reduce_sum(s, mesh, "sp")


def sharded_tracker_batch_step(mesh: Mesh, frames1: torch.Tensor,
                               frames2: torch.Tensor) -> torch.Tensor:
    """One tracker step per batch element from an empty state, the batch
    sharded over ``"dp"``: this rank's elements run as the streams of one
    ``_tracker_step`` (one launch of each kernel for all of them). Returns
    every element's live-keypoint count, (B,) int32 on every rank."""
    cfg = VideoExtruderConfig(capacity=64, detect_k=32, nscales=2,
                              winsize=7, keypoint_spacing=8,
                              detector_period=1)
    b = max(3, cfg.winsize)
    f1 = shard_batch(mesh, frames1, "dp")
    f2 = shard_batch(mesh, frames2, "dp")
    n = f1.shape[0]
    one = lift(video_extruder_init(cfg, device=f1.device))
    state = map_tensors(
        lambda t: t.expand((n,) + t.shape[1:]).clone(), one)
    lv1 = pyramid_streams(f1, cfg.nscales, border=b)
    lv2 = pyramid_streams(f2, cfg.nscales, border=b)
    state = _tracker_step(state, lv2[0], b, cfg, lv1, lv2, b)
    alive = state.keypoints.alive.sum(-1, dtype=torch.int32)
    return all_gather_stack(alive, mesh, "dp").reshape(-1)

