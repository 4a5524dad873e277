"""Hand-written CUDA kernels and their launch counts.

The sources are in ``csrc/``; ``_build`` compiles and loads them. Each
wrapper (in the algorithm module that owns the kernel) adds one to its
count in ``LAUNCHES`` where it launches, and nowhere else, so a run can
show that it went through the kernels:

* ``fast9``      — K2, every launch of ``algorithms/fast.py``'s three
  entries: ``fast9_cuda`` (full map), ``score_image`` (behind
  ``fast9_score_image``) and ``cull_scores`` (behind ``fast9_cull_scores``)
* ``flow_level`` — K1, ``algorithms/flow.py:flow_level`` (two per level:
  the volume launch, and the argmin/rejection/propagation launch)
* ``hough_acc``  — K7, ``algorithms/hough_cuda.py:hough_acc`` (one
  cooperative launch per call)
* ``block_topk`` — K3, ``algorithms/fast.py:block_topk`` (behind
  ``_blockwise_keypoints``; one cooperative launch per call)
* ``pyramid_decim`` — K4, ``algorithms/pyramid.py:_k4_streams`` (one launch
  per float32 pyramid on the card, every level included, or per S of them
  through ``pyramid_streams``; one per level through ``decimate_level``)
* ``patches``    — K5, ``core/interp.py:extract_patches`` (from centres)
  and ``extract_patches_at_tl``
* ``ba_tracks``  — K6, ``slam/ba_cuda.py:lm_tracks`` (one cluster launch
  per ``ba_solve_tracks`` call, every LM iteration included)
* ``map_vote``   — K8, ``slam/map_vote.py:map_vote_pnp`` (one cluster
  launch per call: every match set's vote rounds, pick, gate and both PnP
  solves; one a recovery keyframe, one a ``relocalize``)
* ``ba_generic`` — K9, ``slam/ba_generic_cuda.py:lm_generic`` (behind
  ``ba_solve_tracks`` on the generic layout, and on a ring of more poses
  than K6 takes: one cooperative launch a call, every LM iteration and
  its band pose solve included)
* ``lk_level``   — K10, ``algorithms/lk.py:lk_levels`` (one launch for a
  whole coarse-to-fine pass: one a ``lucas_kanade``, ``pyrlk_match`` or
  ``sparse_optical_flow`` call; ``lk_level`` and ``lk_match_batch`` on
  CUDA images ask it for one level, one launch)
* ``jfa``        — K11, ``algorithms/distance_transform.py:_launch_k11``
  (one cooperative launch an ``euclidean_distance_transform``, every pass
  included; ``jfa_pass`` asks it for one pass, one launch)

K1-K6 also take S streams in one launch (the stream in the grid): a run
of ``slam_run_streams`` counts the launches of one stream.
"""

from __future__ import annotations

from typing import Dict

import torch

LAUNCHES: Dict[str, int] = {"fast9": 0, "flow_level": 0, "hough_acc": 0,
                            "block_topk": 0, "pyramid_decim": 0,
                            "patches": 0, "ba_tracks": 0, "map_vote": 0,
                            "ba_generic": 0, "lk_level": 0, "jfa": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as an address: the
    raw handle, without the ``torch.cuda.Stream`` object that
    ``torch.cuda.current_stream`` builds on every call."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def require_cuda(name: str, *tensors: torch.Tensor, dtypes) -> None:
    """Check the kernel's operands: CUDA, one device, contiguous, typed."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: operand {i} on {t.device}, expected "
                             f"{dev} (CUDA)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand {i} is not contiguous")
        if t.dtype != dtypes[i]:
            raise ValueError(f"{name}: operand {i} is {t.dtype}, expected "
                             f"{dtypes[i]}")
