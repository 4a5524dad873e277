"""Hand-written CUDA kernels and their launch counts.

The sources are in ``csrc/``; ``_build`` compiles and loads them. Each
wrapper (in the algorithm module that owns the kernel) adds one to its
count in ``LAUNCHES`` where it launches, and nowhere else, so a run can
show that it went through the kernels:

* ``fast9``      — K2, ``algorithms/fast.py:fast9_cuda``
* ``flow_level`` — K1, ``algorithms/flow.py:flow_level`` (two per level:
  the volume launch, and the argmin/rejection/propagation launch)
* ``hough_acc``  — K7, ``algorithms/hough_cuda.py:hough_acc``
* ``block_topk`` — K3, ``algorithms/fast.py:_blockwise_keypoints`` (two
  per call: the block argmax launch, then the ranking launch)
* ``pyramid_decim`` — K4, ``algorithms/pyramid.py:_binomial_decimate``
  (one per pyramid level above level 0)
* ``patches``    — K5, ``core/interp.py:extract_patches_at_tl``
* ``ba_tracks``  — K6, ``slam/ba_cuda.py`` (four per LM iteration:
  assembly, reduction, back-substitution with the candidate's cost, and
  that cost's reduction)
"""

from __future__ import annotations

from typing import Dict

import torch

LAUNCHES: Dict[str, int] = {"fast9": 0, "flow_level": 0, "hough_acc": 0,
                            "block_topk": 0, "pyramid_decim": 0,
                            "patches": 0, "ba_tracks": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as an address."""
    return torch.cuda.current_stream(t.device).cuda_stream


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
