"""Static neighbourhood windows (port of ``vpp_tpu.ops.window``).

``C4``/``C5``/``C8``/``C9`` are the classic connectivity offset sets, in
the JAX module's order. ``window_stack`` gathers every neighbour of every
pixel at once as one stacked tensor: the vectorised form of
``foreach(window) | f``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..core.image import Image2d

# Offsets (dr, dc).
C4: List[Tuple[int, int]] = [(-1, 0), (0, -1), (0, 1), (1, 0)]
C5: List[Tuple[int, int]] = [(-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)]
C8: List[Tuple[int, int]] = [(-1, -1), (-1, 0), (-1, 1),
                             (0, -1), (0, 1),
                             (1, -1), (1, 0), (1, 1)]
C9: List[Tuple[int, int]] = [(-1, -1), (-1, 0), (-1, 1),
                             (0, -1), (0, 0), (0, 1),
                             (1, -1), (1, 0), (1, 1)]


def window_foreach(window, fn):
    """Host-side iteration over the window's offsets."""
    for off in window:
        fn(off)


def window_stack(img: Image2d, window) -> torch.Tensor:
    """Every neighbour view stacked: (len(window), H, W[, C]). A reduction
    over axis 0 is then one pass (the min over ``C8`` is an erosion)."""
    return torch.stack([img.shifted(dr, dc) for dr, dc in window], dim=0)
