"""3x3 Scharr gradient (port of ``vpp_tpu.algorithms.scharr``).

gr (row3 - row1) and gc (col+1 - col-1) with (3, 10, 3)/32 weights, in the
reference's component order: out[0] is the *row* gradient, out[1] the
*column* gradient. Plain tensor stencils on the image's device: the sums
are formed left to right in float32, as the JAX package writes them, and
the division by 32 is exact, so the result is the JAX package's bit for
bit.
"""

from __future__ import annotations

import torch

from ..core.image import Image2d, from_array


def scharr(img: Image2d) -> Image2d:
    """Full-image Scharr; needs border >= 1. Output channels (gr, gc)."""
    if img.border < 1:
        raise ValueError("scharr needs border >= 1")

    def n(dr, dc):
        return img.shifted(dr, dc).to(torch.float32)

    gr = (3 * n(1, -1) + 10 * n(1, 0) + 3 * n(1, 1)
          - 3 * n(-1, -1) - 10 * n(-1, 0) - 3 * n(-1, 1)) / 32.0
    gc = (3 * n(-1, 1) + 10 * n(0, 1) + 3 * n(1, 1)
          - 3 * n(-1, -1) - 10 * n(0, -1) - 3 * n(1, -1)) / 32.0
    return from_array(torch.stack([gr, gc], dim=-1))


def scharr_point(img: Image2d, p) -> torch.Tensor:
    """Single-point Scharr; p = (row, col) interior. Returns (2,) float32
    (gr, gc)."""
    b = img.border
    r, c = int(p[0]) + b, int(p[1]) + b
    d = img.data.to(torch.float32)
    gr = (3 * d[r + 1, c - 1] + 10 * d[r + 1, c] + 3 * d[r + 1, c + 1]
          - 3 * d[r - 1, c - 1] - 10 * d[r - 1, c] - 3 * d[r - 1, c + 1]) / 32.0
    gc = (3 * d[r - 1, c + 1] + 10 * d[r, c + 1] + 3 * d[r + 1, c + 1]
          - 3 * d[r - 1, c - 1] - 10 * d[r, c - 1] - 3 * d[r + 1, c - 1]) / 32.0
    return torch.stack([gr, gc])
