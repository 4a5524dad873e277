"""Local binary patterns (port of ``vpp_tpu.algorithms.lbp``).

Bit order of the reference: bits 0..7 are the 8-neighbourhood in row-major
order skipping the centre — (-1,-1),(-1,0),(-1,+1),(0,-1),(0,+1),(+1,-1),
(+1,0),(+1,+1). A neighbour strictly greater than the centre sets its bit.
Plain tensor code on the image's device; the Hamming distance is the SWAR
popcount on uint8.
"""

from __future__ import annotations

import torch

from ..core.image import Image2d, from_array

_OFFSETS = [(-1, -1), (-1, 0), (-1, 1),
            (0, -1), (0, 1),
            (1, -1), (1, 0), (1, 1)]


def lbp_transform(img: Image2d) -> Image2d:
    """8-bit LBP code per pixel (uint8); needs border >= 1."""
    if img.border < 1:
        raise ValueError("lbp_transform needs border >= 1")
    center = img.interior
    code = torch.zeros(center.shape[:2], dtype=torch.uint8,
                       device=img.device)
    for bit, (dr, dc) in enumerate(_OFFSETS):
        code = code | ((img.shifted(dr, dc) > center).to(torch.uint8)
                       << bit)
    return from_array(code)


def lbp_hamming_distance(a, b) -> torch.Tensor:
    """Popcount Hamming distance between LBP codes, elementwise over arrays
    of uint8 codes; int32."""
    x = (torch.as_tensor(a) ^ torch.as_tensor(b)).to(torch.uint8)
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return ((x + (x >> 4)) & 0x0F).to(torch.int32)
