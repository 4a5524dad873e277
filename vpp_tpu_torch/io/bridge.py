"""Host array interop, the OpenCV-bridge capability (port of
``vpp_tpu.io.bridge``).

OpenCV's Mats are numpy arrays in Python, so the bridge is a bordered
wrap and a copy to the device (``from_numpy``) and the interior's copy
back (``to_numpy``).
"""

from __future__ import annotations

import numpy as np

from .._device import resolve_device
from ..core.image import Image2d, from_array


def from_numpy(a: np.ndarray, border: int = 0,
               border_mode: str = "mirror", device="cuda") -> Image2d:
    """Host array -> Image2d on ``device`` (the card unless asked for the
    CPU) with a materialised border."""
    return from_array(a, border=border,
                      border_mode=border_mode if border else "zero",
                      device=resolve_device(device))


def to_numpy(img: Image2d) -> np.ndarray:
    """Image2d -> host array (the interior only)."""
    return img.to_numpy()


# cv2 Mats are numpy arrays; these aliases keep the reference's API names.
from_opencv = from_numpy
to_opencv = to_numpy
