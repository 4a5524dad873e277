"""Synthetic clips (numpy, made from a seed).

The port's own copies of the repo's two clip recipes: the moving
box-smoothed texture that ``bench.py`` times the tracker on, and the
two-line scene of ``examples/hough_extruder_demo.py``.
"""

from __future__ import annotations

import numpy as np

from ..io.video import synthetic_clip


def make_clip(w: int, h: int, nframes: int, seed: int = 0) -> np.ndarray:
    """(nframes, h, w) float32: a 3x3 box-smoothed random texture that
    translates by one pixel per frame along both axes
    (``io.synthetic_clip`` at speed 1)."""
    return synthetic_clip(w, h, nframes, seed=seed)


def synthetic_line_clip(w: int, h: int, nframes: int) -> np.ndarray:
    """(nframes, h, w) float32: two bright lines, one translating, one
    rotating slowly."""
    frames = np.zeros((nframes, h, w), np.float32)
    for t in range(nframes):
        row = 30 + t
        frames[t, row:row + 2, :] = 200.0
        th = 0.3 + 0.01 * t
        for c in range(w):
            r = int(h / 2 + (c - w / 2) * np.tan(th))
            if 0 <= r < h:
                frames[t, r, c] = 220.0
    return frames
