"""Drawing: rasterisation primitives (``draw.py``) and the Hough track
painter (``hough_paint.py``)."""

from .draw import (draw_line, draw_square, draw_trajectories, plot_color,
                   RGB_COLORS)

__all__ = ["draw_line", "draw_square", "draw_trajectories", "plot_color",
           "RGB_COLORS"]
