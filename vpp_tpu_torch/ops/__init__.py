"""Image operators (port of ``vpp_tpu.ops``): the loop constructs, the
windows, the ordered scans, the global reductions, the LIIE expression
language and the colorspace conversions."""

from .pixel_wise import (pixel_wise, relative_access, RelAccess, Coords,
                         block_wise, row_wise)
from .window import C4, C5, C8, C9, window_stack, window_foreach
from .scan import (scan_left_to_right, scan_right_to_left,
                   scan_top_to_bottom, scan_bottom_to_top,
                   directional_pixel_wise)
from .reductions import sum_, min_, max_, avg, argmin, argmax
from .expr import (P1, P2, P3, P4, V, if_, evaluate, sum_of, min_of, max_of,
                   avg_of, argmin_of, argmax_of)
from .color import rgb_to_graylevel, graylevel_to_rgb, hsv_to_rgb

__all__ = [
    "pixel_wise", "relative_access", "RelAccess", "Coords", "block_wise",
    "row_wise", "C4", "C5", "C8", "C9", "window_stack", "window_foreach",
    "scan_left_to_right", "scan_right_to_left", "scan_top_to_bottom",
    "scan_bottom_to_top", "directional_pixel_wise", "sum_", "min_", "max_",
    "avg", "argmin", "argmax", "P1", "P2", "P3", "P4", "V", "if_", "evaluate",
    "sum_of", "min_of", "max_of", "avg_of", "argmin_of", "argmax_of",
    "rgb_to_graylevel", "graylevel_to_rgb", "hsv_to_rgb",
]
