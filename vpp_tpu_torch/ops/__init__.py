"""Image operators. So far the colorspace conversions; the pixel-wise,
window, scan, reduction and expression operators of ``vpp_tpu.ops`` are
still to port (``ROADMAP.md`` queue 1)."""

from .color import rgb_to_graylevel, graylevel_to_rgb, hsv_to_rgb

__all__ = ["rgb_to_graylevel", "graylevel_to_rgb", "hsv_to_rgb"]
