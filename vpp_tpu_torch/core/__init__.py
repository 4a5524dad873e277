"""Core containers: boxes, bordered images, border fills, keypoint sets."""

from .box import Box2d, make_box2d
from .image import Image2d, image2d, from_array
from .border import (fill, fill_with_border, fill_border_with_value,
                     fill_border_mirror, fill_border_closest, clone)
from .interp import bilinear, nearest, extract_patches, extract_patches_bilinear

__all__ = [
    "Box2d", "make_box2d", "Image2d", "image2d", "from_array", "fill",
    "fill_with_border", "fill_border_with_value", "fill_border_mirror",
    "fill_border_closest", "clone", "bilinear", "nearest", "extract_patches",
    "extract_patches_bilinear",
]
