"""Core containers: boxes, bordered 2-D and N-d images, border fills,
keypoint sets."""

from .box import Box2d, make_box2d
from .image import Image2d, image2d, from_array, pad_to_multiple
from .imagend import (BoxNd, ImageNd, from_array_nd, image3d, imagend,
                      make_box3d, make_boxNd)
from .border import (fill, fill_with_border, fill_border_with_value,
                     fill_border_mirror, fill_border_closest, copy,
                     copy_with_border, clone)
from .interp import (bilinear, bilinear_image, nearest, extract_patches,
                     extract_patches_bilinear)

__all__ = [
    "Box2d", "make_box2d", "Image2d", "image2d", "from_array",
    "BoxNd", "ImageNd", "from_array_nd", "image3d", "imagend",
    "make_box3d", "make_boxNd",
    "pad_to_multiple", "fill", "fill_with_border", "fill_border_with_value",
    "fill_border_mirror", "fill_border_closest", "copy", "copy_with_border",
    "clone", "bilinear", "bilinear_image", "nearest", "extract_patches",
    "extract_patches_bilinear",
]
