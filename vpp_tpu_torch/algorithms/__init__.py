"""Algorithms: pyramids, FAST9, semi-dense flow, the video_extruder
tracker, the geometry, the dense Hough transform and the Hough line
tracker.

As in ``vpp_tpu.algorithms``, ``pyramid`` here is the function; the
module is ``importlib.import_module("vpp_tpu_torch.algorithms.pyramid")``.
"""

from .pyramid import (Pyramid, antialiasing_lowpass_filter, level_shapes,
                      pyramid, subsample, subsample2)
from .fast import (fast9, fast9_detect, fast9_score, fast9_score_image,
                   local_maxima_filter, blockwise_maxima_filter,
                   select_keypoints)
from .flow import dense_optical_flow, semi_dense_optical_flow
from .geometry import (epipolar_line, epipole_left, epipole_right,
                       fundamental_from_projections, reprojection_error,
                       triangulate)
from .hough import HoughLines, hough_accumulator, hough_peaks, sobel_gradients
from .hough_tracker import (HoughTrackerConfig, HoughTrackerState,
                            hough_tracker_init, hough_tracker_update)
from .video_extruder import (VideoExtruderConfig, VideoExtruderState,
                             video_extruder_init, video_extruder_run,
                             video_extruder_update)

__all__ = [
    "Pyramid", "antialiasing_lowpass_filter", "level_shapes", "pyramid",
    "subsample", "subsample2", "fast9", "fast9_detect", "fast9_score",
    "fast9_score_image", "local_maxima_filter", "blockwise_maxima_filter",
    "select_keypoints", "dense_optical_flow", "semi_dense_optical_flow",
    "VideoExtruderConfig", "VideoExtruderState", "video_extruder_init",
    "video_extruder_run", "video_extruder_update", "epipolar_line",
    "epipole_left", "epipole_right", "fundamental_from_projections",
    "reprojection_error", "triangulate", "HoughLines", "hough_accumulator",
    "hough_peaks", "sobel_gradients", "HoughTrackerConfig",
    "HoughTrackerState", "hough_tracker_init", "hough_tracker_update",
]
