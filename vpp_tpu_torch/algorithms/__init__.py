"""Algorithms: pyramids, FAST9, semi-dense flow, the video_extruder
tracker, the geometry, the dense Hough transform, the unscented Kalman
filter and the Hough line tracker.

As in ``vpp_tpu.algorithms``, ``pyramid`` here is the function; the
module is ``importlib.import_module("vpp_tpu_torch.algorithms.pyramid")``.
"""

from .pyramid import (Pyramid, antialias_subsample2,
                      antialiasing_lowpass_filter, level_shapes, pyramid,
                      pyramid_update, subsample, subsample2)
from .fast import (fast9, fast9_detect, fast9_score, fast9_score_image,
                   local_maxima_filter, blockwise_maxima_filter,
                   select_keypoints)
from .flow import dense_optical_flow, semi_dense_optical_flow
from .geometry import (epipolar_line, epipole_left, epipole_right,
                       fundamental_from_projections, reprojection_error,
                       triangulate)
from .hough import (HoughLines, accumulator_to_lines, hough_accumulator,
                    hough_adaptive_threshold, hough_lines, hough_peaks,
                    hough_peaks_clustered, hough_sparse_revote, hough_top_k,
                    line_endpoints, sobel_gradients)
from .ukf import (UKFState, ukf_init, ukf_predict, ukf_update,
                  ukf_predict_update_rho_theta)
from .hough_tracker import (HoughTrackerConfig, HoughTrackerState,
                            hough_tracker_init, hough_tracker_update)
from .video_extruder import (VideoExtruderConfig, VideoExtruderState,
                             video_extruder_init, video_extruder_run,
                             video_extruder_update)

__all__ = [
    "Pyramid", "antialias_subsample2", "antialiasing_lowpass_filter",
    "level_shapes", "pyramid", "pyramid_update", "subsample", "subsample2",
    "fast9", "fast9_detect", "fast9_score", "fast9_score_image",
    "local_maxima_filter", "blockwise_maxima_filter", "select_keypoints",
    "dense_optical_flow", "semi_dense_optical_flow", "VideoExtruderConfig",
    "VideoExtruderState", "video_extruder_init", "video_extruder_run",
    "video_extruder_update", "epipolar_line", "epipole_left",
    "epipole_right", "fundamental_from_projections", "reprojection_error",
    "triangulate", "HoughLines", "accumulator_to_lines", "hough_accumulator",
    "hough_adaptive_threshold", "hough_lines", "hough_peaks",
    "hough_peaks_clustered", "hough_sparse_revote", "hough_top_k",
    "line_endpoints", "sobel_gradients", "UKFState", "ukf_init",
    "ukf_predict", "ukf_update", "ukf_predict_update_rho_theta",
    "HoughTrackerConfig", "HoughTrackerState", "hough_tracker_init",
    "hough_tracker_update",
]
