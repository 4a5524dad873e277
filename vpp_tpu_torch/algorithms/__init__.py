"""Algorithms: pyramids, Scharr, LBP, FAST9, pyramidal Lucas-Kanade,
semi-dense and sparse flow, the matchers, the distance transforms, the
video_extruder tracker, the geometry, the dense Hough transform, the
unscented Kalman filter and the Hough line tracker.

As in ``vpp_tpu.algorithms``, ``pyramid`` here is the function; the
module is ``importlib.import_module("vpp_tpu_torch.algorithms.pyramid")``.
"""

from .pyramid import (Pyramid, antialias_subsample2,
                      antialiasing_lowpass_filter, level_shapes, pyramid,
                      pyramid_update, subsample, subsample2)
from .scharr import scharr, scharr_point
from .lbp import lbp_hamming_distance, lbp_transform
from .fast import (fast9, fast9_detect, fast9_score, fast9_score_image,
                   local_maxima_filter, blockwise_maxima_filter,
                   select_keypoints)
from .lk import (gradient_pyramid, lk_match_batch, lucas_kanade,
                 oriented_lk_match_batch, pyrlk_match)
from .flow import dense_optical_flow, semi_dense_optical_flow
from .sparse_flow import SparseFlow, sparse_optical_flow
from .geometry import (epipolar_line, epipole_left, epipole_right,
                       fundamental_from_projections, reprojection_error,
                       triangulate)
from .matcher import (bruteforce_match, cross_check_match, hamming_distance,
                      local_match, pairwise_distances, sad_distance)
from .distance_transform import (chamfer_distance_transform,
                                 euclidean_distance_transform, d3_4, d4,
                                 d5_7_11, d8)
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
    "scharr", "scharr_point", "lbp_hamming_distance", "lbp_transform",
    "fast9", "fast9_detect", "fast9_score", "fast9_score_image",
    "local_maxima_filter", "blockwise_maxima_filter", "select_keypoints",
    "gradient_pyramid", "lk_match_batch", "lucas_kanade",
    "oriented_lk_match_batch", "pyrlk_match",
    "dense_optical_flow", "semi_dense_optical_flow", "SparseFlow",
    "sparse_optical_flow", "VideoExtruderConfig",
    "VideoExtruderState", "video_extruder_init", "video_extruder_run",
    "video_extruder_update", "epipolar_line", "epipole_left",
    "epipole_right", "fundamental_from_projections", "reprojection_error",
    "triangulate", "bruteforce_match", "cross_check_match",
    "hamming_distance", "local_match", "pairwise_distances", "sad_distance",
    "chamfer_distance_transform", "euclidean_distance_transform", "d3_4",
    "d4", "d5_7_11", "d8", "HoughLines", "accumulator_to_lines", "hough_accumulator",
    "hough_adaptive_threshold", "hough_lines", "hough_peaks",
    "hough_peaks_clustered", "hough_sparse_revote", "hough_top_k",
    "line_endpoints", "sobel_gradients", "UKFState", "ukf_init",
    "ukf_predict", "ukf_update", "ukf_predict_update_rho_theta",
    "HoughTrackerConfig", "HoughTrackerState", "hough_tracker_init",
    "hough_tracker_update",
]
