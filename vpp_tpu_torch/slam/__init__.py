"""SLAM back end of the port: SE(3) maps, bundle adjustment (the window
BA is kernel K6, the generic tracks layout kernel K9, the flat layout plain
PyTorch), the pose graph, checkpoints, the SLAM engine (the map vote is
kernel K8) and SfM from line correspondences."""

from .se3 import (se3_exp, se3_log, se3_inverse, se3_compose, se3_apply,
                  so3_exp, so3_log)
from .ba import (BAProblem, BATracks, ba_solve, ba_solve_tracks, project,
                 reprojection_residuals, track_residuals, tracks_from_flat)
from .pose_graph import PoseGraph, pose_graph_residuals, pose_graph_solve
from .checkpoint import save_state, restore_state
from .sfm import (image_line_normals, plucker_from_points,
                  plucker_point_distance, plucker_transform,
                  pose_from_line_correspondences, vanishing_points)
from .pipeline import (SlamConfig, SlamState, ate_rmse,
                       keyframe_trajectory, pnp_gn, relocalize, slam_init,
                       slam_run, slam_step)

__all__ = [
    "se3_exp", "se3_log", "se3_inverse", "se3_compose", "se3_apply",
    "so3_exp", "so3_log", "BAProblem", "BATracks", "ba_solve",
    "ba_solve_tracks", "tracks_from_flat", "track_residuals", "project",
    "reprojection_residuals", "PoseGraph", "pose_graph_residuals",
    "pose_graph_solve", "save_state", "restore_state", "SlamConfig",
    "SlamState", "slam_init", "slam_step", "slam_run", "relocalize",
    "pnp_gn", "keyframe_trajectory", "ate_rmse", "plucker_from_points",
    "plucker_transform", "plucker_point_distance",
    "pose_from_line_correspondences", "vanishing_points",
    "image_line_normals",
]
