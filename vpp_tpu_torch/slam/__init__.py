"""SLAM back end of the port: SE(3) maps, window BA (kernel K6), the pose
graph, checkpoints and the SLAM engine (the map vote is kernel K8)."""

from .se3 import (se3_exp, se3_log, se3_inverse, se3_compose, se3_apply,
                  so3_exp, so3_log)
from .ba import BATracks, ba_solve_tracks, project, track_residuals
from .pose_graph import PoseGraph, pose_graph_residuals, pose_graph_solve
from .checkpoint import save_state, restore_state
from .pipeline import (SlamConfig, SlamState, ate_rmse,
                       keyframe_trajectory, pnp_gn, relocalize, slam_init,
                       slam_run, slam_step)

__all__ = [
    "se3_exp", "se3_log", "se3_inverse", "se3_compose", "se3_apply",
    "so3_exp", "so3_log", "BATracks", "ba_solve_tracks", "project",
    "track_residuals", "PoseGraph", "pose_graph_residuals",
    "pose_graph_solve", "save_state", "restore_state", "SlamConfig",
    "SlamState", "slam_init", "slam_step", "slam_run", "relocalize",
    "pnp_gn", "keyframe_trajectory", "ate_rmse",
]
