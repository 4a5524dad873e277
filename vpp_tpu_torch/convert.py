"""Carry tracker state between the JAX package and the port.

Both directions go through plain ``{field: numpy array}`` mappings, so
this module needs neither framework's types from the other: build the
mapping from a JAX state with ``np.asarray(getattr(state, name))`` per
field (``keypoints`` of a ``VideoExtruderState`` as a nested mapping), and
turn a port state back into one with the ``*_to_numpy`` functions.
``frame_id`` and ``n_keyframes`` may be 0-d arrays or ints; the port keeps
them as host ints. A ``SlamState`` mapping nests its ``tracker`` the same
way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ._device import resolve_device
from .algorithms.hough_tracker import HoughTrackerState
from .algorithms.video_extruder import VideoExtruderState
from .core.keypoints import Keypoints
from .slam.pipeline import SlamState


def _tensors(cls, m: Mapping[str, Any], dev: torch.device,
             skip=()) -> Dict[str, Any]:
    out = {}
    for f in dataclasses.fields(cls):
        if f.name in skip:
            continue
        out[f.name] = torch.as_tensor(np.array(m[f.name]), device=dev)
    return out


def _numpy(obj, skip=()) -> Dict[str, Any]:
    return {f.name: getattr(obj, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(obj) if f.name not in skip}


def keypoints_from_numpy(m: Mapping[str, Any], device="cuda") -> Keypoints:
    return Keypoints(**_tensors(Keypoints, m, resolve_device(device)))


def keypoints_to_numpy(kps: Keypoints) -> Dict[str, np.ndarray]:
    return _numpy(kps)


def video_extruder_state_from_numpy(m: Mapping[str, Any],
                                    device="cuda") -> VideoExtruderState:
    dev = resolve_device(device)
    fields = _tensors(VideoExtruderState, m, dev,
                      skip=("keypoints", "frame_id"))
    return VideoExtruderState(
        keypoints=keypoints_from_numpy(m["keypoints"], dev),
        frame_id=int(np.asarray(m["frame_id"])), **fields)


def video_extruder_state_to_numpy(st: VideoExtruderState) -> Dict[str, Any]:
    out = _numpy(st, skip=("keypoints", "frame_id"))
    out["keypoints"] = keypoints_to_numpy(st.keypoints)
    out["frame_id"] = np.int32(st.frame_id)
    return out


def hough_tracker_state_from_numpy(m: Mapping[str, Any],
                                   device="cuda") -> HoughTrackerState:
    dev = resolve_device(device)
    fields = _tensors(HoughTrackerState, m, dev, skip=("frame_id",))
    return HoughTrackerState(frame_id=int(np.asarray(m["frame_id"])),
                             **fields)


def hough_tracker_state_to_numpy(st: HoughTrackerState) -> Dict[str, Any]:
    out = _numpy(st, skip=("frame_id",))
    out["frame_id"] = np.int32(st.frame_id)
    return out


def slam_state_from_numpy(m: Mapping[str, Any], device="cuda") -> SlamState:
    """Every ``SlamState`` field as a tensor on ``device``; ``tracker`` a
    nested ``VideoExtruderState`` mapping, ``n_keyframes`` an int."""
    dev = resolve_device(device)
    fields = _tensors(SlamState, m, dev, skip=("tracker", "n_keyframes"))
    return SlamState(
        tracker=video_extruder_state_from_numpy(m["tracker"], dev),
        n_keyframes=int(np.asarray(m["n_keyframes"])), **fields)


def slam_state_to_numpy(st: SlamState) -> Dict[str, Any]:
    out = _numpy(st, skip=("tracker", "n_keyframes"))
    out["tracker"] = video_extruder_state_to_numpy(st.tracker)
    out["n_keyframes"] = np.int32(st.n_keyframes)
    return out
