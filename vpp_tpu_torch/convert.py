"""Carry state between the JAX package and the port.

Both directions go through plain ``{field: numpy array}`` mappings, so
this module needs neither framework's types from the other: build the
mapping from a JAX state with ``np.asarray(getattr(state, name))`` per
field (nested states as nested mappings), and turn a port state back into
one with ``state_to_numpy``. One walk serves every state type
(dataclasses and NamedTuples of tensors, host ints and nested states,
read from their field annotations); the ``*_from_numpy``/``*_to_numpy``
functions name it per type. Host ints (``frame_id``, ``n_keyframes``)
come out as ``np.int32`` and go in from 0-d arrays or ints. Checkpoints
(``slam/checkpoint.py``) store the same mappings.

Streams: a JAX state of S streams (``slam_run_streams``, a vmapped state)
carries its host ints as (S,) arrays; they go in as the port's one host
int, and the conversion raises if the streams disagree. ``state_to_numpy(
state, streams=S)`` writes them back as (S,) arrays.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ._device import resolve_device
from .algorithms.hough_tracker import HoughTrackerState
from .algorithms.ukf import UKFState
from .algorithms.video_extruder import VideoExtruderState
from .core.keypoints import Keypoints
from .slam.ba import BAProblem, BATracks
from .slam.pipeline import SlamState
from .slam.pose_graph import PoseGraph


def _is_state(cls) -> bool:
    return dataclasses.is_dataclass(cls) or (
        isinstance(cls, type) and issubclass(cls, tuple)
        and hasattr(cls, "_fields"))


def _names(cls):
    if dataclasses.is_dataclass(cls):
        return [f.name for f in dataclasses.fields(cls)]
    return list(cls._fields)


def state_to_numpy(obj, streams: Optional[int] = None) -> Dict[str, Any]:
    """Every field of a port state as numpy: tensors copied to the host,
    host ints as ``np.int32`` (as (S,) arrays for a state of ``streams``
    streams, the JAX layout), nested states as nested mappings."""
    out = {}
    for name in _names(type(obj)):
        v = getattr(obj, name)
        if isinstance(v, torch.Tensor):
            out[name] = v.detach().cpu().numpy()
        elif isinstance(v, int):
            out[name] = (np.int32(v) if streams is None
                         else np.full((streams,), v, np.int32))
        elif _is_state(type(v)):
            out[name] = state_to_numpy(v, streams)
        else:
            raise TypeError(f"state_to_numpy: field {name} is a "
                            f"{type(v).__name__}")
    return out


def state_from_numpy(cls, m: Mapping[str, Any], device="cuda", *,
                     like=None, where: str = "state"):
    """A ``cls`` from a ``state_to_numpy`` mapping, its tensors on
    ``device``. With ``like`` (a ``cls``), each tensor must have the shape
    and dtype of ``like``'s and goes to its device (``ValueError`` if not)."""
    dev = resolve_device(device)
    hints = typing.get_type_hints(cls)
    out = {}
    for name in _names(cls):
        t, v = hints[name], m[name]
        ref = None if like is None else getattr(like, name)
        at = f"{where}.{name}"
        if t is int:
            a = np.asarray(v)
            if a.ndim and (a != a.flat[0]).any():
                raise ValueError(f"{at}: the streams disagree "
                                 f"({a.tolist()}); a host int is shared by "
                                 "every stream")
            out[name] = int(a.flat[0]) if a.ndim else int(a)
        elif _is_state(t):
            out[name] = state_from_numpy(t, v, dev, like=ref, where=at)
        else:
            x = torch.as_tensor(np.array(v))
            if ref is not None:
                if x.shape != ref.shape or x.dtype != ref.dtype:
                    raise ValueError(
                        f"{at} is {tuple(x.shape)} {x.dtype}, the target's "
                        f"{tuple(ref.shape)} {ref.dtype}")
                out[name] = x.to(ref.device)
            else:
                out[name] = x.to(dev)
    return cls(**out)


keypoints_to_numpy = video_extruder_state_to_numpy = state_to_numpy
hough_tracker_state_to_numpy = slam_state_to_numpy = state_to_numpy
pose_graph_to_numpy = ba_problem_to_numpy = ba_tracks_to_numpy = \
    state_to_numpy
ukf_state_to_numpy = state_to_numpy


def keypoints_from_numpy(m: Mapping[str, Any], device="cuda") -> Keypoints:
    return state_from_numpy(Keypoints, m, device)


def video_extruder_state_from_numpy(m: Mapping[str, Any],
                                    device="cuda") -> VideoExtruderState:
    return state_from_numpy(VideoExtruderState, m, device)


def hough_tracker_state_from_numpy(m: Mapping[str, Any],
                                   device="cuda") -> HoughTrackerState:
    return state_from_numpy(HoughTrackerState, m, device)


def ukf_state_from_numpy(m: Mapping[str, Any], device="cuda") -> UKFState:
    return state_from_numpy(UKFState, m, device)


def slam_state_from_numpy(m: Mapping[str, Any], device="cuda") -> SlamState:
    return state_from_numpy(SlamState, m, device)


def pose_graph_from_numpy(m: Mapping[str, Any], device="cuda") -> PoseGraph:
    return state_from_numpy(PoseGraph, m, device)


def ba_problem_from_numpy(m: Mapping[str, Any], device="cuda") -> BAProblem:
    return state_from_numpy(BAProblem, m, device)


def ba_tracks_from_numpy(m: Mapping[str, Any], device="cuda") -> BATracks:
    return state_from_numpy(BATracks, m, device)
