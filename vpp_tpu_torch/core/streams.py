"""The stream dimension: the tracker step and the SLAM keyframe are written
once, for states and buffers with a leading dimension S of independent
streams (clips). A single-stream state goes through them at S = 1 as views:
``lift`` adds the dimension to every tensor of a state, ``drop`` takes
stream 0 back out; neither copies. ``stack`` makes one state of S from S
single-stream states. Host ints (``frame_id``,
``n_keyframes``) are shared by every stream and stay as they are."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], obj):
    """``obj`` (a dataclass of tensors, host ints and nested dataclasses)
    with ``fn`` applied to every tensor."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = fn(v)
        elif dataclasses.is_dataclass(v):
            v = map_tensors(fn, v)
        out[f.name] = v
    return dataclasses.replace(obj, **out)


def lift(obj):
    """A single-stream state as a state of one stream (views)."""
    return map_tensors(lambda t: t.unsqueeze(0), obj)


def drop(obj):
    """Stream 0 of a batched state (views)."""
    return map_tensors(lambda t: t[0], obj)


def stack(states):
    """One state with a leading S from S single-stream states of one shape
    (host ints from the first)."""
    out = {}
    for f in dataclasses.fields(states[0]):
        vals = [getattr(st, f.name) for st in states]
        if isinstance(vals[0], torch.Tensor):
            out[f.name] = torch.stack(vals)
        elif dataclasses.is_dataclass(vals[0]):
            out[f.name] = stack(vals)
        else:
            out[f.name] = vals[0]
    return dataclasses.replace(states[0], **out)
