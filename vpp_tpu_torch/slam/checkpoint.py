"""Checkpoint and resume of SLAM and tracker state (port of
``vpp_tpu.slam.checkpoint``).

``save_state`` writes ``convert.state_to_numpy``'s mapping of the state,
its arrays as CPU tensors, with ``torch.save``: no class is pickled, so
``restore_state`` loads with ``torch.load(weights_only=True)`` and rebuilds
``target``'s type through ``convert.state_from_numpy``, each tensor on the
device of the target's and checked against its shape and dtype. Works for
``SlamState``, ``BATracks``, ``PoseGraph`` and the tracker states.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from .. import convert


def _as_tensors(m) -> Any:
    if isinstance(m, dict):
        return {k: _as_tensors(v) for k, v in m.items()}
    return torch.as_tensor(m)


def save_state(path: str, state: Any) -> None:
    """Write ``state`` to ``path`` (a file; its directory is created)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(_as_tensors(convert.state_to_numpy(state)), path)


def restore_state(path: str, target: Any) -> Any:
    """Restore into the type, shapes and dtypes of ``target``; each tensor
    goes to the device of the target's tensor."""
    tree = torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)
    return convert.state_from_numpy(type(target), tree, "cpu", like=target)
