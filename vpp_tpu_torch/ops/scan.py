"""Directional sequential sweeps, the ordered form of ``pixel_wise`` (port
of ``vpp_tpu.ops.scan``).

An ordered traversal is a Python loop over the scanned axis, as
``lax.scan`` is a loop: the carried value is a whole column (or row), so
the orthogonal dimension stays parallel. Each step runs ``fn``'s
operations once on (H,) or (W,) tensors: a sweep over W columns is W
times ``fn``'s launches on a card.

``fn(carry, *slices) -> (carry, out)`` where ``carry``/``slices``/``out``
are (H,)-shaped (column sweeps) or (W,)-shaped (row sweeps) tensors. The
outputs are stacked at their slices' indices (in the reverse directions
too, as ``lax.scan(reverse=True)`` stacks them), and the final carry is
returned beside them.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..core.image import Image2d, _as_tensor, from_array


def _as_array(x) -> torch.Tensor:
    return x.interior if isinstance(x, Image2d) else _as_tensor(x)


def _sweep(axis: int, reverse: bool, fn: Callable, init, *imgs):
    xs = [_as_array(i).movedim(axis, 0) for i in imgs]
    n = xs[0].shape[0]
    order = range(n - 1, -1, -1) if reverse else range(n)
    carry, outs = init, []
    for i in order:
        carry, out = fn(carry, *(x[i] for x in xs))
        outs.append(out)
    if reverse:
        outs.reverse()
    leaves, spec = tree_flatten(outs[0])
    per_step = [tree_flatten(o)[0] for o in outs]
    stacked = [torch.stack([torch.as_tensor(s[j]) for s in per_step])
               .movedim(0, axis) for j in range(len(leaves))]
    return carry, tree_unflatten(stacked, spec)


def scan_left_to_right(fn, init, *imgs):
    """Carry flows along +columns; carry/slices are (H,) vectors."""
    return _sweep(1, False, fn, init, *imgs)


def scan_right_to_left(fn, init, *imgs):
    return _sweep(1, True, fn, init, *imgs)


def scan_top_to_bottom(fn, init, *imgs):
    """Carry flows along +rows; carry/slices are (W,) vectors."""
    return _sweep(0, False, fn, init, *imgs)


def scan_bottom_to_top(fn, init, *imgs):
    return _sweep(0, True, fn, init, *imgs)


DIRECTIONS = {
    "left_to_right": scan_left_to_right,
    "right_to_left": scan_right_to_left,
    "top_to_bottom": scan_top_to_bottom,
    "bottom_to_top": scan_bottom_to_top,
}


def directional_pixel_wise(direction: str, fn, init, *imgs) -> Image2d:
    """Ordered pixel_wise: returns only the swept output as an Image2d."""
    _, out = DIRECTIONS[direction](fn, init, *imgs)
    return from_array(out)
