"""``pixel_wise`` / ``block_wise`` / ``row_wise``: the loop constructs
(port of ``vpp_tpu.ops.pixel_wise``).

A kernel is written as elementwise tensor code over whole interior arrays:
each neighbour read is a shifted view of the bordered buffer
(``Image2d.shifted``), so a stencil reads no padded copy. ``block_wise``
and ``row_wise`` map the kernel over blocks or rows with
``torch.func.vmap``, as the JAX module maps it with ``jax.vmap``: the
kernel sees one block or row, and each of its operations runs once over
all of them.

Results follow the device of the inputs; a box alone (``Coords``) makes
its index planes on ``device``, the CPU unless given.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import torch
from torch.utils._pytree import tree_map

from ..core.box import Box2d
from ..core.image import Image2d, from_array, pad2d


def _map_tensors(fn: Callable, tree):
    """``fn`` on every tensor of a tuple / list / dict tree."""
    return tree_map(lambda x: fn(x) if isinstance(x, torch.Tensor) else x,
                    tree)


class RelAccess:
    """Stencil accessor: ``nbh(dr, dc)`` is the interior-shaped view
    shifted by (dr, dc). Offsets are Python ints within the border."""

    def __init__(self, img: Image2d):
        self.img = img

    def __call__(self, dr: int, dc: int) -> torch.Tensor:
        return self.img.shifted(dr, dc)

    @property
    def center(self) -> torch.Tensor:
        return self.img.interior


def relative_access(img: Image2d) -> RelAccess:
    return RelAccess(img)


class Coords:
    """Coordinate range: ``p[0]``/``p[1]`` are (H, W) int32 row and column
    index planes offset by the box's first corner."""

    def __init__(self, box: Box2d, device=None):
        self.box = box
        h, w = box.shape
        self._r = (torch.arange(h, dtype=torch.int32, device=device)
                   + box.r1)[:, None].expand(h, w)
        self._c = (torch.arange(w, dtype=torch.int32, device=device)
                   + box.c1)[None, :].expand(h, w)

    def __getitem__(self, i: int) -> torch.Tensor:
        return self._r if i == 0 else self._c

    @property
    def rows(self) -> torch.Tensor:
        return self._r

    @property
    def cols(self) -> torch.Tensor:
        return self._c


def _range_shape(rng) -> Tuple[int, int] | None:
    if isinstance(rng, Image2d):
        return rng.shape
    if isinstance(rng, RelAccess):
        return rng.img.shape
    if isinstance(rng, Box2d):
        return rng.shape
    if hasattr(rng, "shape"):
        return tuple(rng.shape[:2])
    return None


def _range_device(rng):
    if isinstance(rng, Image2d):
        return rng.device
    if isinstance(rng, RelAccess):
        return rng.img.device
    if isinstance(rng, torch.Tensor):
        return rng.device
    return None


def _range_value(rng, device):
    if isinstance(rng, Image2d):
        return rng.interior
    if isinstance(rng, RelAccess):
        return rng
    if isinstance(rng, Box2d):
        return Coords(rng, device=device)
    return rng


class _PixelWise:
    def __init__(self, ranges: Sequence[Any], out_border: int = 0):
        self.ranges = ranges
        self.out_border = out_border
        shapes = [s for s in map(_range_shape, ranges) if s is not None]
        if not shapes:
            raise ValueError("pixel_wise needs at least one shaped range")
        # the first range defines the iteration domain
        self.domain_shape = shapes[0]
        devices = [d for d in map(_range_device, ranges) if d is not None]
        self.device = devices[0] if devices else None

    def __call__(self, **opts) -> "_PixelWise":
        # named options (the reference's iod sio); geometry only
        return _PixelWise(self.ranges,
                          out_border=opts.get("out_border", self.out_border))

    def __or__(self, fn: Callable):
        return self.apply(fn)

    def apply(self, fn: Callable):
        """Run the kernel over the domain; its tensor results come back as
        Image2d (a tuple, list or dict of them for several), None where it
        returns None."""
        args = [_range_value(r, self.device) for r in self.ranges]
        out = fn(*args)
        if out is None:
            return None
        return _map_tensors(lambda a: from_array(a, border=self.out_border),
                            out)


def pixel_wise(*ranges, out_border: int = 0) -> _PixelWise:
    """``pixel_wise(A, relative_access(B), box) | kernel``.

    The kernel receives, per range: the interior tensor (Image2d), a
    RelAccess (relative_access), Coords (Box2d), or the raw tensor. It
    computes with ordinary elementwise tensor ops and returns the output
    tensor(s), wrapped as Image2d with ``out_border``."""
    return _PixelWise(ranges, out_border=out_border)


# ---------------------------------------------------------------------------
# block_wise / row_wise
# ---------------------------------------------------------------------------

def block_wise(block_size: Tuple[int, int], *imgs: Image2d):
    """``block_wise((bh, bw), imgs...) | fn``: fn maps each (bh, bw[, C])
    block of every image. Blocks on the bottom and right edges are padded
    with zeros to full size, and the kernel gets a ``valid`` mask as its
    last argument.

    fn(*blocks, valid) -> block-shaped tensor(s) or per-block scalar(s).
    Returns the reassembled Image2d (block-shaped output) or an
    (nbr, nbc, ...) tensor (anything else), blocks in row-major order."""
    bh, bw = block_size
    h, w = imgs[0].shape

    def runner(fn):
        nbr = -(-h // bh)
        nbc = -(-w // bw)
        nb = nbr * nbc
        blocks = []
        for im in imgs:
            a = pad2d(im.interior, 0, nbr * bh - h, 0, nbc * bw - w,
                      "constant")
            a = a.reshape((nbr, bh, nbc, bw) + a.shape[2:])
            a = a.movedim(2, 1)                 # (nbr, nbc, bh, bw, ...)
            blocks.append(a.reshape((nb, bh, bw) + a.shape[4:]))
        dev = imgs[0].device
        blk = torch.arange(nb, dtype=torch.int32, device=dev)[:, None, None]
        rr = (torch.arange(bh, dtype=torch.int32, device=dev)[None, :, None]
              + (blk // nbc) * bh)
        cc = (torch.arange(bw, dtype=torch.int32, device=dev)[None, None, :]
              + (blk % nbc) * bw)
        valid = (rr < h) & (cc < w)
        out = torch.func.vmap(fn)(*blocks, valid)

        def reassemble(o):
            if o.dim() >= 3 and o.shape[1] == bh and o.shape[2] == bw:
                o = o.reshape((nbr, nbc, bh, bw) + o.shape[3:])
                o = o.movedim(1, 2)
                o = o.reshape((nbr * bh, nbc * bw) + o.shape[4:])
                return from_array(o[:h, :w])
            return o.reshape((nbr, nbc) + o.shape[1:])

        return _map_tensors(reassemble, out)

    return _Runner(runner)


def row_wise(*imgs: Image2d):
    """``row_wise(imgs...) | fn``: fn maps each row (``torch.func.vmap``
    over the rows). fn(*rows) -> row tensor(s) or per-row scalar(s); a
    result with the images' (H, W) leading shape comes back as Image2d."""

    def runner(fn):
        rows = [im.interior for im in imgs]
        out = torch.func.vmap(fn)(*rows)

        def wrap(o):
            if o.dim() >= 2 and tuple(o.shape[:2]) == tuple(
                    rows[0].shape[:2]):
                return from_array(o)
            return o

        return _map_tensors(wrap, out)

    return _Runner(runner)


class _Runner:
    def __init__(self, runner):
        self._runner = runner

    def __or__(self, fn):
        return self._runner(fn)

    def apply(self, fn):
        return self._runner(fn)
