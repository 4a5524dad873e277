"""Rectangular integer domains (boxes).

The port's own copy of ``vpp_tpu.core.box`` (numpy only): an inclusive
rectangle with size queries, containment and border grow/shrink
arithmetic, after the reference's ``boxNd``/``box2d`` (boxNd.hh). Boxes are
static Python metadata used to slice tensors; they never live on a device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Box2d:
    """Inclusive 2-D box: rows ``r1..r2``, cols ``c1..c2``."""

    r1: int
    c1: int
    r2: int
    c2: int

    @staticmethod
    def from_shape(shape: Tuple[int, int]) -> "Box2d":
        return Box2d(0, 0, shape[0] - 1, shape[1] - 1)

    @property
    def p1(self) -> Tuple[int, int]:
        return (self.r1, self.c1)

    @property
    def p2(self) -> Tuple[int, int]:
        return (self.r2, self.c2)

    @property
    def nrows(self) -> int:
        return self.r2 - self.r1 + 1

    @property
    def ncols(self) -> int:
        return self.c2 - self.c1 + 1

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows, self.ncols)

    def size(self) -> int:
        return self.nrows * self.ncols

    def has(self, p) -> bool:
        r, c = int(p[0]), int(p[1])
        return self.r1 <= r <= self.r2 and self.c1 <= c <= self.c2

    def grow(self, border: int) -> "Box2d":
        return Box2d(self.r1 - border, self.c1 - border,
                     self.r2 + border, self.c2 + border)

    def shrink(self, border: int) -> "Box2d":
        return Box2d(self.r1 + border, self.c1 + border,
                     self.r2 - border, self.c2 - border)

    def intersect(self, other: "Box2d") -> "Box2d":
        return Box2d(max(self.r1, other.r1), max(self.c1, other.c1),
                     min(self.r2, other.r2), min(self.c2, other.c2))

    def points(self) -> Iterator[Tuple[int, int]]:
        """Row-major point iteration (host-side helper)."""
        for r in range(self.r1, self.r2 + 1):
            for c in range(self.c1, self.c2 + 1):
                yield (r, c)

    def coords(self) -> np.ndarray:
        """All (row, col) coordinates as an (N, 2) int32 array, row-major."""
        rr, cc = np.meshgrid(np.arange(self.r1, self.r2 + 1),
                             np.arange(self.c1, self.c2 + 1), indexing="ij")
        return np.stack([rr.ravel(), cc.ravel()], axis=-1).astype(np.int32)


def make_box2d(nrows: int, ncols: int) -> Box2d:
    return Box2d(0, 0, nrows - 1, ncols - 1)
