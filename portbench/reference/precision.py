"""The arithmetic of a reference run: exact, or with every product's
float32 operands rounded to TF32 (10 mantissa bits, to nearest even) and
summed in float32, as the tensor cores compute a TF32 product. The control
uses the latter: it rounds every product, small or large, where the
libraries would take TF32 only for some."""

from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 where it is float32 (other types as they
    are)."""
    if x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    i = torch.bitwise_and(i + 0x0FFF + ((i >> 13) & 1), -8192)
    return i.view(torch.float32)


class Arith:
    """Products of a reference run: ``mm`` and ``einsum`` round their
    operands to TF32 when ``tf32`` is set."""

    def __init__(self, tf32_products: bool = False):
        self.tf32 = tf32_products

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return tf32(x) if self.tf32 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.r(a) @ self.r(b)

    def einsum(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *(self.r(o) for o in ops))


EXACT = Arith(False)
TF32 = Arith(True)
