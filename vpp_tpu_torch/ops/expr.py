"""Image expression language, LIIE's capability (port of
``vpp_tpu.ops.expr``).

Placeholders ``P1``..``P4``, ``V(img)`` (value of a captured image),
``if_(cond)(then)(else)`` and global reductions compose symbolically as a
small operator-overloading tree; ``evaluate`` binds the placeholders to
images and runs the tree as tensor operations on their device.
"""

from __future__ import annotations

import operator

import torch

from ..core.image import Image2d, _as_tensor, from_array
from .reductions import int32_sum


def _truediv(a, b):
    """a / b with each quotient rounded once, as XLA divides. PyTorch takes
    ``number / tensor`` as a reciprocal times the number, and on a card
    ``tensor / number`` as the tensor times the number's reciprocal: a
    number becomes a 0-d tensor of the promoted type on the other
    operand's device."""
    if isinstance(a, torch.Tensor) != isinstance(b, torch.Tensor):
        t = a if isinstance(a, torch.Tensor) else b
        dt = torch.result_type(a, b)
        if isinstance(a, torch.Tensor):
            b = torch.as_tensor(b, dtype=dt, device=t.device)
        else:
            a = torch.as_tensor(a, dtype=dt, device=t.device)
    return a / b


class Expr:
    def _bin(self, other, op):
        return _BinOp(self, _wrap(other), op)

    def _rbin(self, other, op):
        return _BinOp(_wrap(other), self, op)

    def __add__(self, o): return self._bin(o, operator.add)
    def __radd__(self, o): return self._rbin(o, operator.add)
    def __sub__(self, o): return self._bin(o, operator.sub)
    def __rsub__(self, o): return self._rbin(o, operator.sub)
    def __mul__(self, o): return self._bin(o, operator.mul)
    def __rmul__(self, o): return self._rbin(o, operator.mul)
    def __truediv__(self, o): return self._bin(o, _truediv)
    def __rtruediv__(self, o): return self._rbin(o, _truediv)
    def __lt__(self, o): return self._bin(o, operator.lt)
    def __le__(self, o): return self._bin(o, operator.le)
    def __gt__(self, o): return self._bin(o, operator.gt)
    def __ge__(self, o): return self._bin(o, operator.ge)
    def __neg__(self): return _UnOp(self, operator.neg)

    def eq(self, o): return self._bin(o, operator.eq)
    def ne(self, o): return self._bin(o, operator.ne)

    def evaluate(self, *imgs):
        raise NotImplementedError


def _wrap(x) -> "Expr":
    if isinstance(x, Expr):
        return x
    if isinstance(x, Image2d):
        return V(x)
    return _Const(x)


class _Const(Expr):
    def __init__(self, v):
        self.v = v

    def _eval(self, env):
        return self.v


class Placeholder(Expr):
    """``_1``, ``_2`` … bound positionally by evaluate."""

    def __init__(self, idx: int):
        self.idx = idx

    def _eval(self, env):
        return env[self.idx]


class V(Expr):
    """``_v(img)``: the value of a captured image."""

    def __init__(self, img: Image2d):
        self.img = img

    def _eval(self, env):
        return self.img.interior


class _BinOp(Expr):
    def __init__(self, a, b, op):
        self.a, self.b, self.op = a, b, op

    def _eval(self, env):
        return self.op(self.a._eval(env), self.b._eval(env))


class _UnOp(Expr):
    def __init__(self, a, op):
        self.a, self.op = a, op

    def _eval(self, env):
        return self.op(self.a._eval(env))


class _If(Expr):
    """``if_(cond)(then)(else)``."""

    def __init__(self, cond, then_=None, else_=None):
        self.cond, self.then_, self.else_ = cond, then_, else_

    def __call__(self, x):
        if self.then_ is None:
            return _If(self.cond, _wrap(x), None)
        return _If(self.cond, self.then_, _wrap(x))

    def _eval(self, env):
        return torch.where(self.cond._eval(env), self.then_._eval(env),
                           self.else_._eval(env))


def if_(cond) -> _If:
    return _If(_wrap(cond))


class _Reduction(Expr):
    def __init__(self, inner: Expr, kind: str):
        self.inner, self.kind = inner, kind

    def _eval(self, env):
        v = self.inner._eval(env)
        if self.kind == "sum":
            # int32 (and wrapping) for integers and bools, as JAX's sum
            return v.sum() if v.dtype.is_floating_point else int32_sum(v)
        if self.kind == "min":
            return torch.amin(v)
        if self.kind == "max":
            return torch.amax(v)
        if self.kind == "avg":
            return torch.mean(v.to(torch.float32))
        w = v.shape[1]
        idx = torch.argmin(v.reshape(-1)) if self.kind == "argmin" \
            else torch.argmax(v.reshape(-1))
        return torch.stack([idx // w, idx % w]).to(torch.int32)


def sum_of(e): return _Reduction(_wrap(e), "sum")
def min_of(e): return _Reduction(_wrap(e), "min")
def max_of(e): return _Reduction(_wrap(e), "max")
def avg_of(e): return _Reduction(_wrap(e), "avg")
def argmin_of(e): return _Reduction(_wrap(e), "argmin")
def argmax_of(e): return _Reduction(_wrap(e), "argmax")


# Positional placeholders, LIIE's _1.._4.
P1, P2, P3, P4 = Placeholder(0), Placeholder(1), Placeholder(2), \
    Placeholder(3)


def evaluate(expr: Expr, *imgs):
    """Bind the placeholders to images and run the expression.
    Image-shaped results (the (H, W) of the first image, or of the first
    ``V`` when no image is given) come back as Image2d; reductions as 0-d
    tensors or (row, col) pairs."""
    env = [i.interior if isinstance(i, Image2d) else _as_tensor(i)
           for i in imgs]
    root = _wrap(expr)

    def first_shape(e):
        if isinstance(e, V):
            return e.img.shape
        for child in ("a", "b", "cond", "then_", "else_", "inner"):
            sub = getattr(e, child, None)
            if isinstance(sub, Expr):
                s = first_shape(sub)
                if s is not None:
                    return s
        return None

    ref_shape = env[0].shape[:2] if env else first_shape(root)
    out = root._eval(env)
    if ref_shape is not None and hasattr(out, "ndim") and out.ndim >= 2 \
            and tuple(out.shape[:2]) == tuple(ref_shape):
        return from_array(out)
    return out
