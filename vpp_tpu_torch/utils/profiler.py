"""Hierarchical section profiler (port of ``vpp_tpu.utils.profiler``).

Named ``begin/end`` sections form a tree; each node adds up wall time and
calls; the report prints the tree with %parent / %total / %self columns.

CUDA launches return before the card has run them, so a wall clock around
them measures the enqueue. A section given a ``sync`` value (a tensor, or
a tuple, list, dict or dataclass holding tensors, such as an ``Image2d``
or a tracker state) therefore waits at its end for every card that holds
one of them (``torch.cuda.synchronize``). Use as::

    prof = Profiler()
    with prof("frame"):
        with prof("pyramid", sync=...):
            pyr = pyramid(img, 3)
    print(prof.report())

``span(name)`` marks a layer boundary of the port's own path for a
``torch.profiler`` session: a ``record_function("vpp." + name)`` while a
session records (a CPU user annotation on the clock of the trace's CUDA
operations, nested in the span that encloses it on the thread), and one
shared no-op context after a single flag read otherwise.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Set

import torch
import torch.autograd.profiler as _autograd_profiler


@dataclass
class _Node:
    """A section: its total duration, call count and child sections."""
    name: str
    duration: float = 0.0
    ncalls: int = 0
    children: Dict[str, "_Node"] = field(default_factory=dict)


def _cuda_devices(value, found: Set[torch.device]) -> Set[torch.device]:
    """The CUDA devices of every tensor nested in ``value``."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            found.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, found)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            _cuda_devices(getattr(value, f.name), found)
    return found


def _block(value) -> None:
    for dev in _cuda_devices(value, set()):
        torch.cuda.synchronize(dev)


class Profiler:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.root = _Node("root")
        self._stack: List[_Node] = [self.root]
        self._t0: List[float] = []

    def begin(self, name: str) -> None:
        if not self.enabled:
            return
        parent = self._stack[-1]
        node = parent.children.get(name)
        if node is None:
            node = _Node(name)
            parent.children[name] = node
        self._stack.append(node)
        self._t0.append(time.perf_counter())

    def end(self, name: str, sync=None) -> None:
        """``end(name)``; with ``sync``, waits for the cards that hold its
        tensors first, so the section is charged their work."""
        if not self.enabled:
            return
        if sync is not None:
            _block(sync)
        node = self._stack.pop()
        if node.name != name:
            raise ValueError(f"end({name}) inside {node.name}")
        node.duration += time.perf_counter() - self._t0.pop()
        node.ncalls += 1

    def sync(self, value) -> None:
        """Wait now for the cards that hold ``value``'s tensors, so that
        their pending work is charged to the innermost open section."""
        if self.enabled and value is not None:
            _block(value)

    @contextmanager
    def __call__(self, name: str, sync=None):
        self.begin(name)
        try:
            yield self
        finally:
            self.end(name, sync)

    # -- report --------------------------------------------------------------
    def report(self) -> str:
        total = sum(c.duration for c in self.root.children.values())
        lines = [f"{'section':<40}{'ms':>10}{'calls':>8}"
                 f"{'%parent':>9}{'%total':>8}{'%self':>8}"]

        def walk(node: _Node, depth: int, parent_dur: float):
            self_dur = node.duration - sum(c.duration
                                           for c in node.children.values())
            pp = 100 * node.duration / parent_dur if parent_dur else 100.0
            pt = 100 * node.duration / total if total else 100.0
            ps = 100 * self_dur / node.duration if node.duration else 0.0
            lines.append(f"{'  ' * depth + node.name:<40}"
                         f"{node.duration * 1e3:>10.3f}{node.ncalls:>8}"
                         f"{pp:>8.1f}%{pt:>7.1f}%{ps:>7.1f}%")
            for c in node.children.values():
                walk(c, depth + 1, node.duration)

        for c in self.root.children.values():
            walk(c, 0, total)
        return "\n".join(lines)

    def reset(self) -> None:
        self.root = _Node("root")
        self._stack = [self.root]
        self._t0 = []


_NO_SPAN = nullcontext()


def profiling() -> bool:
    """Whether a ``torch.profiler`` session records (the flag its
    ``__enter__`` sets and its ``__exit__`` clears)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """The span ``vpp.<name>`` while a ``torch.profiler`` session records,
    else a shared no-op context. Use as ``with span("ba_solve_tracks"): ...``."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function("vpp." + name)


@contextmanager
def xla_trace(logdir: str):
    """A device-level trace of the block (the JAX module's name for it):
    a ``torch.profiler`` session of the host's operators and, where a card
    is present, its CUDA kernels, written into ``logdir`` as a Chrome trace
    (``<host>.<pid>.<time>.pt.trace.json``; open it in Perfetto or
    chrome://tracing)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield
