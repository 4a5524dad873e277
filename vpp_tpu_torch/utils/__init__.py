"""Utilities: the section profiler and device trace (``profiler``), the
native CPU baseline (``native``), and the synthetic clips and scenes
(``clips``, ``synth``)."""

from .profiler import Profiler, xla_trace

__all__ = ["Profiler", "xla_trace"]
