"""The traced window's reduction: ``torch.profiler`` events into device
operations, the device's busy time (the union of its operations), the
idle gaps labelled by what the host was doing, and the port's hand
kernels by source file.

The kernels' names come from the program: every ``__global__`` function
declared in ``vpp_tpu_torch/kernels/csrc/*.cu``, keyed by its file's stem.
A device operation whose name holds none of them is a plain PyTorch or
library operation.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "vpp_tpu_torch" / "kernels" \
    / "csrc"
_GLOBAL = re.compile(
    r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
    r"(?:void\s+)?([A-Za-z_]\w*)\s*\(", re.S)
TOP = 10
SPAN = "portbench."        # the harness's own spans around its calls


def hand_kernels(csrc: Path = CSRC) -> Dict[str, Tuple[str, ...]]:
    """{source stem: names of the ``__global__`` functions it declares}."""
    out = {}
    for path in sorted(csrc.glob("*.cu")):
        names = tuple(sorted(set(_GLOBAL.findall(path.read_text()))))
        if names:
            out[path.stem] = names
    return out


@dataclasses.dataclass
class Trace:
    """Device operations (name, start_us, end_us) of the traced window, the
    host's events (name, start_us, end_us) for labelling gaps, the window's
    length and the calls and steps it held."""
    ops: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    window_s: float
    calls: int
    steps: int
    kernels: Dict[str, Tuple[str, ...]]

    def __post_init__(self):
        self.ops.sort(key=lambda o: o[1])
        self._patterns = {
            stem: re.compile(r"\b(?:" + "|".join(map(re.escape, names))
                             + r")\b")
            for stem, names in self.kernels.items()}
        self.busy_intervals = _union([(s, e) for _, s, e in self.ops])
        self.busy_s = sum(e - s for s, e in self.busy_intervals) / 1e6

    def source_of(self, name: str) -> Optional[str]:
        """The csrc stem whose kernel this operation is, or None."""
        for stem, pat in self._patterns.items():
            if pat.search(name):
                return stem
        return None

    def seconds_of(self, stem: str) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels of ``stem``.cu."""
        pat = self._patterns.get(stem)
        if pat is None:
            return 0.0, 0
        hits = [e - s for n, s, e in self.ops if pat.search(n)]
        return sum(hits) / 1e6, len(hits)

    def plain_seconds(self) -> float:
        """Device seconds of operations that are no hand kernel."""
        return sum(e - s for n, s, e in self.ops
                   if self.source_of(n) is None) / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle intervals (start_us, end_us) between busy ones."""
        iv = self.busy_intervals
        return [(a[1], b[0]) for a, b in zip(iv, iv[1:]) if b[0] > a[1]]

    def breakdown(self) -> dict:
        by_op: Dict[str, float] = {}
        for n, s, e in self.ops:
            by_op[n[:120]] = by_op.get(n[:120], 0.0) + (e - s) / 1e6
        by_gap: Dict[str, float] = {}
        for label, sec in _label_gaps(self.gaps(), self.host):
            by_gap[label] = by_gap.get(label, 0.0) + sec
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _label_gaps(gaps, host):
    """Each gap with the innermost host event running at its start (the
    harness's own span where no operator ran)."""
    host = sorted(host, key=lambda h: (h[1], -h[2]))
    starts = [h[1] for h in host]
    out = []
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0)
        label, best = "host", None
        # the innermost event containing g0 among the last few that began
        for j in range(i - 1, max(-1, i - 64), -1):
            n, s, e = host[j]
            if e >= g0 and (best is None or e - s < best):
                label, best = n, e - s
        out.append((label[:120], (g1 - g0) / 1e6))
    return out


def reduce(prof, window_s: float, calls: int, steps_per_call: int,
           csrc: Path = CSRC) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile``."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    ops, host = [], []
    for e in prof.events():
        tr = e.time_range
        row = (e.name, float(tr.start), float(tr.end))
        if e.device_type == cpu:
            host.append(row)
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name.startswith(SPAN)):
            ops.append(row)
    return Trace(ops=ops, host=host, window_s=window_s, calls=calls,
                 steps=calls * steps_per_call, kernels=hand_kernels(csrc))
