"""What the per-layer readers take from the program's own tracing: its
spans (``vpp.<name>``, CPU user annotations that ``trace.reduce`` keeps in
``Trace.host``) and K9's stage records
(``vpp_tpu_torch.slam.ba_generic_cuda.k9_stage_records``, decoded by its
``k9_stage_ms``). A program without them (a checkout before they were
added) reads nothing: each function then returns None or an empty list."""

from __future__ import annotations

from typing import List, Optional, Tuple

PREFIX = "vpp."


def spans(trace, name: str) -> List[Tuple[float, float]]:
    """(start_us, end_us) of the program's spans ``vpp.<name>``."""
    return [(s, e) for n, s, e in trace.host if n == PREFIX + name]


def overlap_us(a, b) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def k9_stage_mean(key: str) -> Optional[float]:
    """The mean over the program's K9 stage records of one entry of
    ``k9_stage_ms`` (device ms a launch), or None without records."""
    from vpp_tpu_torch.slam import ba_generic_cuda as bg
    records = getattr(bg, "k9_stage_records", list)()
    if not records:
        return None
    return sum(bg.k9_stage_ms(st, it)[key] for it, st in records) \
        / len(records)
