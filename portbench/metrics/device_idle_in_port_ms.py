"""The device's idle time a call that lies under the port's own host path,
in ms: the traced window's idle gaps (disjoint) intersected with the
union of the program's ``vpp.ba_solve_tracks`` spans, over the number of
those spans. The rest of the idle time is the caller's."""

from portbench.spans import overlap_us, spans
from portbench.trace import _union


def read(trace, job):
    found = spans(trace, "ba_solve_tracks")
    if not found or not trace.ops:
        return None
    return overlap_us(trace.gaps(), _union(found)) / len(found) / 1e3
