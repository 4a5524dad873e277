"""The port's host path a ``ba_solve_tracks`` call, in ms: the mean
duration of the program's ``vpp.ba_solve_tracks`` spans in the traced
window (checks, K9's workspace query and outputs, its launch, and the
result's views)."""

from portbench.spans import spans


def read(trace, job):
    found = spans(trace, "ba_solve_tracks")
    if not found:
        return None
    return sum(e - s for s, e in found) / len(found) / 1e3
