"""K9's band pose solve, summed over a call's iterations: device ms
from K9's own clock, the mean over the traced window's stage records
(the program's ``k9_stage_records``, decoded by its ``k9_stage_ms``)."""

from portbench.spans import k9_stage_mean


def read(trace, job):
    return k9_stage_mean("solve")
