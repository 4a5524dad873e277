"""K9's index stage (the slots sorted by pose, the non-empty 6x6 blocks
of S, S's block half-bandwidth), once a call: device ms from K9's own
clock, the mean over the traced window's stage records (the program's
``k9_stage_records``, decoded by its ``k9_stage_ms``)."""

from portbench.spans import k9_stage_mean


def read(trace, job):
    return k9_stage_mean("index")
