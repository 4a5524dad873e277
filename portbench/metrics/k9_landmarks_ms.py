"""K9's landmark-block stage, summed over a call's iterations (its
first stretch holds the decision on the previous step): device ms from
K9's own clock, the mean over the traced window's stage records (the
program's ``k9_stage_records``, decoded by its ``k9_stage_ms``)."""

from portbench.spans import k9_stage_mean


def read(trace, job):
    return k9_stage_mean("landmarks")
