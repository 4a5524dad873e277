"""Device operations (kernels, memsets, copies) of the traced window, per
step (one frame of every stream)."""


def read(trace, job):
    if not trace.ops or not trace.steps:
        return None
    return len(trace.ops) / trace.steps
