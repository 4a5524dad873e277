"""The share of the traced window in which no operation ran on the
device, in %: 1 minus the union of the device operations' intervals over
the window's length."""


def read(trace, job):
    if not trace.ops or trace.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - trace.busy_s / trace.window_s)
