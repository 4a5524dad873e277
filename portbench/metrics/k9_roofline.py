"""K9's share of its roofline: the least time of the traced calls
(``counts/k9.py`` on each call's problem and pose graph) over the device
time of K9's launches (``ba_generic.cu``), in %."""


def read(trace, job):
    seconds, launches = trace.seconds_of("ba_generic")
    if not launches or not seconds:
        return None
    bound = sum(job.k9_bound_s(i % len(job.host))
                for i in range(trace.calls))
    return 100.0 * bound / seconds
