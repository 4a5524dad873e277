"""K1's share of its roofline: the least time of the flow levels the
traced steps asked for (``counts/k1.py`` at the cell's level shapes and
streams, 3 levels a step) over the device time of K1's launches
(``flow_level.cu``), in %."""


def read(trace, job):
    seconds, launches = trace.seconds_of("flow_level")
    if not launches or not seconds:
        return None
    return 100.0 * job.k1_bound_s_per_step() * trace.steps / seconds
