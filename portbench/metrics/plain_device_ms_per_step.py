"""Device milliseconds per step of the operations that are none of the
port's hand kernels: PyTorch's and the libraries' kernels, memsets and
copies that the plain stages launch."""


def read(trace, job):
    if not trace.ops or not trace.steps:
        return None
    return trace.plain_seconds() * 1e3 / trace.steps
