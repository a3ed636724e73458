"""Device milliseconds of kernels a physics step in the traced window."""


def read(trace):
    kernels = trace.kernels
    if not kernels:
        return None
    return 1e3 * sum(b - a for _, a, b, _ in kernels) / trace.steps
