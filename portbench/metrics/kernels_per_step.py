"""Kernel launches a physics step in the traced window (host loop layer)."""


def read(trace):
    kernels = trace.kernels
    return len(kernels) / trace.steps if kernels else None
