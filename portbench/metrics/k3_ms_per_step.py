"""Device milliseconds of K3 (the pressure solve kernel) a physics step."""

from portbench.yardstick import K3_KERNELS


def read(trace):
    k3 = [b - a for name, a, b, _ in trace.kernels if any(k in name for k in K3_KERNELS)]
    return 1e3 * sum(k3) / trace.steps if k3 else None
