"""K3's share of its roofline: the least time of the window's pressure
solves (``yardstick.k3_least_s``: bytes once a solve against 3.35 TB/s,
flops of the counted iterations against 67 TFLOP/s) over K3's device time."""

from portbench import yardstick


def read(trace):
    k3 = sum(b - a for name, a, b, _ in trace.kernels
             if any(k in name for k in yardstick.K3_KERNELS))
    iters = trace.counters.get("pressure_iters")
    if not k3 or not iters:
        return None
    least = yardstick.k3_least_s(trace.yardstick["k3"], 2 * trace.steps, iters)
    return 100.0 * least / k3
