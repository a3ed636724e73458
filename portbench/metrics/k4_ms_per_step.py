"""Device milliseconds of K4 (the Navier–Stokes velocity solve kernel) a
physics step, found by the kernel's name."""

K4_KERNELS = ("ns_bicgstab_kernel",)


def read(trace):
    k4 = [b - a for name, a, b, _ in trace.kernels if any(k in name for k in K4_KERNELS)]
    return 1e3 * sum(k4) / trace.steps if k4 else None
