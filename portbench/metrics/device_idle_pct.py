"""Share of the traced window's wall time in which no operation ran on the
device: 100 − the union of the device intervals over the window."""


def read(trace):
    if not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
