"""Iterations a pressure solve of the Navier–Stokes step: the pressure
solver's ``iters_count`` counter over the traced window ÷ its one solve a
step."""


def read(trace):
    iters = trace.counters.get("pressure_iters")
    return None if iters is None else iters / trace.steps
