"""Iterations a pressure solve: the pressure solver's ``iters_count``
counter over the traced window ÷ its two solves a step."""


def read(trace):
    iters = trace.counters.get("pressure_iters")
    return None if iters is None else iters / (2 * trace.steps)
