"""The comparison that decides ``correct``.

The window's answers are its frames.  A *unit* is a run of ``follow``
consecutive frames that follows a state the benchmark knows whole: an
episode's start, which the benchmark made, or, where the watched field is
the whole state the step takes (``u`` with no transport), the frame before
it.  The window offers every unit it completes; a seeded reservoir keeps
``samples`` of them.  After the window the plain reference (float64 on the
same device, converged to 1e-10 of each right-hand side) follows each kept
unit from its known state, and the workload's ``compare``
(``steppers/<workload>.py``) yields the numbers of each frame.  Each
number's worst over all frames is held to its limit in the cell's check
file.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Unit:
    anchor: tuple  # ("start", k) or ("frame", host array of the watched field)
    frames: list = dataclasses.field(default_factory=list)  # host arrays of the watched field
    metrics: list = dataclasses.field(default_factory=list)  # the program's, a frame each


class Reservoir:
    """A seeded uniform sample of ``size`` units from a stream."""

    def __init__(self, size: int, seed: int):
        self.size, self.kept, self.seen = size, [], 0
        self.rng = np.random.default_rng([seed % 2**63, 7])

    def offer(self, unit: Unit) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(unit)
            return
        j = int(self.rng.integers(self.seen))
        if j < self.size:
            self.kept[j] = unit


def judge(units, starts, reference, traffic: dict, stepper, compare) -> dict:
    """Follow each unit with ``reference``; → {number: worst value over all
    frames} (inf where the program's answer was not finite)."""
    every, field = int(traffic["frame_every"]), traffic["frame_field"]
    out = {}
    for unit in units:
        kind, what = unit.anchor
        state = reference.start(**(starts[what] if kind == "start" else {field: what}))
        first = state
        for k, frame in enumerate(unit.frames):
            state = reference.advance(state, every)
            metrics = unit.metrics[k] if k < len(unit.metrics) else None
            for name, value in compare(reference, first, state, field, frame, metrics,
                                       stepper).items():
                value = value if math.isfinite(value) else float("inf")
                out[name] = max(out.get(name, 0.0), value)
    return out
