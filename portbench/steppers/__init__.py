"""What the window drives, one file a workload: ``steppers/<workload>.py``,
named by the ``workload`` key of a configuration file and found by that
name (``spec.stepper``).  A workload file gives:

* ``mesh(config)``: the mesh arrays the program and the reference share;
* ``starts(mesh, config, traffic, seed)``: the traffic's seeded start
  states, a list of dicts of host float64 arrays;
* ``counts(mesh, config)``: the frozen operation and byte counts the
  per-layer metrics read (``Trace.yardstick``);
* ``Program(mesh, config, device, count_iters)``: the program under test;
* ``Control(mesh, config, device)``: the precision control, the plain
  reference one step below the configuration's precision, in the
  program's place;
* ``reference(mesh, config, device)``: the plain reference that judges;
* ``compare(reference, first, state, field, mine, metrics, stepper)``: the
  numbers of one frame, → {number: value};
* ``altered_answer(inner, mesh, field)``: the fault "an answer altered
  where it is produced".

A stepper (``Program``, ``Control``) has ``dtype``, ``device``, ``counter``
(the pressure solver's iteration counter or None) and five calls:

* ``start(**arrays)``: a fresh state from a start's arrays;
* ``advance(state, steps)`` → (state, metrics): ``steps`` physics steps;
* ``frame(state, field)``: the host copy of a field the user watches;
* ``mixing_var(metrics)``: where the workload has one, the mixing
  variance after the last step, left on the device;
* ``close()``: frees the device.

``reference`` has ``start(**arrays)`` and ``advance(state, steps)`` → state.

Below: the faults any stepper can be given.
"""

from __future__ import annotations


class Frozen:
    """Fault: each call runs the steps and hands back the state it was given."""

    def __init__(self, inner):
        self.inner = inner
        self.dtype, self.device, self.counter = inner.dtype, inner.device, inner.counter

    def start(self, **arrays):
        return self.inner.start(**arrays)

    def advance(self, state, steps: int):
        _, metrics = self.inner.advance(state, steps)
        return state, metrics

    def frame(self, state, field):
        return self.inner.frame(state, field)

    def mixing_var(self, metrics):
        return self.inner.mixing_var(metrics)

    def close(self):
        self.inner.close()


class Altered(Frozen):
    """Fault: the watched field of each state ``advance`` produces is off
    by ``delta`` at the nodes ``nodes`` (an index or a slice)."""

    def __init__(self, inner, field: str, nodes, delta: float):
        super().__init__(inner)
        self.field, self.nodes, self.delta = field, nodes, delta

    def advance(self, state, steps: int):
        state, metrics = self.inner.advance(state, steps)
        state = dict(state)
        state[self.field] = state[self.field].clone()
        state[self.field][self.nodes] += self.delta
        return state, metrics
