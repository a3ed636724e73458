"""The spans and iteration counters of the Navier–Stokes grid path
(``navier_stokes.run``, ``NSProblem.build``, K4's ``k4.launch``): the
spans nested as the step runs, one ``step`` and one K4 launch a step, K3's
and K4's counters counting, and the state equal to the bit with spans on
and off."""

import collections
import dataclasses

import pytest
import torch

from tpufem_torch import generate_annulus_mesh, metrics
from tpufem_torch.solve import grid_cg
from tpufem_torch.workloads import navier_stokes as ns

torch.set_num_threads(2)

GRID = dict(solver="cg", cg_storage="grid_interpret", precision="f32", cg_iters_visc=30,
            cg_iters_pressure=120, cg_tol=1e-5)
STEP_PARTS = ("convection", "velocity_solve", "div", "pressure_solve", "grad", "walls",
              "step_metrics")


def _problem(storage="grid_interpret"):
    return ns.NSProblem.build(generate_annulus_mesh(16, 20, pad_hole=True),
                              ns.NSConfig(**dict(GRID, cg_storage=storage)), device="cpu")


def _state(problem):
    g = torch.Generator().manual_seed(3)
    u = 0.01 * torch.rand((problem.mesh.n_nodes, 2), generator=g, dtype=problem.dtype)
    u = torch.where(problem.wall[:, None], 0.0, u)
    return u, torch.zeros(problem.mesh.n_nodes, dtype=problem.dtype)


def _path(spans, i):
    names = []
    while i >= 0:
        names.append(spans[i].name)
        i = spans[i].parent
    return "/".join(reversed(names))


def test_step_spans_nest_and_state_bit_identical():
    """Each step of a grid run: one ``step`` under ``ns.run``, and in it the
    convection refill, the velocity solve, div, the pressure solve, grad,
    the walls and the metrics, in that order; u, p and the metrics equal to
    the bit with spans on and off."""
    problem = _problem()
    state = _state(problem)
    u_off, m_off, (_, p_off) = ns.run(problem, steps=3, state=state, return_state=True)
    with metrics.recording() as rec:
        u_on, m_on, (_, p_on) = ns.run(problem, steps=3, state=state, return_state=True)
    assert torch.equal(u_off, u_on) and torch.equal(p_off, p_on)
    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k
    assert [s.name for s in rec.spans if s.parent == -1] == ["ns.run"]
    steps = [i for i, s in enumerate(rec.spans) if s.name == "step"]
    assert [rec.spans[i].step for i in steps] == [0, 1, 2]
    for i in steps:
        children = [s.name for s in rec.spans if s.parent == i]
        assert tuple(children) == STEP_PARTS
    paths = collections.Counter(_path(rec.spans, i) for i in range(len(rec.spans)))
    for part in STEP_PARTS:
        assert paths[f"ns.run/step/{part}"] == 3


def test_double_projection_repeats_the_projection_spans():
    problem = _problem()
    problem = dataclasses.replace(problem, config=dataclasses.replace(problem.config,
                                                                      double_projection=True))
    with metrics.recording() as rec:
        ns.run(problem, steps=2, state=_state(problem))
    per_step = collections.Counter((s.step, s.name) for s in rec.spans if s.step >= 0)
    for i in range(2):
        assert per_step[(i, "div")] == per_step[(i, "pressure_solve")] == 2
        assert per_step[(i, "grad")] == 2 and per_step[(i, "velocity_solve")] == 1


class _NoKernels:
    """A stand-in for the kernel library: every entry point is a no-op."""

    def __getattr__(self, name):
        return lambda *args: 0


def test_one_k4_launch_span_a_step_inside_the_velocity_solve(monkeypatch):
    """The launch spans where the kernels run: the wrappers taken as if the
    tensors were on a card, with the launch itself stubbed out (the answer
    is not computed; only where each launch's span sits is checked)."""
    problem = _problem(storage="grid")
    monkeypatch.setattr(grid_cg, "_device_ok", lambda t, name: True)
    monkeypatch.setattr(grid_cg, "_lib", _NoKernels())
    monkeypatch.setattr(grid_cg, "_launch", lambda fn, device, *args: None)
    launches = grid_cg.ns_bicgstab.launches
    with metrics.recording() as rec:
        ns.run(problem, steps=3, state=_state(problem))
    assert grid_cg.ns_bicgstab.launches == launches + 3
    paths = collections.Counter(_path(rec.spans, i) for i in range(len(rec.spans)))
    assert paths["ns.run/step/velocity_solve/k4.launch"] == 3
    assert paths["ns.run/step/pressure_solve/k3.launch"] == 3
    per_step = collections.Counter((s.step, s.name) for s in rec.spans)
    assert all(per_step[(i, "k4.launch")] == 1 for i in range(3))


def test_build_spans_name_the_set_up_phases():
    with metrics.recording() as rec:
        _problem()
    top = [s for s in rec.spans if s.parent == -1]
    assert [s.name for s in top] == ["NSProblem.build"]
    phases = [s.name for s in rec.spans if s.parent == 0]
    assert {"assembly", "grid_refill", "dense_split", "pressure_build"} <= set(phases)
    assert phases.index("assembly") < phases.index("dense_split") < phases.index("pressure_build")


@pytest.mark.parametrize("field", ["pressure_solver", "vel_solver_grid"])
def test_k3_and_k4_counters_count(field):
    """K3's and K4's ``iters_count``, set by ``dataclasses.replace``: each
    solve adds its iterations, at least one and at most the cap a step."""
    problem = _problem()
    count = torch.zeros(1, dtype=torch.int32)
    solver = getattr(problem, field)
    problem = dataclasses.replace(problem, **{field: dataclasses.replace(solver,
                                                                          iters_count=count)})
    ns.run(problem, steps=4, state=_state(problem))
    cap = GRID["cg_iters_pressure"] if field == "pressure_solver" else GRID["cg_iters_visc"]
    assert 4 <= int(count) <= 4 * cap
