"""``stokes.run``'s captured step: which problems replay a CUDA graph
(:func:`stokes.graph_path`), the eager loop it leaves everywhere else, and
the graph's cache on the problem.

The tests marked ``card`` run the graph path on a CUDA card against a
hand-written loop over ``make_step``, bit for bit under deterministic
algorithms, at 1,048,576 nodes and at 16,384; they skip without one.  On
the card, without JAX:
``python -m pytest --noconftest -m card tests/test_torch_stokes_graph.py``.
"""

import dataclasses

import pytest
import torch

from _card import BIG, STEP_METRICS, card, deterministic, eager, stokes_grid
from tpufem_torch import generate_annulus_mesh
from tpufem_torch.bench_large import bench_config, with_iteration_counters
from tpufem_torch.solve import grid_cg
from tpufem_torch.workloads import stokes

torch.set_num_threads(2)

assert card and deterministic  # fixtures, imported for the tests marked card

MESH = (12, 16)
STEPS = 3


def _build(**kw) -> stokes.StokesProblem:
    """The Scale configuration (``bench_large.bench_config``) at a tiny size,
    fields replaced by ``kw``."""
    mesh = generate_annulus_mesh(*MESH, pad_hole=True)
    return stokes.StokesProblem.build(mesh, bench_config(n_nodes=mesh.n_nodes, **kw),
                                      device="cpu")


def _kernel_solvers(problem) -> stokes.StokesProblem:
    """The problem with the grid solvers' kernel versions (``plain`` off), as
    ``cg_storage="grid"`` builds them on the card."""
    return dataclasses.replace(
        problem, visc_solver=dataclasses.replace(problem.visc_solver, plain=False),
        pressure_solver=dataclasses.replace(problem.pressure_solver, plain=False))


def _stub_card(monkeypatch, capturing: bool = False) -> None:
    """A stub card, once the problems are built: every problem reports a
    CUDA device, and the stream is capturing or not."""
    monkeypatch.setattr(stokes.StokesProblem, "device",
                        property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)


GRID = dict(cg_storage="grid_interpret")
REFUSED = {
    "dye": dict(GRID, transport="dye"),
    "tracers": dict(GRID, transport="tracers", tracer_density=4),
    "eulerian_dye": dict(GRID, transport="eulerian_dye"),
    "k5": dict(GRID, grid_steps_per_call=1),
    "report": dict(GRID, variant="report"),
    "fused_k1": dict(solver="inverse", fused=True, pressure_mode="merge", precision="f64",
                     matvec_impl="pallas"),
    "dense": dict(solver="inverse", pressure_mode="merge", precision="f64"),
    "csr": dict(cg_storage="csr"),
}


def test_graph_path_admits_the_unfused_grid_step_on_the_card(monkeypatch):
    problem = _kernel_solvers(_build(**GRID))
    _stub_card(monkeypatch)
    assert stokes.graph_path(problem)


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_graph_path_refuses_every_other_path(monkeypatch, case):
    problem = _build(**REFUSED[case])
    if isinstance(problem.visc_solver, stokes.ViscousGridCG):
        problem = _kernel_solvers(problem)
    _stub_card(monkeypatch)
    assert not stokes.graph_path(problem)


def test_graph_path_refuses_the_cpu_the_plain_solvers_and_a_capture(monkeypatch):
    plain = _build(**GRID)
    kernels = _kernel_solvers(plain)
    assert kernels.device.type == "cpu" and not stokes.graph_path(kernels)
    _stub_card(monkeypatch)
    assert not stokes.graph_path(plain)  # the plain versions read the host
    _stub_card(monkeypatch, capturing=True)
    assert not stokes.graph_path(kernels)


def test_run_on_the_cpu_is_the_eager_loop_bit_for_bit():
    problem = _build(**GRID)
    before = dict(stokes.graph_counts)
    state, metrics = stokes.run(problem, steps=STEPS)
    want, series = stokes.initial_state(problem), {k: [] for k in STEP_METRICS}
    step = stokes.make_step(problem)
    for _ in range(STEPS):
        want, m = step(want)
        for k in STEP_METRICS:
            series[k].append(m[k])
    assert list(state) == list(want)
    for k in want:
        assert torch.equal(state[k], want[k]), k
    assert sorted(metrics) == sorted(STEP_METRICS)
    for k in STEP_METRICS:
        assert torch.equal(metrics[k], torch.stack(series[k])), k
    assert stokes.graph_counts == {**before, "eager_steps": before["eager_steps"] + STEPS}
    assert not problem._graphs


def test_replaced_problem_has_its_own_graph_cache():
    problem = _build(**GRID)
    problem._graphs["layout"] = "captured"
    counted, _ = with_iteration_counters(problem)
    swapped = dataclasses.replace(problem, pressure_solver=dataclasses.replace(
        problem.pressure_solver, iters_count=torch.zeros(1, dtype=torch.int32)))
    for other in (counted, swapped):
        assert other._graphs == {} and other._graphs is not problem._graphs
    assert problem._graphs == {"layout": "captured"}
    assert "_graphs" not in {f.name for f in dataclasses.fields(problem) if f.init}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CARD_MESHES = {"1m": BIG, "16k": (128, 144)}
CALL_STEPS = 20


def _card_problem(card, size):
    problem = stokes_grid(card, *CARD_MESHES[size])
    assert stokes.graph_path(problem)
    return problem


@pytest.mark.card
@pytest.mark.parametrize("size", sorted(CARD_MESHES))
def test_card_graph_calls_match_the_eager_loop_bit_for_bit(card, deterministic, size):
    base = _card_problem(card, size)
    graph_pb, graph_counters = with_iteration_counters(base)
    eager_pb, eager_counters = with_iteration_counters(base)
    start = stokes.initial_state(base)

    counts0 = dict(stokes.graph_counts)
    s1, m1 = stokes.run(graph_pb, steps=CALL_STEPS, state=start)
    kept = ({k: v.clone() for k, v in s1.items()}, {k: v.clone() for k, v in m1.items()})
    counts1 = dict(stokes.graph_counts)
    host1 = (grid_cg.viscous_cg.launches, grid_cg.pressure_cg.launches)
    s2, m2 = stokes.run(graph_pb, steps=CALL_STEPS, state=s1)
    counts2 = dict(stokes.graph_counts)
    # the second call replays every step: the host launches neither K2 nor
    # K3, and its results and the solvers' device counters are the eager
    # loop's (below), which a replay that left out a kernel would not give
    assert (grid_cg.viscous_cg.launches, grid_cg.pressure_cg.launches) == host1

    e1, em1 = eager(eager_pb, start, CALL_STEPS)
    e2, em2 = eager(eager_pb, e1, CALL_STEPS)
    torch.cuda.synchronize()

    for got, want in ((s1, e1), (s2, e2)):
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for got, want in ((m1, em1), (m2, em2)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for field in graph_counters:  # the warm-up's iterations are not counted
        assert torch.equal(graph_counters[field][0], eager_counters[field][0]), field
    assert int(graph_counters["pressure_solver"][0].item()) > 0

    # the second call changes nothing the first returned
    for k in kept[0]:
        assert torch.equal(s1[k], kept[0][k]), k
    for k in kept[1]:
        assert torch.equal(m1[k], kept[1][k]), k

    assert counts1["captures"] == counts0["captures"] + 1
    assert counts2["captures"] == counts1["captures"]
    assert counts1["replays"] == counts0["replays"] + CALL_STEPS
    assert counts2["replays"] == counts1["replays"] + CALL_STEPS
    assert counts2["eager_steps"] == counts0["eager_steps"]
    assert len(graph_pb._graphs) == 1 and not base._graphs and not eager_pb._graphs
