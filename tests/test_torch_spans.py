"""The port's spans (``tpufem_torch.metrics.span``): nothing recorded and no
allocation while off, nesting, parents and step marks while on, the clock
shared with ``torch.profiler``'s events, the spans of a Stokes step on the
grid storage, and a step's state unchanged by recording."""

import collections
import json

import torch

from tpufem_torch import generate_annulus_mesh, metrics
from tpufem_torch.workloads import stokes

torch.set_num_threads(2)

GRID = dict(solver="cg", cg_storage="grid_interpret", precision="f32", cg_warm_start=True,
            cg_tol_visc=1e-5, cg_tol_pressure=1e-5, cg_precond="twolevel")


def _grid_problem():
    return stokes.StokesProblem.build(generate_annulus_mesh(16, 20, pad_hole=True),
                                      stokes.StokesConfig(**GRID), device="cpu")


def _path(spans, i):
    names = []
    while i >= 0:
        names.append(spans[i].name)
        i = spans[i].parent
    return "/".join(reversed(names))


def test_off_records_nothing_and_returns_the_shared_null_context():
    rec = metrics.SpanRecorder()
    assert metrics.span("a") is metrics.span("b", step=3) is metrics._OFF
    with metrics.span("a") as inner:
        assert inner is None
    with metrics.recording(rec):
        pass
    with metrics.span("after"):
        pass
    assert rec.spans == [] and metrics._recorder is None


def test_nesting_parents_and_step_marks():
    with metrics.recording() as rec:
        with metrics.span("run"):
            for i in range(2):
                with metrics.span("step", step=i):
                    with metrics.span("solve"):
                        with metrics.span("launch"):
                            pass
                    with metrics.span("bcs"):
                        pass
        with metrics.span("after"):
            pass
    names = [(s.name, s.parent, s.step) for s in rec.spans]
    assert names == [("run", -1, -1),
                     ("step", 0, 0), ("solve", 1, 0), ("launch", 2, 0), ("bcs", 1, 0),
                     ("step", 0, 1), ("solve", 5, 1), ("launch", 6, 1), ("bcs", 5, 1),
                     ("after", -1, -1)]
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert rec.spans[1].end_ns <= rec.spans[5].start_ns


def test_inner_recording_records_alone_until_it_ends():
    with metrics.recording() as outer:
        with metrics.span("a"):
            with metrics.recording() as inner:
                with metrics.span("b"):
                    pass
        with metrics.span("c"):
            pass
    assert [s.name for s in outer.spans] == ["a", "c"]
    assert [(s.name, s.parent) for s in inner.spans] == [("b", -1)]


def test_span_clock_is_the_profilers():
    """Each span against its own ``record_function`` event in a CPU profile:
    the same clock, within 1 ms (after a first annotation, which takes the
    profiler's one-time cost)."""
    x = torch.randn(4096)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):
            pass
        with metrics.recording(metrics.SpanRecorder(annotate=True)) as rec:
            for i in range(5):
                with metrics.span(f"anchor{i}"):
                    x = x * 1.5
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("anchor")}
    assert len(events) == 5
    for s in rec.spans:
        e = events[s.name]
        assert abs(e.start_ns() - s.start_ns) < 1_000_000
        assert abs(e.end_ns() - s.end_ns) < 1_000_000


def test_grid_stokes_step_spans_and_state_bit_identical():
    """Each step of a grid-storage run: one viscous solve, two pressure
    solves, three div and two grad, under ``stokes.run/step``; the state
    equal to the bit with spans on and off."""
    problem = _grid_problem()
    start = stokes.initial_state(problem)
    off, m_off = stokes.run(problem, steps=3, state=dict(start))
    with metrics.recording() as rec:
        on, m_on = stokes.run(problem, steps=3, state=dict(start))
    for k in off:
        assert torch.equal(off[k], on[k]), k
    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k
    per_step = collections.Counter((s.step, s.name) for s in rec.spans if s.step >= 0)
    for i in range(3):
        assert per_step[(i, "step")] == 1
        assert per_step[(i, "viscous_solve")] == 1
        assert per_step[(i, "pressure_solve")] == 2
        assert per_step[(i, "div")] == 3
        assert per_step[(i, "grad")] == 2
    paths = {_path(rec.spans, i) for i in range(len(rec.spans))}
    assert {"stokes.run", "stokes.run/run_setup", "stokes.run/step/viscous_solve",
            "stokes.run/step/pressure_solve", "stokes.run/step/div", "stokes.run/step/grad",
            "stokes.run/step/bcs", "stokes.run/step/step_metrics"} <= paths


def test_build_spans_name_the_set_up_phases():
    with metrics.recording() as rec:
        _grid_problem()
    top = [s for s in rec.spans if s.parent == -1]
    assert [s.name for s in top] == ["StokesProblem.build"]
    phases = {s.name for s in rec.spans if s.parent == 0}
    assert {"gridify", "boundary", "assembly", "dense_split", "pressure_build",
            "from_host"} <= phases


def test_dye_step_spans_transport():
    cfg = stokes.StokesConfig(solver="inverse", pressure_mode="merge", transport="dye")
    problem = stokes.StokesProblem.build(generate_annulus_mesh(12, 16), cfg, device="cpu")
    with metrics.recording() as rec:
        stokes.run(problem, steps=2)
    paths = collections.Counter(_path(rec.spans, i) for i in range(len(rec.spans)))
    assert paths["stokes.run/step/transport"] == 2
    assert paths["stokes.run/dye_baseline"] == 1


def test_profiler_trace_shows_the_spans(tmp_path):
    problem = _grid_problem()
    with metrics.profiler_trace(str(tmp_path / "trace")) as log_dir:
        stokes.run(problem, steps=1)
    with open(f"{log_dir}/trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"stokes.run", "step", "viscous_solve", "pressure_solve", "div", "grad"} <= names
    assert metrics._recorder is None
