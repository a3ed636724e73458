"""``tpufem_torch.metrics`` and ``tpufem_torch.checkpoint`` against tpufem's:
a metrics file written by either package reads the same, a ``.npz``
checkpoint written by either loads in the other, and ``checkpointed_run``
resumes to the uninterrupted state."""

import csv
import io
import json

import jax.numpy as jnp
import numpy as np
import torch

from tpufem import checkpoint as jckpt
from tpufem import metrics as jmetrics
from tpufem.workloads import stokes as jstokes
from tpufem_torch import checkpoint as tckpt
from tpufem_torch import interop
from tpufem_torch import metrics as tmetrics
from tpufem_torch.workloads import stokes as tstokes

from tests._torch_parity import meshes

torch.set_num_threads(2)

DYE = dict(transport="dye", solver="inverse", pressure_mode="merge")
TRACERS = dict(transport="tracers", tracer_density=12, solver="inverse", pressure_mode="merge",
               dt=0.01, nu=1.0)


def port_run(kw, steps=6):
    _, tm = meshes(12, 16)
    problem = tstokes.StokesProblem.build(tm, tstokes.StokesConfig(**kw), device="cpu")
    return problem, tstokes.run(problem, steps=steps)


def test_metrics_files_read_the_same_in_both_packages(tmp_path):
    for kw in (DYE, TRACERS):
        _, (_, metrics) = port_run(kw)
        host = {k: v.numpy() for k, v in metrics.items()}
        files = {}
        for name, mod, m in (("port", tmetrics, metrics),
                             ("tpufem", jmetrics, {k: jnp.asarray(v) for k, v in host.items()})):
            files[name] = (mod.write_jsonl(str(tmp_path / f"{name}.jsonl"), m),
                           mod.write_csv(str(tmp_path / f"{name}.csv"), m))
        for i in range(2):
            with open(files["port"][i]) as a, open(files["tpufem"][i]) as b:
                assert a.read() == b.read()
        with open(files["port"][0]) as f:
            rows = [json.loads(line) for line in f]
        assert len(rows) == 6 and rows[-1]["step"] == 5
        with open(files["tpufem"][1]) as f:
            assert [float(r["max_u"]) for r in csv.DictReader(f)] == [r["max_u"] for r in rows]
        assert tmetrics.summarize(metrics) == jmetrics.summarize(host)
        out_t, out_j = io.StringIO(), io.StringIO()
        tmetrics.print_reference_style(metrics, every=2, file=out_t)
        jmetrics.print_reference_style(host, every=2, file=out_j)
        assert out_t.getvalue() == out_j.getvalue() and "Step: 4" in out_t.getvalue()


def test_checkpoints_load_in_both_packages(tmp_path):
    problem, (state, _) = port_run(TRACERS, steps=4)
    path = tckpt.save_state(str(tmp_path / "port.npz"), state, step=4)
    loaded, step = jckpt.load_state(path)
    assert step == 4 and loaded.keys() == state.keys()
    for k, v in state.items():
        np.testing.assert_array_equal(np.asarray(loaded[k]), v.numpy())
        assert np.asarray(loaded[k]).dtype == v.numpy().dtype
    jm, _ = meshes(12, 16)
    jp = jstokes.StokesProblem.build(jm, jstokes.StokesConfig(**TRACERS))
    jstate, _ = jstokes.run(jp, steps=3)
    path = jckpt.save_state(str(tmp_path / "tpufem.npz"), {"flow": jstate}, step=3)
    back, step = tckpt.load_state(path, device="cpu")
    assert step == 3 and set(back) == {"flow"}
    for k, v in jstate.items():
        np.testing.assert_array_equal(back["flow"][k].numpy(), np.asarray(v))
    as32, _ = tckpt.load_state(path, dtype=torch.float32, device="cpu")
    assert as32["flow"]["u"].dtype == torch.float32
    assert as32["flow"]["tracer_status"].dtype == back["flow"]["tracer_status"].dtype


def test_checkpointed_run_resumes_to_the_uninterrupted_state(tmp_path):
    problem, (full, _) = port_run(DYE, steps=7)
    state, paths = tckpt.checkpointed_run(problem, 7, 3, str(tmp_path))
    assert [p[-12:] for p in paths] == ["00000003.npz", "00000006.npz", "00000007.npz"]
    for k in full:
        np.testing.assert_array_equal(state[k].numpy(), full[k].numpy())
    mid, step = tckpt.load_state(paths[0], device="cpu")
    resumed, _ = tstokes.run(problem, steps=7 - step, state=mid)
    for k in full:
        np.testing.assert_array_equal(resumed[k].numpy(), full[k].numpy())
    path = tckpt.save_torch(str(tmp_path / "state.pt"), full)
    again = tckpt.load_torch(path, device="cpu")
    for k in full:
        assert torch.equal(again[k], full[k])
    # a tpufem checkpoint resumes in the port: state arrays carried across
    jm, _ = meshes(12, 16)
    jp = jstokes.StokesProblem.build(jm, jstokes.StokesConfig(**DYE))
    jstate, _ = jstokes.run(jp, steps=3)
    path = jckpt.save_state(str(tmp_path / "j.npz"), jstate, step=3)
    loaded, _ = tckpt.load_state(path, device="cpu")
    from_j, _ = tstokes.run(problem, steps=4, state=loaded)
    from_own, _ = tstokes.run(problem, steps=4, state=interop.state_from_numpy(
        {k: np.asarray(v) for k, v in jstate.items()}, device="cpu"))
    for k in from_own:
        np.testing.assert_array_equal(from_j[k].numpy(), from_own[k].numpy())


def test_phase_timer_and_profiler_trace(tmp_path):
    timer = tmetrics.PhaseTimer()
    with timer.phase("build"):
        problem, _ = port_run(DYE, steps=1)
    with tmetrics.profiler_trace(str(tmp_path / "trace")) as log_dir:
        with timer.phase("run", sync_on=problem.m_lumped):
            tstokes.run(problem, steps=2)
    assert set(timer.phases) == {"build", "run"} and "build" in timer.report()
    with open(f"{log_dir}/trace.json") as f:
        assert "traceEvents" in json.load(f)
