"""The benchmark's Navier–Stokes workload on the CPU: the plain reference
(``portbench/reference/ns.py``) against the program's grid path, the cell
``ns_1m.steady`` judged by its own ``compare`` at a tiny size (the program
correct; the bfloat16 control, a frozen step, an altered answer and an
advection C(u) built wrong not), the configuration against
``bench_large.ns_config()``, and the starts."""

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "portbench" / "tests")]

import tiny  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.reference import ns as ref_ns  # noqa: E402
from portbench.steppers import Frozen  # noqa: E402
from portbench.steppers import ns as ns_steps  # noqa: E402

torch.set_num_threads(2)

CONFIG = json.loads((ROOT / "portbench/configs/ns_1m.json").read_text())
TRAFFIC = json.loads((ROOT / "portbench/traffic/channel_steady.json").read_text())
CELL = "ns_1m.steady"


def _small(n_side=32, n_circle=36, **ns):
    conf = json.loads(json.dumps(CONFIG))
    conf["mesh"] = {"n_side": n_side, "n_circle": n_circle, "pad_hole": True}
    conf["ns"].update(ns)
    return conf


def test_config_fields_are_bench_large_ns_config():
    from tpufem_torch import bench_large

    want = dataclasses.asdict(bench_large.ns_config())
    got = {k: tuple(v) if isinstance(v, list) else v for k, v in CONFIG["ns"].items()}
    assert got == want
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "ns_1m")
    assert CONFIG["source"] == entry["source"] and CONFIG["reduced"] == entry["reduced"] == []
    assert CONFIG["workload"] == "ns"


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**40 + 3])
def test_reference_equals_the_programs_grid_path_at_f64(seed):
    """Ten steps of the program's grid path (the kernels' plain versions,
    float64, solves to 1e-13) and of the reference from one seeded start,
    on a 32 × 32 annulus.  Tolerance 1e-9 on the velocity (~1e-7 of its
    largest value): the reference stops its solves at 1e-10 of their
    right-hand sides, and the program's grid split applies its remainder
    (the entries off the planes, next to the ring) with float32 rounding at
    every precision, as tpufem's kernels do; together they part by at most
    1.4e-10 over these starts."""
    conf = _small(precision="f64", cg_storage="grid_interpret", cg_tol=1e-13,
                  cg_iters_visc=3000, cg_iters_pressure=3000)
    mesh = ns_steps.mesh(conf)
    program = ns_steps.Program(mesh, conf, "cpu")
    assert program.dtype == torch.float64 and program.problem.grid_refill is not None
    start = ns_steps.starts(mesh, conf, TRAFFIC, seed)[0]
    ref = ns_steps.reference(mesh, conf, "cpu")
    mine = program.start(torch.as_tensor(start["u"]))
    theirs = ref.start(start["u"])
    for _ in range(10):
        mine, _ = program.advance(mine, 1)
        theirs = ref.advance(theirs, 1)
        assert float(torch.max(torch.abs(mine["u"] - theirs["u"]))) < 1e-9
    assert float(torch.max(torch.abs(theirs["u"]))) > 1e-3  # a flow that moved, not a zero


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**40 + 3])
def test_refilled_convection_equals_the_reference_at_f64(seed):
    """C(u)·u with C(u) built as the program's grid step builds it (the
    element values refilled onto the velocity planes) against the
    reference's, float64, on a 32 × 32 annulus, relative to the reference's
    largest |C(u)·u| at a node.  Tolerance 1e-12: the two sum the same
    products in another order and part by under 1e-15 over these starts;
    a wrong sign, a lost or a transposed element matrix parts by O(1)."""
    conf = _small(precision="f64", cg_storage="grid_interpret")
    mesh = ns_steps.mesh(conf)
    program = ns_steps.Program(mesh, conf, "cpu")
    ref = ns_steps.reference(mesh, conf, "cpu")
    u = torch.as_tensor(ns_steps.starts(mesh, conf, TRAFFIC, seed)[0]["u"])
    theirs = ref.convection(u) @ u
    mine = program.convection(u)
    assert mine.dtype == torch.float64
    size = float(torch.max(torch.linalg.vector_norm(theirs, dim=1)))
    assert size > 0
    assert float(torch.max(torch.linalg.vector_norm(mine - theirs, dim=1))) < 1e-12 * size


def test_starts_vanish_where_the_step_holds_u_zero_and_peak_at_the_traffic_scale():
    conf = _small()
    coords, tris, markers = mesh = ns_steps.mesh(conf)
    zero = ref_ns.zero_nodes(coords, tris, markers, conf["ns"])
    assert zero[markers == -1].all() and zero[markers == 2].all()
    pool = ns_steps.starts(mesh, conf, TRAFFIC, 2**33 + 1)
    assert len(pool) == TRAFFIC["starts"]
    for s in pool:
        speed = np.hypot(s["u"][:, 0], s["u"][:, 1])
        assert np.all(s["u"][zero] == 0.0)
        assert speed.max() == pytest.approx(TRAFFIC["velocity"]["peak"], rel=1e-12)
    again = ns_steps.starts(mesh, conf, TRAFFIC, 2**33 + 1)
    assert all(np.array_equal(a["u"], b["u"]) for a, b in zip(pool, again))
    assert not np.array_equal(pool[0]["u"], pool[1]["u"])


def test_program_refuses_a_path_other_than_the_grid():
    conf = _small(cg_storage="csr")
    with pytest.raises(RuntimeError, match="grid path"):
        ns_steps.Program(ns_steps.mesh(conf), conf, "cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("ns_bench"))


def _control(mesh, config, device, count_iters):
    control = ns_steps.Control(mesh, config, device)
    assert control.dtype == torch.bfloat16
    return control


def _frozen(mesh, config, device, count_iters):
    return Frozen(ns_steps.Program(mesh, config, device, count_iters))


def _altered(mesh, config, device, count_iters):
    return ns_steps.altered_answer(ns_steps.Program(mesh, config, device, count_iters), mesh, "u")


class _WrongC(ns_steps.Program):
    """Faults of the advection: the program with C(u) built with its sign
    flipped, left out, or with each element matrix transposed.  Its steps
    are the sound program's: at these widths Δt·C(u)·u lies far below what
    ``u_err`` resolves, so only ``c_err`` can see the fault."""

    def __init__(self, how, *args):
        super().__init__(*args)
        self.how = how

    def convection(self, u):
        from tpufem_torch.ops import assembly

        if self.how == "flipped":
            return -super().convection(u)
        if self.how == "dropped":
            return torch.zeros_like(super().convection(u))
        u = u.to(device=self.device, dtype=self.dtype)
        flat = assembly.element_convection_flat(self._mesh, u, "opsplit")  # entry (3i + j)·T + t
        C = self._refill.refill_flat(flat.reshape(3, 3, -1).transpose(0, 1).reshape(-1))
        return torch.stack([C.matvec(u[:, 0].contiguous()), C.matvec(u[:, 1].contiguous())], dim=1)


def _wrong_c(how):
    return lambda *args: _WrongC(how, *args)


STEPPERS = {"program": None, "control": _control, "frozen": _frozen, "altered": _altered,
            "c_flipped": _wrong_c("flipped"), "c_dropped": _wrong_c("dropped"),
            "c_transposed": _wrong_c("transposed")}


@pytest.mark.parametrize("stepper", list(STEPPERS))
def test_cell_judged_by_its_compare(root, stepper):
    """Whole runs of the cell at the tiny size, with its limits: the float32
    program comes out correct; the reference in bfloat16, a step that hands
    back its state, the velocity off at one node and an advection built
    wrong do not.  The last is caught by ``c_err`` alone: its ``u_err``
    stays within the limit."""
    out = harness.run(root, CELL, 2**31 + 17, 0.3, False, time.perf_counter(), device="cpu",
                      make_stepper=STEPPERS[stepper])
    assert out["correct"] == (stepper == "program"), out["checks"]
    assert out["attempted"] >= 1
    checks = out["checks"]
    assert set(checks) == {"u_err", "c_err"}
    if stepper.startswith("c_"):
        assert checks["u_err"]["value"] <= checks["u_err"]["limit"], checks
        assert checks["c_err"]["value"] > 100 * checks["c_err"]["limit"], checks
    elif stepper == "program":
        assert checks["c_err"]["value"] < checks["c_err"]["limit"] / 100, checks


def test_traced_run_reads_the_cells_per_layer_metrics(root):
    """On the CPU no device trace exists: the traced run reads the pressure
    counter (one solve a step) and the frame copies, and nothing of K4."""
    out = harness.run(root, CELL, 5, 0.2, True, time.perf_counter(), device="cpu")
    assert out["correct"], out["checks"]
    metrics = out["metrics"]
    assert "k4_ms_per_step" not in metrics
    assert 1 <= metrics["ns_pressure_iters"]["value"] <= CONFIG["ns"]["cg_iters_pressure"]
    assert metrics["frame_copy_ms"]["value"] > 0
