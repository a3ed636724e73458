"""Whole runs of each cell at CPU sizes: the program comes out correct; the
precision control and each fault a cell can have come out not correct;
nothing of JAX is loaded; and, on the card, each cell at its own size."""

import json
import subprocess
import sys
import time

import pytest
import torch
import tiny

from portbench import harness
from portbench.steppers import Frozen, stokes

ROOT = tiny.ROOT
WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
FIELD = {w: json.loads((ROOT / "portbench/traffic" / f"{w.split('.')[1]}.json").read_text())[
    "frame_field"] for w in WORKLOADS}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("bench"))


def _run(root, workload, make_stepper=None, trace=False, seed=11):
    return harness.run(root, workload, seed, 0.3, trace, time.perf_counter(), device="cpu",
                       make_stepper=make_stepper)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_comes_out_correct(root, workload, trace):
    out = _run(root, workload, trace=trace, seed=2**31 + 17)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    want = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in getattr(harness.spec.cell(root, workload), want)}
    # on the CPU no device trace exists, so only host metrics can be read
    assert set(out["metrics"]) <= names and out["metrics"]
    for check in out["checks"].values():
        assert check["value"] <= check["limit"]


def _control(mesh, config, device, count_iters):
    control = stokes.Control(mesh, config, device)
    assert control.dtype == torch.bfloat16
    return control


def _frozen(mesh, config, device, count_iters):
    return Frozen(stokes.Program(mesh, config, device, count_iters))


def _altered(field):
    def make(mesh, config, device, count_iters):
        return stokes.altered_answer(stokes.Program(mesh, config, device, count_iters),
                                     mesh, field)
    return make


@pytest.mark.parametrize("fault", ["control", "frozen", "altered"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_and_faults_come_out_not_correct(root, workload, fault):
    """The reference in bfloat16 in the program's place, a step that hands
    back its state, and an answer altered where it is produced.  (A cell on
    one chip with no batch has no batch to halve and no exchange to drop.)"""
    make = {"control": _control, "frozen": _frozen, "altered": _altered(FIELD[workload])}[fault]
    out = _run(root, workload, make_stepper=make)
    assert not out["correct"], out["checks"]


def test_a_run_loads_nothing_of_jax():
    """A whole CPU run in a fresh process, then every loaded module's
    top-level name against jax, jaxlib, flax and tpufem, compared whole."""
    code = f"""
import sys, time, tempfile, pathlib
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'portbench' / 'tests')!r}]
import tiny
from portbench import harness, run
root = tiny.tiny_root(pathlib.Path(tempfile.mkdtemp()))
for w in {WORKLOADS!r}:
    harness.run(root, w, 3, 0.2, True, time.perf_counter(), device="cpu")
print(run.forbidden_modules(), "tpufem_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    import types

    from portbench import run

    for name in ("tpufem_torch.workloads", "jaxtyping", "flaxen.core"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not {"tpufem_torch", "jaxtyping", "flaxen"} & set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax" in run.forbidden_modules()


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", WORKLOADS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                          "--seed", "2147483999", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1


@pytest.fixture(scope="module")
def movie_root(tmp_path_factory):
    """The tiny checkout with the dye movie added back by files alone: its
    configuration and cell entries and a check file.  BENCHMARK.json leaves
    the movie out until the program's float32 point location is repaired;
    the limits here are the tiny size's, for these tests only."""
    root = tiny.tiny_root(tmp_path_factory.mktemp("movie"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dye_410k", "source": "a test", "reduced": [],
                             "file": "portbench/configs/dye_410k.json", "why": "a test"})
    bench["workloads"].append({"name": "dye_410k.movie", "config": "dye_410k",
                               "traffic": "movie", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    conf = json.loads((root / "portbench/configs/dye_410k.json").read_text())
    conf["mesh"] = dict(tiny.MESH)
    (root / "portbench/configs/dye_410k.json").write_text(json.dumps(conf))
    (root / "portbench/checks/dye_410k.movie.json").write_text(
        json.dumps({"limits": {"c_err": 1e-3, "mix_err": 1e-3}}))
    return root


@pytest.mark.parametrize("stepper", ["program", "control", "frozen", "altered"])
def test_dye_movie_judged_by_the_largest_gap_at_a_node(movie_root, stepper):
    """The program's dye within 1e-3 of the reference's at every node; the
    control, a frozen step and the dye off by 0.05 at one node are not."""
    make = {"program": None, "control": _control, "frozen": _frozen,
            "altered": _altered("c")}[stepper]
    out = harness.run(movie_root, "dye_410k.movie", 2**31 + 9, 1.0, False, time.perf_counter(),
                      device="cpu", make_stepper=make)
    assert out["correct"] == (stepper == "program"), out["checks"]
