"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import dataclasses
import json
import re
import time

import pytest
import tiny

from portbench import harness, spec

ROOT = tiny.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _reports(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("name", [m["name"] for m in METRICS]
                         + [c["name"] for c in BENCH["configs"]]
                         + [w[k] for w in BENCH["workloads"] for k in ("name", "config", "traffic")]
                         + [k for c in BENCH["configs"] for k in c["reduced"]])
def test_name_characters(name):
    assert NAME.fullmatch(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_unit_and_direction(metric):
    assert UNIT.fullmatch(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_unique():
    for group in (METRICS, BENCH["configs"], BENCH["workloads"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_an_end_to_end_metric_its_cells_report(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    for w in BENCH["workloads"]:
        if _reports(metric, w["name"]):
            assert _reports(e2e[metric["moves"]], w["name"]), (metric["name"], w["name"])


@pytest.mark.parametrize("workload", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(workload):
    e2e = [m["name"] for m in BENCH["end_to_end"] if _reports(m, workload["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reports(m, workload["name"]) for m in BENCH["per_layer"])


@pytest.mark.parametrize("workload", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(workload):
    cell = spec.cell(ROOT, workload["name"])
    assert cell.chips == 1
    assert cell.limits
    for m in cell.per_layer:
        assert callable(spec.reader(ROOT, m["name"]))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_writes_out_every_stokes_field(conf):
    from tpufem_torch.workloads.stokes import StokesConfig

    data = json.loads((ROOT / conf["file"]).read_text())
    assert set(data["stokes"]) == {f.name for f in dataclasses.fields(StokesConfig)}
    assert data["source"] == conf["source"] and data["reduced"] == conf["reduced"]
    assert len(conf["source"]) <= 200 and len(conf["why"]) <= 200


def test_added_cell_traffic_and_metric_are_found_from_files_alone(tmp_path):
    """A new traffic mix, its cell, its check file and a new per-layer
    metric, each a new file plus entries in BENCHMARK.json, run with no
    change to the harness's code."""
    root = tiny.tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    traffic = json.loads((root / "portbench/traffic/steady.json").read_text())
    traffic.update(frame_every=4, warmup_steps=8)
    (root / "portbench/traffic/short_frames.json").write_text(json.dumps(traffic))
    (root / "portbench/checks/stokes_1m.short_frames.json").write_text(
        (root / "portbench/checks/stokes_1m.steady.json").read_text())
    (root / "portbench/metrics/frames_traced.py").write_text(
        "def read(trace):\n    return len(trace.copies_s)\n")
    bench["workloads"].append({"name": "stokes_1m.short_frames", "config": "stokes_1m",
                               "traffic": "short_frames", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "frames: host copy",
                               "moves": "frame_ms_p90", "workloads": ["stokes_1m.short_frames"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = harness.run(root, "stokes_1m.short_frames", 5, 0.2, True, time.perf_counter(),
                      device="cpu")
    assert out["metrics"]["frames_traced"]["value"] == 2
    assert out["correct"]


TOY_STEPPER = '''"""A toy workload: x grows by 1 a step."""
import numpy as np
import torch


def mesh(config):
    return np.arange(config["n"], dtype=np.float64)


def starts(mesh, config, traffic, seed):
    rng = np.random.default_rng(seed % 2**63)
    return [{"x": rng.normal(size=len(mesh))} for _ in range(traffic["starts"])]


def counts(mesh, config):
    return {}


class Program:
    def __init__(self, mesh, config, device, count_iters=False):
        self.dtype, self.device, self.counter = torch.float32, torch.device(device), None

    def start(self, x):
        return {"x": x.clone()}

    def advance(self, state, steps):
        return {"x": state["x"] + steps}, {}

    def frame(self, state, field):
        return state[field].double().cpu().numpy()

    def close(self):
        pass


class Reference:
    def start(self, x):
        return {"x": torch.as_tensor(x, dtype=torch.float64)}

    def advance(self, state, steps):
        return {"x": state["x"] + steps}


def reference(mesh, config, device):
    return Reference()


def compare(reference, first, state, field, mine, metrics, stepper):
    return {"x_err": float(np.max(np.abs(mine - state["x"].numpy())))}
'''


def test_added_workload_is_a_stepper_file_and_data(tmp_path):
    """A workload that is not Stokes: its stepper file, configuration,
    traffic mix and check file, and entries in BENCHMARK.json; the harness
    runs it and judges it with no change to its code."""
    root = tiny.tiny_root(tmp_path)
    (root / "portbench/steppers/toy.py").write_text(TOY_STEPPER)
    (root / "portbench/configs/toy.json").write_text(json.dumps({"workload": "toy", "n": 5}))
    (root / "portbench/traffic/count.json").write_text(json.dumps({
        "frame_every": 3, "frame_field": "x", "advance": 0, "episode_steps": 0,
        "warmup_steps": 3, "starts": 1, "trace_frames": 2,
        "check": {"anchors": "frames", "follow": 1, "samples": 2}}))
    (root / "portbench/checks/toy.count.json").write_text(json.dumps({"limits": {"x_err": 1e-5}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "a test", "file": "portbench/configs/toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy.count", "config": "toy", "traffic": "count",
                               "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = harness.run(root, "toy.count", 5, 0.1, False, time.perf_counter(), device="cpu")
    assert out["correct"] and out["checks"]["x_err"]["value"] < 1e-5
    assert out["metrics"]["steps_per_s"]["value"] > 0
