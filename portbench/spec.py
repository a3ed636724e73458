"""What a cell is made of, found by name from ``BENCHMARK.json``.

A workload names a configuration and a traffic mix.  Each lives in a file
of its own, and so does the cell's correctness limits and each per-layer
metric's reader:

* ``configs/<config>.json`` (the ``file`` of the configuration's entry):
  the ``workload`` it runs, its mesh and fields (for ``stokes``: every
  ``StokesConfig`` field), the source and the cuts;
* ``steppers/<workload>.py``: the program under test, its start states,
  its plain reference and the numbers a frame is judged by (``steppers``);
* ``traffic/<traffic>.json``: the parameters of the workload's traffic
  generator (for ``stokes``, ``starts.py``) and of the window;
* ``checks/<workload>.json``: each number the comparison with the plain
  reference yields, with its limit;
* ``metrics/<metric>.py``: a ``read(trace)`` that returns the metric or
  None where the traced window holds nothing for it.

Adding a cell, a configuration, a mix or a metric is adding files and
entries; no code here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    workload: str  # the stepper file's name
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    limits: dict  # number → limit
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of the benchmark in the checkout at ``root``."""
    bench_dir = Path(root) / HERE.name
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in {root / 'BENCHMARK.json'}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(Path(root) / conf["file"]) as f:
        config = json.load(f)
    with open(bench_dir / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    with open(bench_dir / "checks" / f"{workload}.json") as f:
        limits = json.load(f)["limits"]
    return Cell(
        name=workload, workload=config["workload"], chips=int(entry["chips"]), config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
    )


def _load(root: Path, folder: str, name: str):
    path = Path(root) / HERE.name / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(root: Path, name: str):
    """The ``read`` function of ``metrics/<name>.py`` in the checkout at ``root``."""
    return _load(root, "metrics", name).read


def stepper(root: Path, workload: str):
    """The module ``steppers/<workload>.py`` in the checkout at ``root``."""
    return _load(root, "steppers", workload)
