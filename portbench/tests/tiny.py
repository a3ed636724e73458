"""A copy of the benchmark at CPU sizes: the same files, with the meshes and
windows cut so a cell runs in a second."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
MESH = {"n_side": 20, "n_circle": 24, "pad_hole": True}


def tiny_root(tmp: Path) -> Path:
    """``tmp`` as a checkout holding BENCHMARK.json, portbench/'s data
    files and its workloads' steppers, with every configuration on a
    20 × 20 annulus and every traffic mix's episodes, warm-up and traced
    window shortened."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "checks", "metrics", "steppers"):
        shutil.copytree(BENCH / sub, tmp / "portbench" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for conf in bench["configs"]:
        path = tmp / conf["file"]
        data = json.loads(path.read_text())
        data["mesh"] = dict(MESH)
        path.write_text(json.dumps(data))
    for path in (tmp / "portbench" / "traffic").glob("*.json"):
        data = json.loads(path.read_text())
        data["warmup_steps"] = data["frame_every"]
        data["advance"] = min(data["advance"], 2 * data["frame_every"])
        data["trace_frames"] = 2
        if data["episode_steps"]:
            data["episode_steps"] = data["frame_every"] * data["check"]["follow"]
        data["starts"] = min(data["starts"], 2)
        path.write_text(json.dumps(data))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
