"""Metrics recording: per-step device series → JSONL / CSV on the host.

The counterpart of ``tpufem.metrics``.  A run keeps its metrics as stacked
(steps,) tensors on the device (``workloads.stokes.run``); they are copied
to the host once and written here, in tpufem's row layout, so a file
written by either package reads the same.
"""

from __future__ import annotations

import csv
import json
import os
import time
from contextlib import contextmanager

import numpy as np
import torch


def to_host(v) -> np.ndarray:
    """A tensor (any device; bf16 widened to f32) or array as a host array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def metrics_to_rows(metrics: dict) -> list[dict]:
    """Stacked metric series {name: (steps,)} → per-step row dicts."""
    arrays = {k: to_host(v) for k, v in metrics.items()}
    n = max(a.shape[0] for a in arrays.values())
    rows = []
    for i in range(n):
        row = {"step": i}
        for k, a in arrays.items():
            if a.shape and a.shape[0] == n:
                v = a[i]
                row[k] = v.item() if np.ndim(v) == 0 else v.tolist()
        rows.append(row)
    return rows


def write_jsonl(path: str, metrics: dict) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for row in metrics_to_rows(metrics):
            f.write(json.dumps(row) + "\n")
    return path


def write_csv(path: str, metrics: dict) -> str:
    rows = metrics_to_rows(metrics)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    return path


def summarize(metrics: dict) -> dict:
    """Final and extreme value of each metric: the one-line run summary."""
    out = {}
    for k, v in metrics.items():
        a = to_host(v).astype(np.float64)
        out[k] = {"final": float(a[-1]), "max": float(a.max()), "min": float(a.min())}
    return out


def print_reference_style(metrics: dict, every: int = 1, file=None) -> None:
    """The reference's per-step console line from stacked metrics, e.g.
    ``Step: 12, Div(u*): 1.2e-01, Final Div(u): 3.4e-02, ...``, printed
    after the run instead of inside the loop."""
    for row in metrics_to_rows(metrics)[::every]:
        parts = [f"Step: {row['step']}"]
        if "div_star_max" in row:
            parts.append(f"Div(u*): {row['div_star_max']:.2e}")
        if "final_div_max" in row:
            parts.append(f"Final Div(u): {row['final_div_max']:.2e}")
        if "mixing_progress" in row:
            parts.append(f"Color mixing progress={row['mixing_progress']:.3f}")
        if "eaten" in row:
            parts.append(f"Eaten (Red): {int(row['eaten'])}")
        if "max_u" in row:
            parts.append(f"Max U: {row['max_u']:.2e}")
        print(", ".join(parts), file=file)


class PhaseTimer:
    """Wall-clock time a phase, the device synchronised at the phase's end."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextmanager
    def phase(self, name: str, sync_on=None):
        """``sync_on``: a tensor whose device is synchronised before the
        clock stops (CUDA work is queued, not done, when a call returns)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if isinstance(sync_on, torch.Tensor) and sync_on.device.type == "cuda":
                torch.cuda.synchronize(sync_on.device)
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.phases.values()) or 1.0
        lines = [
            f"{name:24s} {t:8.3f}s  {100 * t / total:5.1f}%"
            for name, t in sorted(self.phases.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


@contextmanager
def profiler_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (host, and the card where
    there is one), written to ``log_dir/trace.json`` (Chrome trace format;
    view with Perfetto).  The counterpart of tpufem's ``xla_trace``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
