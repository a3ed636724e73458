"""Metrics recording: per-step device series → JSONL / CSV on the host,
and the port's tracing.

The counterpart of ``tpufem.metrics``.  A run keeps its metrics as stacked
(steps,) tensors on the device (``workloads.stokes.run``); they are copied
to the host once and written here, in tpufem's row layout, so a file
written by either package reads the same.

Tracing: :class:`PhaseTimer` (an operator's phase clock, which
synchronises), :func:`profiler_trace` (a Chrome trace of a block) and the
program's spans (:func:`span`, :class:`SpanRecorder`, :func:`recording`),
named host intervals at each layer boundary of a run, which cost one test
of a module flag while no recording is on.
"""

from __future__ import annotations

import csv
import json
import os
import time
from contextlib import contextmanager
from typing import NamedTuple

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
    view with Perfetto), with the program's spans recorded as
    ``record_function`` ranges, so the trace shows the program's layers.
    The counterpart of tpufem's ``xla_trace``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        with recording(SpanRecorder(annotate=True)):
            yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Span(NamedTuple):
    """One recorded span.  Times are ``time.time_ns()``, the clock of
    ``torch.profiler``'s events (host and device): a span and a kernel
    compare directly."""

    name: str
    parent: int  # index of the enclosing span in the recording, -1 at the top
    start_ns: int
    end_ns: int
    step: int  # the step of its ``stokes.run`` call it lies in, -1 outside a step


class _Off:
    """The span while no recording is on: enters and leaves, nothing more."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_recorder: "SpanRecorder | None" = None  # the recording on, if any


def span(name: str, step: int | None = None):
    """A span named ``name`` over a ``with`` block: recorded by the
    recording on (:func:`recording`), else the shared no-op ``_OFF``.
    ``step`` marks the block as that step of a run; spans inside it take
    the step of the span that encloses them."""
    if _recorder is None:
        return _OFF
    return _Open(_recorder, name, step)


class _Open:
    """A span of the recording on, stamped as it is entered and left."""

    __slots__ = ("rec", "name", "step", "index", "annotation")

    def __init__(self, rec, name, step):
        self.rec, self.name, self.step = rec, name, step

    def __enter__(self):
        rec = self.rec
        stack = rec._stack
        parent = stack[-1] if stack else -1
        step = self.step
        if step is None:
            step = rec._rows[parent][4] if stack else -1
        self.index = len(rec._rows)
        if rec.annotate:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        rec._rows.append([self.name, parent, time.time_ns(), 0, step])
        stack.append(self.index)

    def __exit__(self, *exc):
        rec = self.rec
        rec._rows[self.index][3] = time.time_ns()
        rec._stack.pop()
        if rec.annotate:
            self.annotation.__exit__(*exc)
        return False


class SpanRecorder:
    """The spans of one recording, kept in memory (``spans``, complete once
    the recording ends).  Spans nest on one thread: a span's parent is the
    span open when it was entered.  ``annotate`` also enters each span as
    a ``torch.profiler.record_function``, for a profiler's trace."""

    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self._rows: list[list] = []
        self._stack: list[int] = []
        self.spans: list[Span] = []

    def finish(self) -> list[Span]:
        """Close the recording's list: ``spans`` as :class:`Span` tuples."""
        self.spans = [Span(*row) for row in self._rows]
        return self.spans


@contextmanager
def recording(recorder: SpanRecorder | None = None):
    """Record the program's spans over the block into ``recorder`` (a new
    :class:`SpanRecorder` by default), which the block gets; its ``spans``
    are complete when the block ends.  Recordings nest: the inner one
    records alone until it ends."""
    global _recorder
    rec = recorder if recorder is not None else SpanRecorder()
    outer, _recorder = _recorder, rec
    try:
        yield rec
    finally:
        _recorder = outer
        rec.finish()
