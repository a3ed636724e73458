"""One run of one cell: set-up, the measured (or traced) window, the
comparison with the reference, and the result line.

Set-up (``setup_s``, from the process's start to the first timed step):
imports, CUDA, the workload's mesh and program (for ``stokes``: the
grid-kernel library from the checkout's build cache, the frozen annulus,
``StokesProblem.build``), the traffic's start states on the device, each
taken ``advance`` steps on where the traffic asks for it, and
``warmup_steps`` steps through the window's own calls, with a frame copy.
``steppers/<workload>.py``, named by the configuration, says what the
mesh, a start, a step and a frame are.

The window repeats one frame: ``frame_every`` steps in one call of the
program (for ``stokes``, one ``stokes.run``), then a synchronised host copy
of the watched field.  An episode of ``episode_steps`` steps (0: the whole
window) starts from the next start state (or from that start taken
``advance`` steps on in set-up, with its warm starts).  The window closes
after the first frame that ends ``seconds`` after it opened; a traced run
instead runs ``trace_frames`` frames untraced and then as many under the
profiler.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from portbench import check, spec, tracing


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """The frame loop over ``stepper`` and the check's bookkeeping."""

    def __init__(self, stepper, pool, traffic: dict, seed: int):
        self.stepper, self.pool, self.traffic = stepper, pool, traffic
        self.every = int(traffic["frame_every"])
        self.field = traffic["frame_field"]
        self.episode = int(traffic["episode_steps"])
        self.advanced = []  # (state, host copy of its watched field) an episode starts from
        chk = traffic["check"]
        self.follow = int(chk["follow"])
        self.frame_anchors = chk["anchors"] == "frames"
        self.sample = check.Reservoir(int(chk["samples"]), seed)
        self.episodes = 0
        self.state = None
        self.unit = None
        self.in_episode = 0

    def set_up(self) -> None:
        """Take each start ``advance`` steps on, warm starts and all, where
        the traffic asks for it (the episodes then start from those states);
        run ``warmup_steps`` steps through the window's own calls."""
        steps = int(self.traffic["advance"])
        for start in self.pool if steps else ():
            state = self.stepper.start(**start)
            state, _ = self.stepper.advance(state, steps)
            self.advanced.append((state, self.stepper.frame(state, self.field)))
        for _ in range(max(1, int(self.traffic["warmup_steps"]) // self.every)):
            self.frame(keep=False)
        self.anchor_here()

    def new_episode(self) -> None:
        k = self.episodes % len(self.pool)
        if self.advanced:
            state, host = self.advanced[k]
            self.state = {name: t.clone() for name, t in state.items()}
            self.unit = check.Unit(("frame", host)) if self.frame_anchors else None
        else:
            self.state = self.stepper.start(**self.pool[k])
            self.unit = check.Unit(("start", k))
        self.episodes += 1
        self.in_episode = 0

    def frame(self, keep: bool = True):
        """One frame → the wall seconds of its host copy."""
        if self.state is None or (self.episode and self.in_episode >= self.episode):
            self.new_episode()
        self.state, metrics = self.stepper.advance(self.state, self.every)
        self.in_episode += self.every
        _sync(self.stepper.device)
        t0 = time.perf_counter()
        host = self.stepper.frame(self.state, self.field)
        copy_s = time.perf_counter() - t0
        if keep and self.unit is not None:
            self.unit.frames.append(host)
            self.unit.metrics.append(metrics)
            if len(self.unit.frames) == self.follow:
                self.sample.offer(self.unit)
                self.unit = None
        if keep and self.unit is None and self.frame_anchors:
            self.unit = check.Unit(("frame", host))
        return copy_s

    def anchor_here(self) -> None:
        """Before the window: open it on a fresh episode, or let the next
        unit follow the current state (its watched field copied now)."""
        if self.episode:
            self.state, self.unit = None, None
        elif self.frame_anchors:
            self.unit = check.Unit(("frame", self.stepper.frame(self.state, self.field)))
        else:
            self.unit = None


def run(root, workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device=None, make_stepper=None, log=sys.stderr) -> dict:
    """One run → the result dict.  ``make_stepper(mesh, config, device,
    count_iters)`` replaces the program (the control and the tests)."""
    cell = spec.cell(root, workload)
    device = torch.device(device or "cuda")
    traffic, config = cell.traffic, cell.config
    workload_steps = spec.stepper(root, cell.workload)
    make_stepper = make_stepper or workload_steps.Program
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(device)

    mesh = workload_steps.mesh(config)
    stepper = make_stepper(mesh, config, device, trace)
    pool = []
    for start in workload_steps.starts(mesh, config, traffic, seed):
        on_device = {k: torch.as_tensor(v, device=device).to(stepper.dtype)
                     for k, v in start.items()}
        pool.append(on_device)
    pool_host = [{k: v.double().cpu().numpy() for k, v in s.items()} for s in pool]

    win = Window(stepper, pool, traffic, seed)
    win.set_up()
    if trace:
        with tracing.profiler(device):  # start the profiler's own machinery before the window
            win.frame(keep=False)
        win.anchor_here()
    _sync(device)

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    result = {"attempted": 0, "failed": 0}
    if trace:
        result["metrics"], busy, result["breakdown"], frames, steps, window_s = traced(
            root, cell, win, stepper, workload_steps.counts(mesh, config), log)
    else:
        frames_ms, t_prev = [], t0
        while True:
            win.frame()
            t = time.perf_counter()
            frames_ms.append((t - t_prev) * 1e3)
            t_prev = t
            if t - t0 >= seconds:
                break
        frames, window_s = len(frames_ms), t_prev - t0
        steps = frames * win.every
        e2e = {
            "steps_per_s": steps / window_s,
            "frame_ms_p90": (statistics.quantiles(frames_ms, n=10, method="inclusive")[-1]
                             if len(frames_ms) > 1 else frames_ms[0]),
            "setup_s": setup_s,
        }
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
        busy = {}
    result["attempted"] = frames
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(f"portbench: {workload} seed {seed}: {frames} frames, {steps} steps in "
          f"{window_s:.3f} s; set-up {setup_s:.3f} s", file=log)

    # the program's state goes before the reference takes the device
    units, offered = win.sample.kept, win.sample.seen
    del win, pool
    stepper.close()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    reference = workload_steps.reference(mesh, config, device)
    numbers = check.judge(units, pool_host, reference, traffic, stepper, workload_steps.compare)
    checks = {}
    for name, limit in cell.limits.items():
        value = numbers.get(name, float("inf"))  # a number nothing yielded fails
        checks[name] = {"value": value, "limit": limit}
    correct = bool(units) and all(
        np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result["failed"] = 0 if correct else 1
    print(f"portbench: the reference followed {len(units)} of {offered} units "
          f"in {time.perf_counter() - t_check:.3f} s", file=log)

    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak), **busy}
    out = {"correct": correct, **result, "device": device_info, "checks": checks}
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=log)
    return out


def traced(root, cell, win, stepper, counts, log):
    """The traced run: ``trace_frames`` frames timed by the host clock alone,
    then as many under the profiler, which records the device's timeline
    (kernels and copies, no host operators: the least it slows the host).
    Every per-layer metric reads the traced frames.  The untraced frames'
    wall time is printed beside the traced ones', as the tracer's cost.
    → (per-layer metrics, busy and window seconds, breakdown, frames,
    steps, window seconds)."""
    device, n = stepper.device, int(cell.traffic["trace_frames"])
    t0 = time.perf_counter()
    for _ in range(n):
        win.frame()
    _sync(device)
    untraced_s = time.perf_counter() - t0
    counter = getattr(stepper, "counter", None)
    if counter is not None:
        counter.zero_()
    copies_s = []
    with tracing.profiler(device) as prof:
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n):
            copies_s.append(win.frame())
        _sync(device)
        window_s = time.perf_counter() - t0
    steps = n * win.every
    counters = {}
    if counter is not None:
        counters["pressure_iters"] = int(counter.item())
    t = tracing.read(prof, steps, window_s, copies_s, counters, counts)
    print(f"portbench: {n} frames took {untraced_s:.6f} s untraced and {window_s:.6f} s "
          f"traced; busy {t.busy_s():.6f} s", file=log)
    metrics = {}
    for m in cell.per_layer:
        value = spec.reader(root, m["name"])(t)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    busy = {"busy_s": t.busy_s(), "window_s": window_s}
    return metrics, busy, tracing.breakdown(t), 2 * n, 2 * steps, window_s
