"""A portbench cell's set-up and traced window with ``tpufem_torch``'s spans
recorded, read by ``portbench/spans.py``: each device operation put down to
the span open at its launch, each idle gap to the host spans open during it.

    python3 span_window.py --workload stokes_1m.steady --seed N [--turns on,off,host]
    python3 span_window.py --config dye_410k --traffic movie --seed N
    python3 span_window.py --workload ns_1m.steady --seed N

On a CUDA device (``--device cpu`` runs the same code at whatever size the
configuration asks for; the CPU has no device timeline).  The cell runs as
``portbench/run.py --trace 1`` runs it: set-up (its phases timed, the
program's set-up spans recorded), ``trace_frames`` frames, then, for each
of ``--turns``, as many frames: under the benchmark's profiler with the
spans recorded (``on``) or not (``off``), or with the spans recorded and
no profiler (``host``: the host's own time, without the profiler's cost a
launch).  Each turn prints one JSON line: the window's wall seconds, the
cell's own per-layer metrics, and for ``on`` the six span metrics, the
checks of the attribution (the step's kernel time by part against
``step_device_ms``, idle time by span against ``device_idle_pct``,
operations without a launch record, the device clock's shift onto the
host's and the grid kernels against their launch spans, the copies and the
host's synchronisations by span, the kernels by span) and the breakdown;
for ``host`` the host time in ``stokes.run`` a step and the spans' self
time.  ``--out FILE`` also writes every line there.

Each line gives the window's ``stokes.graph_counts``.  Where the window
replayed a captured step, its kernels are launched in the ``step`` span and
the step's inner spans are not recorded, so the metrics that split a step
by them (``REPLAY_BLIND``) read None there.

A Navier–Stokes cell (``navier_stokes.run``, spans under ``ns.run``) splits
the step's kernel time by the NS step's own spans instead (``convection``,
``velocity_solve`` with K4's ``k4.launch``, ``div``, ``pressure_solve``
with K3's ``k3.launch``, ``grad``, ``walls``, ``step_metrics``) in
``step_parts``; its lines give ``ns``: the host milliseconds a step in
``ns.run``, K4's iterations a solve, the set-up's ``NSProblem.build``
seconds and the launches a step of the C(u) refill's kernels E and G
(``ops/ns_refill.py``'s counters); the span metrics that read the Stokes step's spans
(``STOKES_ONLY``) read None there.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
GRID_KERNELS = ("viscous_cg_kernel", "pressure_cg_kernel", "pressure_pb16_kernel",
                "ns_bicgstab_kernel")
LAUNCH_SPANS = ("k2.launch", "k3.launch", "k4.launch")
REPLAY_BLIND = ("k2_ms_per_step", "divgrad_ms_per_step", "glue_ms_per_step", "visc_iters")
NS_RUN = "ns.run"
STOKES_ONLY = ("host_enqueue_ms", "glue_ms_per_step", "visc_iters", "problem_build_s")


def cell_of(root: Path, args):
    """The cell named by ``--workload``, or one made of a configuration and
    a traffic file of ``portbench/`` that no cell pairs (no limits)."""
    from portbench import spec

    if args.workload:
        return spec.cell(root, args.workload)
    bench = spec.load_benchmark(root)
    config = json.loads((root / "portbench" / "configs" / f"{args.config}.json").read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{args.traffic}.json").read_text())
    return spec.Cell(name=f"{args.config}.{args.traffic}", workload=config["workload"], chips=1,
                     config=config, traffic=traffic, limits={},
                     end_to_end=[m for m in bench["end_to_end"] if "workloads" not in m],
                     per_layer=[m for m in bench["per_layer"] if "workloads" not in m])


def with_visc_counter(program, device):
    """K2's iteration counter on the program's viscous solver (the public
    ``iters_count`` field, as the benchmark sets K3's)."""
    import torch

    visc = getattr(program.problem, "visc_solver", None)
    if not hasattr(visc, "iters_count"):
        return None
    counter = torch.zeros(1, dtype=torch.int32, device=device)
    program.problem = dataclasses.replace(
        program.problem, visc_solver=dataclasses.replace(visc, iters_count=counter))
    return counter


def is_ns(sp) -> bool:
    return any(s[0] == NS_RUN for s in sp.spans)


def ns_parts(sp) -> dict:
    """Kernel milliseconds a step of a Navier–Stokes window by the part of
    the step whose span launched them (the step's own spans, ``step``
    itself for what none of them launched), and outside ``ns.run``."""
    from portbench import spans

    parts = {}
    for path, s in spans.kernel_s_by_path(sp).items():
        names = path.split("/")
        key = ("kernels_outside_run_ms_per_step" if names[0] != NS_RUN
               else "/".join(names[1:3]) or NS_RUN)
        parts[key] = parts.get(key, 0.0) + 1e3 * s / sp.steps
    return parts


def ns_line(sp, counters: dict) -> dict:
    """A Navier–Stokes window's own numbers: host milliseconds a step in
    ``ns.run``, K4's iterations a solve (one a step) and the set-up's
    ``NSProblem.build`` seconds.  Its kernel milliseconds by span are the
    checks' ``step_parts`` and ``device_ms_by_span``."""
    runs = [s[3] - s[2] for s in sp.spans if s[0] == NS_RUN]
    builds = [s[3] - s[2] for s in sp.setup if s[0] == "NSProblem.build"]
    k4 = counters.get("k4_iters")
    return {"host_ms_per_step": 1e3 * sum(runs) / sp.steps if runs else None,
            "k4_iters": None if k4 is None else k4 / sp.steps,
            "build_s": sum(builds) if builds else None}


def refill_launches() -> dict:
    """The launch counters of the C(u) refill's kernels E and G."""
    from tpufem_torch.ops import ns_refill

    return {"E": ns_refill.convection_flat.launches, "G": ns_refill.segment_sum.launches}


def checks(sp, layer: dict, replayed: bool) -> dict:
    """The attribution held to the cell's own readers of the same window."""
    from portbench import spans

    by_path, _ = spans.idle_split(sp)
    kernels = spans.kernel_s_by_path(sp)
    device_s = sum(op[2] - op[1] for op in sp.ops)
    if is_ns(sp):
        parts = ns_parts(sp)
    else:
        outside_run = sum(s for p, s in kernels.items() if p.split("/")[0] != spans.RUN)
        parts = {"k3_ms_per_step": layer.get("k3_ms_per_step"),
                 "k2_ms_per_step": spans.k2_ms_per_step(sp),
                 "divgrad_ms_per_step": spans.divgrad_ms_per_step(sp),
                 "glue_ms_per_step": spans.glue_ms_per_step(sp),
                 "kernels_outside_run_ms_per_step": 1e3 * outside_run / sp.steps}
    if replayed:
        parts.update({k: None for k in parts if k in REPLAY_BLIND})
    grid = [(op, i) for op, i in zip(sp.ops, sp.owner) if any(k in op[0] for k in GRID_KERNELS)]
    in_launch = [(op, i) for op, i in grid if i >= 0 and sp.spans[i][0] in LAUNCH_SPANS]
    copies, syncs, by_name = {}, {}, {}
    for op, i in zip(sp.ops, sp.owner):
        kind = next((k for k in ("HtoD", "DtoH") if k in op[0]), None)
        if kind:
            key = f"{kind} in {sp.path(i)}"
            copies[key] = copies.get(key, 0) + 1
        if op[3]:
            key = f"{sp.path(i)}: {op[0][:70]}"
            by_name[key] = by_name.get(key, 0.0) + op[2] - op[1]
    sync_calls = [c for c in sp.calls if "ynchronize" in c[0] or c[0] == "cudaMemcpy"]
    for c, i in zip(sync_calls, spans.innermost(sp.spans, [c[1] for c in sync_calls])):
        key = f"{sp.path(i)}: {c[0]}"
        syncs[key] = syncs.get(key, 0) + 1
    return {
        "step_parts": parts,
        "step_parts_sum": sum(v for k, v in parts.items() if v is not None
                              and k != "kernels_outside_run_ms_per_step"),
        "step_device_ms": layer.get("step_device_ms"),
        "idle_by_span_pct": {p: 100 * s / sp.window_s() for p, s in
                             sorted(by_path.items(), key=lambda kv: -kv[1])},
        "idle_sum_pct": 100 * sum(by_path.values()) / sp.window_s(),
        "device_idle_pct": layer.get("device_idle_pct"),
        "unpaired_device_pct": 100 * sum(op[2] - op[1] for op in sp.ops if op[4] is None)
        / device_s if device_s else None,
        "grid_kernels": len(grid),
        "grid_kernels_in_their_launch_span": len(in_launch),
        "grid_kernel_start_after_span_start_min_us": 1e6 * min(
            (op[1] - sp.spans[i][2] for op, i in in_launch), default=float("nan")),
        "launch_records": sorted({c[0] for c in sp.calls if "aunch" in c[0]}),
        "copies": copies,
        "host_syncs": syncs,
        "device_ms_by_span": {p: 1e3 * s / sp.steps for p, s in
                              sorted(kernels.items(), key=lambda kv: -kv[1])[:16]},
        "kernel_ms_by_span_and_name": {k: 1e3 * s / sp.steps for k, s in
                                       sorted(by_name.items(), key=lambda kv: -kv[1])[:16]},
    }


def emit(line: dict, out) -> None:
    text = json.dumps(line)
    print(text, flush=True)
    if out:
        out.write(text + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--turns", default="on")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", type=Path, default=ROOT, help="the checkout whose portbench/ to run")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not args.workload and not (args.config and args.traffic):
        ap.error("give --workload, or --config with --traffic")
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, spans, spec, tracing
    from tpufem_torch import metrics
    from tpufem_torch.workloads import stokes

    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    root = args.root
    cell = cell_of(root, args)
    steps_mod = spec.stepper(root, cell.workload)
    phases, t = {"imports": time.perf_counter() - T_START}, time.perf_counter()

    def phase(name):
        nonlocal t
        harness._sync(device)
        phases[name], t = time.perf_counter() - t, time.perf_counter()

    mesh = steps_mod.mesh(cell.config)
    phase("mesh")
    with metrics.recording() as setup:
        program = steps_mod.Program(mesh, cell.config, device, count_iters=True)
    visc_counter = with_visc_counter(program, device)
    phase("program")
    pool = [{k: torch.as_tensor(v, device=device).to(program.dtype) for k, v in s.items()}
            for s in steps_mod.starts(mesh, cell.config, cell.traffic, args.seed)]
    phase("starts")
    win = harness.Window(program, pool, cell.traffic, args.seed)
    win.set_up()
    phase("advance_and_warm_up")
    with tracing.profiler(device):
        win.frame(keep=False)
    win.anchor_here()
    n = int(cell.traffic["trace_frames"])
    for _ in range(n):
        win.frame()
    phase("profiler_warm_up_and_untraced_frames")
    setup_spans = spans.from_ns(setup.spans, setup.spans[0].start_ns if setup.spans else 0)
    yardstick = steps_mod.counts(mesh, cell.config)
    out = open(args.out, "a") if args.out else None
    for turn in args.turns.split(","):
        counters = {"pressure_iters": program.counter, "visc_iters": visc_counter,
                    "k4_iters": getattr(program, "k4_counter", None)}
        for c in counters.values():
            if c is not None:
                c.zero_()
        rec = metrics.SpanRecorder()
        copies_s, graph0, refills0 = [], dict(stokes.graph_counts), refill_launches()
        with tracing.profiler(device) if turn != "host" else contextlib.nullcontext() as prof:
            with metrics.recording(rec) if turn != "off" else contextlib.nullcontext():
                harness._sync(device)
                w0, t0 = time.time_ns(), time.perf_counter()
                for _ in range(n):
                    copies_s.append(win.frame())
                harness._sync(device)
                window_s, w1 = time.perf_counter() - t0, time.time_ns()
        steps = n * win.every
        graph = {k: stokes.graph_counts[k] - graph0[k] for k in graph0}
        line = {"cell": cell.name, "seed": args.seed, "turn": turn, "frames": n, "steps": steps,
                "window_s": window_s, "graph_counts": graph,
                "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
        if turn == "host":
            host = spans.from_ns(rec.spans, w0)
            hosted = spans.Spanned(steps=steps, window=(0.0, (w1 - w0) / 1e9), ops=[], spans=host)
            line["host_enqueue_ms"] = spans.host_enqueue_ms(hosted)
            if is_ns(hosted):
                line["ns_host_ms_per_step"] = ns_line(hosted, {})["host_ms_per_step"]
            line["host_self_ms_per_step"] = [[p, 1e3 * s / steps]
                                             for p, s in spans.host_self(host, 12)]
            emit(line, out)
            continue
        read = {k: int(c.item()) for k, c in counters.items() if c is not None}
        trace = tracing.read(prof, steps, window_s, copies_s, read, yardstick)
        layer = {m["name"]: spec.reader(root, m["name"])(trace) for m in cell.per_layer}
        ops, calls, z, shifts = spans.device_ops(prof)
        sp = spans.Spanned(steps=steps, window=((w0 - z) / 1e9, (w1 - z) / 1e9), ops=ops,
                           spans=spans.from_ns(rec.spans, z), setup=setup_spans,
                           counters=read, calls=calls)
        line["per_layer"] = layer
        if turn == "on":
            blind = (REPLAY_BLIND if graph["replays"] else ()) + (STOKES_ONLY if is_ns(sp) else ())
            line["span_metrics"] = {name: None if name in blind else f(sp)
                                    for name, f in spans.METRICS.items()}
            if is_ns(sp):
                line["ns"] = ns_line(sp, read)
                line["ns"]["refill_launches_per_step"] = {
                    k: (v - refills0[k]) / steps for k, v in refill_launches().items()}
            line["checks"] = {"device_clock_shifts_us": [1e6 * min(shifts, default=0.0),
                                                         1e6 * max(shifts, default=0.0)],
                              **checks(sp, layer, graph["replays"] > 0)}
            line["breakdown"] = spans.breakdown(sp)
            line["setup_s"] = phases
            line["setup_self"] = spans.host_self(setup_spans, 12)
        emit(line, out)
    if out:
        out.close()
    print(f"span_window: {time.perf_counter() - T_START:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
