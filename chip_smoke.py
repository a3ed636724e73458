"""Smoke test of the PyTorch/CUDA port (``tpufem_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device and the CUDA toolkit (``nvcc``); it imports no JAX.  Phases:

1. device: the card's name and power limit; TF32 off;
2. build: kernel K1 (``tpufem_torch/csrc/fused_step_matvec.cu``) with nvcc;
3. K1 against its plain version (``torch.addmv``) on the card, f32 and f64,
   at 2N = 1704 (the bench mesh), 700 (off the TPU's 128/256 tiles) and 6200 (near the top
   of the dense regime), with µs per call of both, and the kernel's
   scalar-tail and unstaged-x paths at three non-square shapes;
4. the main path: the bench configuration (squirmer Stokes, fused f32
   step on K1, ~10k tracers) for 1000 steps, twice, through
   ``StokesProblem.build`` and ``stokes.run``; K1 must do every step;
5. the card against the port's CPU path at f64 over 50 steps, and the f32
   card run against the f64 one;
6. semi-Lagrangian dye on the fused f32 path for 200 steps.

Any failed check raises, so the exit code is not 0.  The line before the
last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import sys
import time

import numpy as np
import torch

from tpufem_torch.bench import bench_config, bench_mesh, card, timed_run
from tpufem_torch.ops import fused_matvec as fm
from tpufem_torch.workloads import stokes

MAX_U_FACTOR = 1.25  # boundedness gate of tpufem/bench_large.py: max|u| < 1.25·(|B1|+|B2|)
KERNEL_SHAPES = (1704, 700, 6200)  # 2N of the bench mesh, an off-tile size, 2N at 3,100 nodes
# checked, not timed: the scalar-tail path (C not a multiple of the 16-byte
# vector) and the path that reads x from L2 (C over the 48 KB staging limit)
KERNEL_EDGE_SHAPES = ((1703, 1701), (256, 13000), (256, 13001))
KERNEL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # relative L2 against torch.addmv
TIMED_CALLS = 200
MAIN_STEPS = 1000
PARITY_STEPS = 50
DYE_STEPS = 200


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def per_call_ms(fn, *args, calls: int = TIMED_CALLS) -> float:
    """Mean ms per call of ``calls`` back-to-back calls, by CUDA events."""
    for _ in range(10):
        fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(fn, *args, calls: int = TIMED_CALLS, replays: int = 5) -> float:
    """Mean device ms per call: ``calls`` calls captured in one CUDA graph
    and replayed, so the host's launch cost is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn(*args)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke test runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card())
    print(f"[1 device] {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return torch.device("cuda", 0)


def phase_build() -> None:
    t0 = time.perf_counter()
    fm.build()
    seconds = time.perf_counter() - t0
    report = fm.library_path().with_suffix(".log").read_text()
    regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", report)})
    spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", report))
    print(f"[2 build] K1 from {fm.SOURCE.relative_to(fm.SOURCE.parents[2])}: {seconds:.2f} s; "
          f"registers per instance {regs}, spill stores {spills} bytes")


def phase_kernel(dev: torch.device) -> dict:
    """K1 against torch.addmv; returns the numbers at the main path's shape."""
    rng = np.random.default_rng(0)
    at_main = {}
    for r, c in [(n, n) for n in KERNEL_SHAPES] + list(KERNEL_EDGE_SHAPES):
        for dtype, rtol in KERNEL_RTOL.items():
            M, x, b = (torch.as_tensor(a, dtype=dtype, device=dev)
                       for a in (rng.standard_normal((r, c)), rng.standard_normal(c),
                                 rng.standard_normal(r)))
            y = fm.fused_step_matvec(M, x, b)
            want = fm.fused_step_matvec_ref(M, x, b)
            torch.cuda.synchronize()
            err = rel(y, want)
            max_abs = float((y - want).abs().max())
            name = f"K1 {r}x{c} {str(dtype)[6:]}"
            check(err <= rtol, f"{name}: rel L2 {err} > {rtol}")
            line = f"[3 kernel] {name}: rel L2 {err:.3e} (<= {rtol:g}), max abs {max_abs:.3e}"
            if (r, c) in KERNEL_EDGE_SHAPES:
                print(line)
                continue
            k1 = (per_call_ms(fm.fused_step_matvec, M, x, b), device_ms(fm.fused_step_matvec, M, x, b))
            plain = (per_call_ms(fm.fused_step_matvec_ref, M, x, b),
                     device_ms(fm.fused_step_matvec_ref, M, x, b))
            print(f"{line}; us/call eager loop K1 {k1[0] * 1e3:.2f} addmv {plain[0] * 1e3:.2f}, "
                  f"device (graph replay) K1 {k1[1] * 1e3:.2f} addmv {plain[1] * 1e3:.2f}")
            if r == KERNEL_SHAPES[0] and dtype == torch.float32:
                at_main = {"max_abs_err": max_abs, "ms": k1[1], "plain_ms": plain[1]}
    return at_main


def jittered(problem, dtype, dev, seed: int = 42, sigma: float = 1e-3):
    """The initial state with the tracer lattice moved off the mesh edges,
    where containment is a knife-edge tie."""
    state = stokes.initial_state(problem)
    pts = problem.tracer_init + sigma * np.random.default_rng(seed).standard_normal(
        problem.tracer_init.shape)
    state["tracers"] = torch.as_tensor(pts, dtype=dtype, device=dev)
    return state


def phase_main_path(dev: torch.device, mesh, steps: int = MAIN_STEPS) -> int:
    """The bench configuration through the user's entry points; returns
    K1's launch count over both runs."""
    cfg = bench_config()
    problem = stokes.StokesProblem.build(mesh, cfg, device=dev)
    n_tracers = problem.tracer_init.shape[0]
    fm.fused_step_matvec.launches = 0
    cold, _, _ = timed_run(problem, steps)
    check(fm.fused_step_matvec.launches == steps,
          f"K1 launched {fm.fused_step_matvec.launches} times in a {steps}-step run")
    warm, state, metrics = timed_run(problem, steps)
    launches = fm.fused_step_matvec.launches
    check(launches == 2 * steps, f"K1 launched {launches} times in two {steps}-step runs")
    for k, v in {**state, **metrics}.items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"{k} is finite")
    u_cap = MAX_U_FACTOR * (abs(cfg.B1) + abs(cfg.B2))
    max_u = float(metrics["max_u"].max())
    check(max_u < u_cap, f"max|u| {max_u} < {u_cap}")
    div0, div_end = float(metrics["div_star_max"][0]), float(metrics["final_div_max"][-1])
    check(div_end < div0, f"last final_div_max {div_end} < first div_star_max {div0}")
    frac = float(metrics["eaten"][-1]) / n_tracers
    print(f"[4 main path] {mesh.n_nodes} nodes, {n_tracers} tracers, {steps} steps: "
          f"cold {cold:.1f} steps/s, warm {warm:.1f} steps/s; K1 launches {launches}; "
          f"max|u| {max_u:.4f}; div* {div0:.3e} -> final {div_end:.3e}; "
          f"captured {frac:.4f}")
    return launches


def phase_parity(dev: torch.device, mesh, steps: int = PARITY_STEPS) -> None:
    """f64 on the card against f64 on the CPU; f32 on the card against f64."""
    runs = {}
    for name, device, precision in (("gpu64", dev, "f64"), ("cpu64", torch.device("cpu"), "f64"),
                                    ("gpu32", dev, "f32")):
        problem = stokes.StokesProblem.build(mesh, bench_config(precision=precision),
                                             device=device)
        dtype = problem.dtype
        state, metrics = stokes.run(problem, steps=steps,
                                    state=jittered(problem, dtype, device))
        runs[name] = (state, metrics, problem.tracer_init.shape[0])
    g, c, f = runs["gpu64"][0], runs["cpu64"][0], runs["gpu32"][0]
    du = rel(g["u"], c["u"])
    dp = float((g["tracers"].cpu() - c["tracers"]).abs().max())
    same = bool(torch.equal(g["tracer_status"].cpu(), c["tracer_status"]))
    df = rel(f["u"], g["u"])
    n_tr = runs["gpu64"][2]
    frac = {k: float(v[1]["eaten"][-1]) / n_tr for k, v in runs.items()}
    print(f"[5 parity] {steps} steps f64 card vs CPU: u rel {du:.3e} (<= 1e-10), "
          f"tracers max abs {dp:.3e} (<= 1e-8), status equal {same}; "
          f"f32 vs f64 card: u rel {df:.3e} (<= 5e-3), captured {frac['gpu32']:.4f} "
          f"vs {frac['gpu64']:.4f}")
    check(du <= 1e-10, f"f64 u card vs CPU rel {du}")
    check(dp <= 1e-8, f"f64 tracers card vs CPU max abs {dp}")
    check(same, "tracer_status card vs CPU")
    check(df <= 5e-3, f"f32 u vs f64 rel {df}")
    check(abs(frac["gpu32"] - frac["gpu64"]) <= 0.05, "f32 captured fraction within 0.05 of f64")


def phase_dye(dev: torch.device, mesh, steps: int = DYE_STEPS) -> None:
    cfg = stokes.StokesConfig(transport="dye", solver="inverse", precision="f32",
                              pressure_mode="merge", fused=True, matvec_impl="pallas")
    problem = stokes.StokesProblem.build(mesh, cfg, device=dev)
    state, metrics = stokes.run(problem, steps=steps)
    c = state["c"]
    lo, hi = float(c.min()), float(c.max())
    prog = metrics["mixing_progress"]
    check(lo >= -1e-6 and hi <= 1 + 1e-6, f"dye in [-1e-6, 1+1e-6]: [{lo}, {hi}]")
    check(bool(torch.isfinite(prog).all()), "mixing_progress is finite")
    print(f"[6 dye] {mesh.n_nodes} nodes, {steps} steps: c in [{lo:.3e}, {hi:.6f}], "
          f"mixing progress {float(prog[-1]):.4f}")


def main() -> None:
    dev = phase_device()
    phase_build()
    at_main = phase_kernel(dev)
    mesh = bench_mesh()
    launches = phase_main_path(dev, mesh)
    phase_parity(dev, mesh)
    phase_dye(dev, bench_mesh("mesh.1", fallback=(20, 24)))
    print(json.dumps({"kernels": [{
        "name": "fused_step_matvec",
        "route": "cuda",
        "source": "tpufem_torch/csrc/fused_step_matvec.cu",
        "replaces": "tpufem/ops/pallas_kernels.py:31",
        "launches": launches,
        **at_main,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
