"""Smoke test of the PyTorch/CUDA port (``tpufem_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device and the CUDA toolkit (``nvcc``); it imports no JAX.  Phases:

1. device: the card's name and power limit; TF32 off;
2. build: kernels K1 (``tpufem_torch/csrc/fused_step_matvec.cu``) and K2/K3
   (``tpufem_torch/csrc/grid_cg.cu``), one nvcc for each source, started
   together; K1's build report;
3. K1 against its plain version (``torch.addmv``) on the card, f32 and f64,
   at 2N = 1704 (the bench mesh), 700 (off the TPU's 128/256 tiles) and 6200 (near the top
   of the dense regime), with µs per call of both, and the kernel's
   scalar-tail and unstaged-x paths at three non-square shapes;
4. the main path: the bench configuration (squirmer Stokes, fused f32
   step on K1, ~10k tracers) for 1000 steps, twice, through
   ``StokesProblem.build`` and ``stokes.run``; K1 must do every step;
5. the card against the port's CPU path at f64 over 50 steps, and the f32
   card run against the f64 one;
6. semi-Lagrangian dye on the fused f32 path for 200 steps;
7. the K2/K3 build report: seconds, registers and spills per instance;
8. K2 and K3 against their plain versions on the card: f32 and f64 (and a
   bf16 coarse inverse for K3), fixed iterations and ``tol=1e-5`` from a
   warm start, at ``n_side=20`` (ragged 3×3 coarse blocks) and on the
   1,048,576-node operators of phase 9; rel L2, iterations and ms per solve
   of both, and two launches bit-equal;
9. the scale main path: ``bench_large.bench_config`` on
   ``generate_annulus_mesh(1024, 1088, pad_hole=True)`` (1,048,576 nodes,
   f32, two-level, tol 1e-5, bf16 coarse) through ``StokesProblem.build``
   and ``stokes.run``: 200 steps from rest, then 200 steps of steady
   continuation; K2 must run once a step and K3 twice; tpufem's physics
   gates;
10. the grid path at f64 on the card (kernels) against the port's CPU path
    (plain versions) at ``n_side=40`` over 10 steps, fixed iterations and
    then tol 1e-5 with warm starts; f32 on the card against f64;
11. tracers on the scale path at 78,400 nodes for 200 steps.

Any failed check raises, so the exit code is not 0.  The line before the
last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import sys
import time

import numpy as np
import torch

from tpufem_torch import bench_large
from tpufem_torch.bench import bench_config, bench_mesh, card, timed_run
from tpufem_torch.mesh import generate_annulus_mesh
from tpufem_torch.ops import _nvcc
from tpufem_torch.ops import fused_matvec as fm
from tpufem_torch.solve import grid_cg
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
SCALE_MESH = (1024, 1088)  # 1,048,576 nodes, bench_large's "1.05M"
SCALE_STEPS = 200
SCALE_PARITY_MESH = (40, 48)
SCALE_PARITY_STEPS = 10
TRACER_MESH = (280, 320)  # 78,400 nodes
TRACER_STEPS = 200
# K2/K3 against their plain versions, relative L2 of the solution.  At
# f64 the two differ in summation order only.  At f32 the difference is
# float32 roundoff amplified by the iterations.  With tol > 0 the two may
# also stop one iteration apart, which moves the result within the
# solve's tolerance.
GRID_RTOL = {(torch.float64, 0.0): 1e-9, (torch.float64, 1e-5): 1e-5,
             (torch.float32, 0.0): 1e-3, (torch.float32, 1e-5): 1e-3}


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


def ptxas_report(path) -> str:
    report = path.with_suffix(".log").read_text()
    regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", report)})
    spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", report))
    return f"registers per instance {regs}, spill stores {spills} bytes"


def phase_build() -> float:
    """Build both kernel libraries at once; returns the seconds it took."""
    t0 = time.perf_counter()
    _nvcc.build_all([fm.SOURCE, grid_cg.SOURCE])
    fm.build()
    grid_cg.build()
    seconds = time.perf_counter() - t0
    print(f"[2 build] K1 from {fm.SOURCE.relative_to(_nvcc.PKG.parent)} and K2/K3 from "
          f"{grid_cg.SOURCE.relative_to(_nvcc.PKG.parent)} in parallel: {seconds:.2f} s; "
          f"K1 {ptxas_report(fm.library_path())}")
    return seconds


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


def phase_grid_build(seconds: float) -> None:
    print(f"[7 build] K2/K3 ({grid_cg.library_path().name}) within the {seconds:.2f} s "
          f"parallel build: {ptxas_report(grid_cg.library_path())}")


def scale_problem(dev, n_side: int, n_circle: int, **overrides):
    mesh = generate_annulus_mesh(n_side=n_side, n_circle=n_circle, pad_hole=True)
    cfg = bench_large.bench_config(n_nodes=mesh.n_nodes, storage="grid", **overrides)
    return stokes.StokesProblem.build(mesh, cfg, device=dev)


def solver_variants(problem, dtype):
    """The problem's K2 and K3 solvers with fields and operators cast to
    ``dtype``: [(label, solver, rhs planes)], K3 once with the problem's
    own coarse inverse dtype and, at f32, also with a float32 one."""
    visc, pres = problem.visc_solver, problem.pressure_solver
    K = visc.K.astype(dtype)
    v = dataclasses.replace(visc, K=K, interior_mask=visc.interior_mask.to(dtype))
    base = dict(K=pres.K.astype(dtype), m_lumped=pres.m_lumped.to(dtype),
                active_mask=pres.active_mask.to(dtype), master_mask=pres.master_mask.to(dtype),
                slave_mask=pres.slave_mask.to(dtype))
    coarse = [pres.ac_inv.dtype] if dtype == torch.float64 else [torch.bfloat16, torch.float32]
    if dtype == torch.float64 and pres.ac_inv.dtype == torch.bfloat16:
        coarse = [torch.float64]
    out = [("K2", v, 2)]
    for cd in coarse:
        out.append((f"K3 coarse {str(cd)[6:]}",
                    dataclasses.replace(pres, ac_inv=pres.ac_inv.to(cd), **base), 1))
    return out


def solve_timed_ms(fn, solver, b, x0, calls: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn(solver, b, x0)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def check_grid_kernels(label: str, problem, dev, calls: int, plain_calls: int) -> dict:
    """K2/K3 against their plain versions on ``problem``'s operators; returns
    {kernel: numbers} for the f32, tol 1e-5 case."""
    rng = np.random.default_rng(7)
    ns = problem.visc_solver.K.ns
    at_main = {}
    for dtype in (torch.float32, torch.float64):
        for name, solver, cols in solver_variants(problem, dtype):
            kernel, plain = ((grid_cg.viscous_cg, grid_cg.viscous_cg_ref) if name == "K2"
                             else (grid_cg.pressure_cg, grid_cg.pressure_cg_ref))
            shape = (cols, ns, ns) if name == "K2" else (ns, ns)
            b = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)
            if name != "K2":
                b = b * solver.act_grid  # a prepared rhs: zero off the active dofs
            for tol in (0.0, 1e-5):
                s = dataclasses.replace(solver, tol=tol)
                x0 = torch.zeros_like(b)
                if tol:
                    # warm start: the fixed-iteration solution of a nearby rhs
                    x0 = plain(dataclasses.replace(solver, tol=0.0),
                               b * (1 + 1e-3 * torch.randn_like(b)), torch.zeros_like(b))
                it_k = torch.zeros(1, dtype=torch.int32, device=dev)
                it_p = torch.zeros(1, dtype=torch.int32, device=dev)
                y1 = kernel(s, b, x0, it_k)
                y2 = kernel(s, b, x0)
                want = plain(s, b, x0, it_p)
                torch.cuda.synchronize()
                same = bool(torch.equal(y1, y2))
                err = rel(y1, want)
                max_abs = float((y1 - want).abs().max())
                ms = solve_timed_ms(kernel, s, b, x0, calls)
                plain_ms = solve_timed_ms(plain, s, b, x0, plain_calls)
                rtol = GRID_RTOL[(dtype, tol)]
                case = f"{name} {str(dtype)[6:]} tol {tol:g} at {label}"
                print(f"[8 kernel] {case}: rel L2 {err:.3e} (<= {rtol:g}), max abs {max_abs:.3e}, "
                      f"iterations kernel {int(it_k.item())} plain {int(it_p.item())}, "
                      f"ms per solve kernel {ms:.3f} plain {plain_ms:.3f}, repeat bit-equal {same}")
                check(same, f"{case}: two launches differ")
                check(err <= rtol, f"{case}: rel L2 {err} > {rtol}")
                if dtype == torch.float32 and tol and name in ("K2", "K3 coarse bfloat16"):
                    at_main[name[:2]] = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}
    return at_main


def phase_grid_kernels(dev, big_problem) -> dict:
    small = scale_problem(dev, 20, 24, cg_coarse_nodes=64)
    check(small.pressure_solver.block == 3 and small.pressure_solver.n_blocks == 7,
          "n_side=20 with cg_coarse_nodes=64 gives ragged 3×3 blocks")
    check_grid_kernels("n_side=20", small, dev, calls=20, plain_calls=5)
    return check_grid_kernels(f"{big_problem.mesh.n_nodes} nodes", big_problem, dev,
                              calls=5, plain_calls=2)


def phase_scale_main_path(problem, build_s: float, steps: int = SCALE_STEPS) -> dict:
    """The scale configuration through the user's entry points; returns the
    launch counts of K2 and K3 over both runs."""
    problem, counters = bench_large.with_iteration_counters(problem)
    grid_cg.viscous_cg.launches = 0
    grid_cg.pressure_cg.launches = 0
    cold, state, metrics, warm, state2 = bench_large.run_problem(problem, steps)
    launches = {"K2": grid_cg.viscous_cg.launches, "K3": grid_cg.pressure_cg.launches}
    iters = bench_large.iterations_per_solve(counters, 2 * steps)
    check(launches == {"K2": 2 * steps, "K3": 4 * steps},
          f"launches {launches} in two {steps}-step runs (want K2 = steps, K3 = 2·steps)")
    for k, v in {**state, **state2, **metrics}.items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"{k} is finite")
    phys = bench_large.physics_report(problem, state, metrics, steps)  # raises on a failed gate
    planes = (len(problem.visc_solver.K.offsets), len(problem.pressure_solver.K.offsets))
    print(f"[9 scale main path] {problem.mesh.n_nodes} nodes ({planes[0]} viscous and "
          f"{planes[1]} pressure planes), {steps}+{steps} steps: build {build_s:.1f} s, cold "
          f"{cold:.2f} steps/s, warm {warm:.2f} steps/s; launches {launches}; mean iterations "
          f"per solve {iters}; {json.dumps(phys)}")
    return launches


def phase_scale_parity(dev, steps: int = SCALE_PARITY_STEPS) -> None:
    """The grid path: f64 kernels on the card against the plain versions on
    the CPU, fixed iterations and then tol 1e-5 warm; f32 card against f64."""
    n_side, n_circle = SCALE_PARITY_MESH
    for tols in ((0.0, 0.0), (1e-5, 1e-5)):
        kw = dict(cg_tol_pressure=tols[0], cg_tol_visc=tols[1])
        runs = {}
        for name, device, precision in (("gpu64", dev, "f64"), ("cpu64", torch.device("cpu"), "f64"),
                                        ("gpu32", dev, "f32")):
            problem = scale_problem(device, n_side, n_circle, precision=precision, **kw)
            runs[name], _ = stokes.run(problem, steps=steps)
        g, c, f = (runs[k]["u"].double().cpu() for k in ("gpu64", "cpu64", "gpu32"))
        du = float((g - c).abs().max())
        df = rel(f, g)
        print(f"[10 scale parity] n_side={n_side}, {steps} steps, tol {tols[0]:g}: f64 card "
              f"vs CPU max abs du {du:.3e} (<= 1e-6), u rel {rel(g, c):.3e}; f32 vs f64 card "
              f"u rel {df:.3e} (<= 5e-3)")
        check(du <= 1e-6, f"f64 card vs CPU max abs du {du}")
        check(df <= 5e-3, f"f32 vs f64 card u rel {df}")


def phase_scale_tracers(dev, steps: int = TRACER_STEPS) -> None:
    n_side, n_circle = TRACER_MESH
    problem = scale_problem(dev, n_side, n_circle, transport="tracers")
    state, metrics = stokes.run(problem, steps=steps)
    for k, v in {**state, **metrics}.items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"{k} is finite")
    n_tr = problem.tracer_init.shape[0]
    frac = float(metrics["eaten"][-1]) / n_tr
    check(0.0 <= frac <= 1.0, f"captured fraction {frac} in [0, 1]")
    print(f"[11 scale tracers] {problem.mesh.n_nodes} nodes, {n_tr} tracers, {steps} steps: "
          f"max|u| {float(metrics['max_u'].max()):.4f}, captured {frac:.4f}")


def main() -> None:
    dev = phase_device()
    build_s = phase_build()
    at_main = phase_kernel(dev)
    mesh = bench_mesh()
    launches = phase_main_path(dev, mesh)
    phase_parity(dev, mesh)
    phase_dye(dev, bench_mesh("mesh.1", fallback=(20, 24)))
    phase_grid_build(build_s)
    t0 = time.perf_counter()
    big = scale_problem(dev, *SCALE_MESH)
    torch.cuda.synchronize()
    big_build_s = time.perf_counter() - t0
    grid_main = phase_grid_kernels(dev, big)
    grid_launches = phase_scale_main_path(big, big_build_s)
    phase_scale_parity(dev)
    phase_scale_tracers(dev)
    kernels = [{
        "name": "fused_step_matvec",
        "route": "cuda",
        "source": "tpufem_torch/csrc/fused_step_matvec.cu",
        "replaces": "tpufem/ops/pallas_kernels.py:31",
        "launches": launches,
        **at_main,
    }]
    for key, name, replaces in (("K2", "viscous_cg", "tpufem/solve/pallas_cg.py:825"),
                                ("K3", "pressure_cg", "tpufem/solve/pallas_cg.py:1275")):
        kernels.append({"name": name, "route": "cuda", "source": "tpufem_torch/csrc/grid_cg.cu",
                        "replaces": replaces, "launches": grid_launches[key], **grid_main[key]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
