"""Parent against change of kernel K2 in one process on one card, and the
other grid kernels (K3, K4, K5) bit-equal to the parent's.

Run from the root of a checkout on a machine with the card, with a copy of
the parent commit's sources in a directory the tree ignores:

    mkdir -p _checkout/parent
    for f in grid_cg.cu grid_common.cuh grid_step.cu; do
        git show <parent>:tpufem_torch/csrc/$f > _checkout/parent/$f
    done
    python3 ab_grid_kernels.py --parent _checkout/parent [--check-only]

It builds the parent's ``grid_cg.cu`` and ``grid_step.cu`` (with its
``grid_common.cuh``) beside the tree's, both at once; then

* checks: each library's K2 against its plain version from zero on the
  Taylor–Hood velocity operator of n_side 192 (TH-192) at the engine's
  288-iteration cap (f32 fixed, f64 with the engine's tolerance) and, 30
  fixed iterations, on the 1,048,576-node viscous operator (f32), and two
  launches bit-equal; K3, K4 and K5 of the parent's and the tree's
  libraries bit-equal at ``n_side=40`` (f32 and f64) and K3 on the
  1,048,576-node NS pressure operator (f32);
* times (f32), the libraries in turns parent, change, change, parent: K2
  ms an iteration (the difference of fixed solves of 288 and 144
  iterations) against its byte bound, and ms a warm solve, at TH-192 and
  at 1,048,576 nodes; then TH-192 warm steps/s at ``vel_restarts`` 0 and 1
  (``bench_large.run_th_sparse``, with its profile and K2's iterations a
  step), parent, change, change, parent.

Its tolerances, and the functions that make its problems, are the card
suite's (``tests/_card.py``).  It prints the card's name and power limit first and
last, and writes the numbers to ``chiprun_out/ab_grid_kernels.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))  # the card suite's helpers
from _card import (BIG, GRID_RTOL, TH_RTOL, TH_TOL_INNER, k3_cast, k5_cast, k5_problem,  # noqa: E402
                   k5_state, ns_grid, ns_operator, ns_solver, rel, stokes_grid)
from tpufem_torch import bench_large  # noqa: E402
from tpufem_torch.bench import card  # noqa: E402
from tpufem_torch.ops import _nvcc
from tpufem_torch.roofline import iteration_bound
from tpufem_torch.solve import grid_cg
from tpufem_torch.solve import grid_step as gs
from tpufem_torch.workloads import stokes, th_sparse

TH_SIDE = 192
TH_ITERS = 288  # the engine's velocity cap at n_side 192
SCALE_ITERS = 30  # the Scale cell's viscous cap
TH_STEPS = 10
OUT = Path("chiprun_out")


def use(libs: dict, label: str) -> None:
    """Make ``label``'s libraries the ones the wrappers launch.  The tree's
    K2 wrapper launches the parent's K2 too (the same C entry)."""
    grid_cg._lib, gs._lib = libs[label]


def solve_ms(fn, solver, b, x0, calls: int) -> float:
    """ms a call of ``fn(solver, b, x0)`` over ``calls`` calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn(solver, b, x0)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def k2_cases(th, scale, dev) -> dict:
    """{case: (solver, b, warm start, warm solver)} of K2 (f32, both
    columns) at TH-192 and on the Scale cell's viscous operator; the warm
    starts are plain solves of a perturbed rhs."""
    rng = np.random.default_rng(11)
    out = {}
    for name, solver, iters, tol in (("TH-192", th.vel_solver, TH_ITERS, 1e-6),
                                     ("1,048,576 nodes", scale.visc_solver, SCALE_ITERS, 1e-5)):
        ns = solver.K.ns
        s = dataclasses.replace(solver, iters=iters, tol=0.0, iters_count=None)
        b = torch.as_tensor(rng.standard_normal((2, ns, ns)), dtype=torch.float32,
                            device=dev) * s.mask_grid
        x0 = grid_cg.viscous_cg_ref(dataclasses.replace(s, iters=60),
                                    b * (1 + 1e-3 * torch.randn_like(b)), torch.zeros_like(b))
        out[name] = (s, b, x0, dataclasses.replace(s, tol=tol))
    return out


def check_k2(libs: dict, cases: dict) -> None:
    """Every library's K2 against its plain version from zero: at TH-192 its
    288-iteration cap at f32 (fixed, TH_RTOL 1e-3) and at f64 with the
    engine's tol_inner (TH_RTOL 1e-6; it runs to the cap), at 1,048,576
    nodes 30 fixed iterations (f32, GRID_RTOL 1e-3); repeats bit-equal.
    The f64 solve at 288 fixed iterations is printed beside, not gated: CG
    that far short of convergence on this operator parts two summation
    orders by ~1e-8."""
    for case, (s32, b32, _, _) in cases.items():
        runs = [(torch.float32, 0.0, True)]
        if case == "TH-192":
            runs += [(torch.float64, TH_TOL_INNER[torch.float64], True), (torch.float64, 0.0, False)]
        for dtype, tol, gated in runs:
            s = dataclasses.replace(s32, K=s32.K.astype(dtype), tol=tol,
                                    interior_mask=s32.interior_mask.to(dtype))
            b = b32.to(dtype)
            it_p = torch.zeros(1, dtype=torch.int32, device=b.device)
            want = grid_cg.viscous_cg_ref(s, b, torch.zeros_like(b), it_p)
            lim = (TH_RTOL if case == "TH-192" else GRID_RTOL)[(dtype, tol)]
            parts = []
            for label in libs:
                use(libs, label)
                it = torch.zeros(1, dtype=torch.int32, device=b.device)
                got = grid_cg.viscous_cg(s, b, torch.zeros_like(b), it)
                again = grid_cg.viscous_cg(s, b, torch.zeros_like(b))
                err = rel(got, want)
                parts.append(f"{label} {err:.3e} ({int(it.item())} it.)")
                if not torch.equal(got, again):
                    raise RuntimeError(f"K2 {label} {case} {dtype}: repeats differ")
                if gated and not err <= lim:
                    raise RuntimeError(f"K2 {label} {case} {dtype} tol {tol}: rel {err}")
            print(f"[check] K2 {str(dtype)[6:]} {case}, at most {s.iters} iterations from zero, tol "
                  f"{tol:g} (plain {int(it_p.item())} it.), rel L2 to the plain version "
                  + (f"(<= {lim:g})" if gated else "(not gated)")
                  + ", repeats bit-equal: " + ", ".join(parts))


def bit_equal(libs: dict, dev, ns_big) -> None:
    """K3, K4 and K5 of the parent's and the tree's libraries on the same
    inputs, bit for bit."""
    rng = np.random.default_rng(40)
    small, ns_small = stokes_grid(dev, 40, 48), ns_grid(dev, 40, 48)
    cases = 0

    def same(what: str, run) -> None:
        nonlocal cases
        ys = []
        for label in ("parent", "change"):
            use(libs, label)
            out = run()
            ys.append(out if isinstance(out, tuple) else (out,))
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip(*ys)):
            raise RuntimeError(f"{what}: parent and change differ")
        cases += 1

    for dtype, coarses in ((torch.float32, (torch.bfloat16, torch.float32)),
                           (torch.float64, (torch.float64,))):
        for coarse in coarses:
            solver = k3_cast(small.pressure_solver, dtype, coarse)
            ns = solver.K.ns
            b = torch.as_tensor(rng.standard_normal((ns, ns)), dtype=dtype, device=dev)
            b = b * solver.act_grid
            for tol in (0.0, 1e-5):
                s = dataclasses.replace(solver, tol=tol)
                same(f"K3 {dtype} coarse {coarse} tol {tol}",
                     lambda s=s, b=b: grid_cg.pressure_cg(s, b, torch.zeros_like(b)))
        op, mask, invd, u, b_step = ns_operator(ns_small, dtype)
        b = torch.as_tensor(rng.standard_normal(tuple(u.shape)), dtype=dtype, device=dev)
        for tol, rhs, x0 in ((0.0, b, torch.zeros_like(u)), (1e-5, b_step, u)):
            s = ns_solver(ns_small, op, iters=30, tol=tol)
            same(f"K4 {dtype} tol {tol}",
                 lambda s=s, rhs=rhs, x0=x0: grid_cg.ns_bicgstab(s, op, mask, invd, rhs, x0))
    pres = ns_big.pressure_solver
    b = torch.as_tensor(rng.standard_normal((pres.K.ns, pres.K.ns)), dtype=pres.K.dtype,
                        device=dev) * pres.act_grid
    same("K3 on the NS pressure operator", lambda: grid_cg.pressure_cg(pres, b, torch.zeros_like(b)))
    k5 = k5_problem(dev, 40, 48)
    state, _ = stokes.run(k5, steps=3)
    for dtype in (torch.float32, torch.float64):
        coarse = k5.grid_step.pressure.ac_inv.dtype if dtype == torch.float32 else torch.float64
        for tol in (0.0, 1e-5):
            step = k5_cast(k5.grid_step, dtype, coarse, tol)
            args = k5_state(step, state, dtype)
            same(f"K5 {dtype} tol {tol}",
                 lambda step=step, args=args: tuple(gs.grid_step(step, *args)))
    print(f"[check] K3, K4 and K5: parent and change bit-equal in all {cases} cases (n_side=40 "
          f"f32 and f64, fixed and tol 1e-5; K3 on the {ns_big.mesh.n_nodes}-node NS pressure "
          f"operator)")


def iteration_ms(solver, b, iters: int, calls: int = 5) -> float:
    """K2's ms an iteration: fixed-iteration solves from zero of ``iters``
    and ``iters // 2`` iterations, the difference."""
    x0 = torch.zeros_like(b)
    t = [solve_ms(grid_cg.viscous_cg, dataclasses.replace(solver, iters=k, tol=0.0), b, x0, calls)
         for k in (iters, iters // 2)]
    return (t[0] - t[1]) / (iters - iters // 2)


def k2_times(label: str, cases: dict) -> dict:
    """K2's ms an iteration (from solves of 288 and 144 iterations, at
    TH-192 the engine's cap) and ms a warm solve."""
    out = {}
    for case, (s, b, x0, warm_solver) in cases.items():
        k2 = grid_cg.viscous_cg
        ms = iteration_ms(s, b, TH_ITERS)
        it = torch.zeros(1, dtype=torch.int32, device=b.device)
        k2(warm_solver, b, x0, it)
        warm = solve_ms(k2, warm_solver, b, x0, 5)
        bd = iteration_bound("K2", s.K, 2)
        out[case] = {"ms_per_iteration": ms, "warm_solve_ms": warm,
                     "warm_solve_iterations": int(it.item()), "bound_ms": bd}
        print(f"[time] {label} K2 at {case} ({len(s.K.offsets)} planes, {s.K.n_rest} remainder "
              f"entries): {ms:.5f} ms an iteration, bound {bd:.5f} ({100 * bd / ms:.1f} %), warm "
              f"solve {warm:.4f} ms ({int(it.item())} iterations, tol {warm_solver.tol:g})")
    return out


def th_row(label: str, base, restarts: int, dev) -> dict:
    row = bench_large.run_th_sparse(TH_SIDE, TH_SIDE, TH_STEPS, precision="f32",
                                    engine="grid", vel_restarts=restarts, device=dev, base=base)
    prof = row["profile_of_warm_run"]
    print(f"[th] {label} vel_restarts={restarts}: warm {row['warm_steps_per_sec']:.3f} steps/s "
          f"(timed {row['steps_per_sec']:.3f}); K2 {row['launches_per_step']['K2']:.1f} launches "
          f"and {row['iters_per_step']['K2']:.1f} iterations a step ({row['warm_iters_per_step']['K2']:.1f} "
          f"in the warm run); device "
          f"{prof['device_ms_per_step']:.3f} ms a step, K2 {100 * prof['K2_share']:.1f} %, K3 "
          f"{100 * prof['K3_share']:.1f} %; weak divergence {row['th_div_weak_max']:.3e}")
    return row


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, required=True,
                        help="directory with the parent's grid_cg.cu, grid_common.cuh, grid_step.cu")
    parser.add_argument("--check-only", action="store_true", help="build and check; time nothing")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_grid_kernels: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, head = torch.device("cuda", 0), card()
    print(head)
    t0 = time.perf_counter()
    src = {"parent": (args.parent / "grid_cg.cu", args.parent / "grid_step.cu"),
           "change": (grid_cg.SOURCE, gs.SOURCE)}
    _nvcc.build_all([p for pair in src.values() for p in pair])
    libs = {label: (grid_cg.load(cu), gs.load(step)) for label, (cu, step) in src.items()}
    print(f"[build] {2 * len(src)} libraries in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    base = bench_large.th_problem(TH_SIDE, TH_SIDE, "f32", dev)
    th = th_sparse.GridTHProblem.build(base[1])
    cases = k2_cases(th, stokes_grid(dev, *BIG), dev)
    ns_big = ns_grid(dev, *BIG)
    print(f"[setup] TH-192, the Scale and the NS problems in {time.perf_counter() - t0:.1f} s")
    check_k2(libs, cases)
    bit_equal(libs, dev, ns_big)
    if args.check_only:
        print(f"[done] {head}")
        return

    for label in libs:  # the first launch of a library carries its module load
        use(libs, label)
        k2_times(f"warm-up {label}", cases)
    times = []
    for label in ("parent", "change", "change", "parent"):
        use(libs, label)
        times.append((label, k2_times(label, cases)))
    rows = []
    for restarts in (0, 1):
        for label in ("parent", "change", "change", "parent"):
            use(libs, label)
            row = th_row(label, base, restarts, dev)
            rows.append((label, {k: v for k, v in row.items() if k != "card"}))
    OUT.mkdir(exist_ok=True)
    with open(OUT / "ab_grid_kernels.json", "w") as f:
        json.dump({"card": head, "k2": times, "th": rows}, f, indent=1)
    print(f"[done] {head}")


if __name__ == "__main__":
    main()
