"""Parent against change of the grid kernels (K2–K5) in one process on one card.

Run from the root of a checkout on a machine with the card, with a copy of
the parent commit's sources in a directory the tree ignores:

    mkdir -p _checkout/parent
    for f in grid_cg.cu grid_common.cuh grid_step.cu; do
        git show <parent>:tpufem_torch/csrc/$f > _checkout/parent/$f
    done
    python3 ab_grid_kernels.py --parent _checkout/parent [--check-only]

It builds the parent's ``grid_cg.cu`` and ``grid_step.cu`` (with its
``grid_common.cuh``) beside the tree's, and variants of the tree's
``grid_cg.cu`` (``VARIANTS``), all at once; prints each K4 instance's
registers, spills and blocks per SM; then

* checks: the tree's K4 against its plain version (f32, fixed 30 iterations
  from zero, and the step's tol 1e-5 from u) at 1,048,576 nodes on the card's
  split of the NS refill template and on tpufem's; K2, K3 and K5 of the two
  libraries bit-equal at ``n_side=40`` (f32 and f64) and K3 on the
  1,048,576-node NS pressure operator (f32);
* times (f32, 1,048,576 nodes), the libraries in turns parent, change,
  change, parent (the variants once, between): K4 ms an iteration on both
  splits against its byte bound at the tree's pass count and at the
  parent's (``chip_smoke.iteration_bound``), and ms a warm solve; then NS
  cold and warm steps/s (``bench_large.run_ns_problem``, 200 + 200 steps)
  with a profile of 50 warm steps by kernel, the parent on the template it
  used (tpufem's split), the change on the card's.

It prints the card's name and power limit first and last, and writes the
numbers to ``chiprun_out/ab_grid_kernels.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from tpufem_torch import bench_large
from tpufem_torch.bench import profile_run
from tpufem_torch.ops import _nvcc, assembly
from tpufem_torch.solve import grid_cg
from tpufem_torch.solve import grid_step as gs
from tpufem_torch.workloads import navier_stokes

# variants of the tree's grid_cg.cu: name → [(source file, text, its replacement)]
UNROLLED = "  for (int g = 0; g < op.n_off; ++g) {\n    int sy = iy + op.sh.rs[g];"
GRID_STRIDE = """  const int stride = (int)gridDim.x * kThreads;
  for (int i = (int)blockIdx.x * kThreads + (int)threadIdx.x; i < n; i += stride) body(i);"""
CONTIGUOUS = """  const int blocks = (int)gridDim.x;
  const int per = ((n + blocks - 1) / blocks + kThreads - 1) / kThreads * kThreads;
  const int end = min(n, ((int)blockIdx.x + 1) * per);
  for (int i = (int)blockIdx.x * per + (int)threadIdx.x; i < end; i += kThreads) body(i);"""
VARIANTS = {
    "contiguous runs": [("grid_cg.cu", GRID_STRIDE, CONTIGUOUS)],
    "2 blocks/SM": [("grid_cg.cu", "constexpr int kFusedMinBlocks = sizeof(T) == 4 ? 4 : 2;",
                     "constexpr int kFusedMinBlocks = 2;")],
    "3 blocks/SM": [("grid_cg.cu", "constexpr int kFusedMinBlocks = sizeof(T) == 4 ? 4 : 2;",
                     "constexpr int kFusedMinBlocks = sizeof(T) == 4 ? 3 : 2;")],
    "5 blocks/SM": [("grid_cg.cu", "constexpr int kFusedMinBlocks = sizeof(T) == 4 ? 4 : 2;",
                     "constexpr int kFusedMinBlocks = sizeof(T) == 4 ? 5 : 2;")],
    "plane loop unrolled by 3": [("grid_common.cuh", UNROLLED, "#pragma unroll 3\n" + UNROLLED)],
}
PARENT_K4_PASSES = 27  # vector passes a column of the five-phase first version of K4
NS_STEPS = 200
PROFILE_STEPS = 50
OUT = Path("chiprun_out")


def sources(parent: Path, work: Path) -> dict:
    """{label: (grid_cg.cu, grid_step.cu or None)} of the libraries to build:
    the variants are patched copies of the tree's sources in ``work``."""
    out = {"parent": (parent / "grid_cg.cu", parent / "grid_step.cu"),
           "change": (grid_cg.SOURCE, gs.SOURCE)}
    for i, (name, patches) in enumerate(VARIANTS.items()):
        d = work / f"variant{i}"
        d.mkdir(parents=True, exist_ok=True)
        for f in ("grid_cg.cu", "grid_common.cuh"):
            shutil.copy(grid_cg.SOURCE.parent / f, d / f)
        for f, old, new in patches:
            text = (d / f).read_text()
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} not in {f}")
            (d / f).write_text(text.replace(old, new))
        out[name] = (d / "grid_cg.cu", None)
    return out


def report(label: str, path: Path, lib) -> None:
    for line in cs.instance_report(path, grid_cg.blocks_per_sm(lib)):
        print(f"[build] {label}: {line}")


def use(lib, step_lib=None) -> None:
    grid_cg._lib = lib
    if step_lib is not None:
        gs._lib = step_lib


def with_refill(problem, refill):
    """``problem`` (grid-path NS) with its velocity system in ``refill``'s
    layout, as ``navier_stokes._grid_fields`` builds it."""
    cfg, mesh, dtype, dev = problem.config, problem.mesh, problem.dtype, problem.device
    Kg = refill.refill(assembly.element_stiffness(mesh, signed=True).to(dtype=dtype, device=dev))
    nudt = float(cfg.nu * cfg.dt)
    t = refill.template
    return dataclasses.replace(
        problem, grid_refill=refill, Kg_diags=nudt * Kg.diags, Kg_rest=nudt * Kg.rest_vals,
        vel_solver_grid=dataclasses.replace(problem.vel_solver_grid, offsets=t.offsets,
                                            n_rest=t.n_rest))


def check_k4(big, layouts) -> None:
    for name, refill in layouts.items():
        op, mask, invd, u, b_step = cs.ns_operator(big, torch.float32, refill)
        b = torch.as_tensor(np.random.default_rng(8).standard_normal(tuple(u.shape)),
                            dtype=torch.float32, device=u.device)
        for iters, tol, rhs, x0 in ((30, 0.0, b, torch.zeros_like(u)), (30, 1e-5, b_step, u)):
            s = cs.ns_solver(big, op, iters=iters, tol=tol)
            got = grid_cg.ns_bicgstab(s, op, mask, invd, rhs, x0)
            want = grid_cg.ns_bicgstab_ref(s, op, mask, invd, rhs, x0)
            err = cs.rel(got, want)
            lim = cs.GRID_RTOL[(torch.float32, tol)]
            print(f"[check] K4 f32 {'tol 1e-5 warm' if tol else 'fixed 30'} on the {name} "
                  f"({len(op.offsets)} planes, {op.n_rest} remainder entries): rel L2 {err:.3e} "
                  f"(<= {lim:g})")
            cs.check(err <= lim, f"K4 on the {name}: rel {err}")


def bit_equal(libs: dict, dev, big) -> None:
    """K2, K3 and K5 of the parent's and the tree's libraries on the same
    inputs, bit for bit."""
    rng = np.random.default_rng(40)
    small = cs.scale_problem(dev, 40, 48)
    cases = 0
    for dtype in (torch.float32, torch.float64):
        for name, solver, cols in cs.solver_variants(small, dtype):
            ns = small.visc_solver.K.ns
            shape = (cols, ns, ns) if name == "K2" else (ns, ns)
            b = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)
            fn = grid_cg.viscous_cg if name == "K2" else grid_cg.pressure_cg
            if name != "K2":
                b = b * solver.act_grid
            for tol in (0.0, 1e-5):
                s = dataclasses.replace(solver, tol=tol)
                x0 = torch.zeros_like(b)
                ys = []
                for label in ("parent", "change"):
                    use(libs[label][0])
                    ys.append(fn(s, b, x0))
                torch.cuda.synchronize()
                cs.check(torch.equal(*ys), f"{name} {dtype} tol {tol}: parent and change differ")
                cases += 1
    pres = big.pressure_solver
    b = torch.as_tensor(rng.standard_normal((pres.K.ns, pres.K.ns)), dtype=pres.K.dtype,
                        device=dev) * pres.act_grid
    ys = []
    for label in ("parent", "change"):
        use(libs[label][0])
        ys.append(grid_cg.pressure_cg(pres, b, torch.zeros_like(b)))
    cs.check(torch.equal(*ys), "K3 on the NS pressure operator: parent and change differ")
    cases += 1
    k5 = cs.with_k5(cs.scale_problem(dev, 40, 48))
    state, _ = cs.stokes.run(k5, steps=3)
    for dtype in (torch.float32, torch.float64):
        coarse = k5.grid_step.pressure.ac_inv.dtype if dtype == torch.float32 else torch.float64
        step = cs.k5_cast(k5.grid_step, dtype, coarse)
        args = cs.k5_state(step, state, dtype)
        ys = []
        for label in ("parent", "change"):
            use(libs[label][0], libs[label][1])
            ys.append(gs.grid_step(step, *args))
        torch.cuda.synchronize()
        cs.check(all(torch.equal(a, c) for a, c in zip(*ys)), f"K5 {dtype}: parent and change differ")
        cases += 1
    print(f"[check] K2, K3 and K5: parent and change bit-equal in all {cases} cases (n_side=40 f32 "
          f"and f64, fixed and tol 1e-5; K3 on the {big.mesh.n_nodes}-node NS pressure operator)")


def k4_times(label: str, big, layouts: dict, b2) -> dict:
    out = {}
    for name, refill in layouts.items():
        op, mask, invd, u, b_step = cs.ns_operator(big, torch.float32, refill)

        def k4(s, b, x0, it=None, op=op, mask=mask, invd=invd):
            return grid_cg.ns_bicgstab(s, op, mask, invd, b, x0, it)

        ms = cs.per_iteration_ms(k4, cs.ns_solver(big, op), b2, calls=5)
        warm = cs.solve_timed_ms(k4, cs.ns_solver(big, op, iters=30, tol=1e-5), b_step, u, 20)
        bd = cs.iteration_bound("K4", op, 2)
        bd_parent = cs.iteration_bound("K4", op, 2, passes=2 * PARENT_K4_PASSES)
        out[name] = {"ms_per_iteration": ms, "warm_solve_ms": warm, "bound_ms": bd,
                     "bound_parent_count_ms": bd_parent}
        print(f"[time] {label} K4 on the {name} ({len(op.offsets)} planes, {op.n_rest} remainder "
              f"entries): {ms:.4f} ms an iteration, bound {bd:.4f} ({100 * bd / ms:.1f} %; at the "
              f"parent's 54 passes {bd_parent:.4f}), warm solve {warm:.4f} ms")
    return out


def ns_run(label: str, problem) -> dict:
    problem, counters = bench_large.with_iteration_counters(problem, bench_large.NS_SOLVES)
    row = bench_large.run_ns_problem(problem, NS_STEPS, counters)
    state = row.pop("state")
    prof = profile_run(lambda: navier_stokes.run(problem, steps=PROFILE_STEPS, state=state),
                       PROFILE_STEPS, top=12)
    t = problem.grid_refill.template
    print(f"[ns] {label} ({len(t.offsets)} velocity planes, {t.n_rest} remainder entries): cold "
          f"{row['cold_steps_per_sec']:.2f}, warm {row['warm_steps_per_sec']:.2f} steps/s, "
          f"iterations {json.dumps(row['iters_per_solve'])}; device {prof['device_ms_per_step']:.3f} "
          f"ms a step: " + ", ".join(f"{k['name'][:40]} {k['ms_per_step']:.3f}" for k in prof["top"]))
    return {**row, "profile": prof}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, required=True,
                        help="directory with the parent's grid_cg.cu, grid_common.cuh, grid_step.cu")
    parser.add_argument("--check-only", action="store_true", help="build and check; time nothing")
    args = parser.parse_args()
    dev = cs.phase_device()
    head = cs.card()
    t0 = time.perf_counter()
    src = sources(args.parent, Path("_checkout") / "ab_variants")
    paths = [p for pair in src.values() for p in pair if p is not None]
    _nvcc.build_all(paths)
    libs = {k: (grid_cg.load(cu), gs.load(step) if step else None) for k, (cu, step) in src.items()}
    print(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")
    for label, (cu, _) in src.items():
        report(label, _nvcc.library_path(cu), libs[label][0])

    t0 = time.perf_counter()
    big, _ = cs.built(*cs.SCALE_MESH, cs.ns_problem)
    other = cs.ns_other_layout(big)
    layouts = {"card split": None, other[0]: other[1]}
    print(f"[setup] NS problem and tpufem's template in {time.perf_counter() - t0:.1f} s")
    use(*libs["change"])
    check_k4(big, layouts)
    bit_equal(libs, dev, big)
    if args.check_only:
        return

    ns = big.grid_refill.template.ns
    b2 = torch.as_tensor(np.random.default_rng(13).standard_normal((2, ns, ns)),
                         dtype=torch.float32, device=dev)
    for label, (lib, _) in libs.items():  # the first launch of a library carries its module load
        use(lib)
        k4_times(f"warm-up {label}", big, {"card split": None}, b2)
    turns = ["parent", "change", *VARIANTS, "change", "parent"]
    times = []
    for label in turns:
        use(*libs[label])
        times.append((label, k4_times(label, big, layouts, b2)))
    old = with_refill(big, other[1])
    rows = []
    for label in ("parent", "change", "change", "parent"):
        use(*libs[label])
        rows.append((label, ns_run(label, old if label == "parent" else big)))
    OUT.mkdir(exist_ok=True)
    with open(OUT / "ab_grid_kernels.json", "w") as f:
        json.dump({"card": head, "k4": times, "ns": rows}, f, indent=1)
    print(f"[done] {head}")


if __name__ == "__main__":
    main()
