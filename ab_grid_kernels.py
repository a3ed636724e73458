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
``grid_common.cuh``) beside the tree's, and variants of the tree's
``grid_cg.cu`` (``VARIANTS``: K2's other designs), all at once; prints each
K2 instance's registers, spills, blocks per SM and launch; then

* checks: each library's K2 against its plain version from zero on the
  Taylor–Hood velocity operator of n_side 192 (TH-192) at the engine's
  288-iteration cap (f32 fixed, f64 with the engine's tolerance) and, 30
  fixed iterations, on the 1,048,576-node viscous operator (f32), and two
  launches bit-equal; K3, K4 and K5 of the parent's and
  the tree's libraries bit-equal at ``n_side=40`` (f32 and f64) and K3 on
  the 1,048,576-node NS pressure operator (f32);
* times (f32), the libraries in turns parent, change, the variants,
  change, parent: K2 ms an iteration (the difference of fixed solves of
  288 and 144 iterations) against its byte bound at the tree's pass count
  and at the parent's, and
  ms a warm solve, at TH-192 and at 1,048,576 nodes; then TH-192 warm
  steps/s at ``vel_restarts`` 0 and 1 (``bench_large.run_th_sparse``, with
  its profile and K2's iterations a step), parent, change, change, parent.

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
from tpufem_torch.ops import _nvcc
from tpufem_torch.solve import grid_cg
from tpufem_torch.solve import grid_step as gs
from tpufem_torch.workloads import th_sparse

# K2's other designs, as patches of the tree's sources: name → [(file, text,
# its replacement)].  They change K4's code in the same library too, which
# is not timed here.
#   "wide totals": every block adds the partial sums with all its threads
#   (thread t the partials of blocks t, t + 256, … in that order, then a
#   fixed shuffle tree), not with one warp walking ⌈blocks / 32⌉ loads a
#   lane in turn.
#   "three syncs": p = D⁻¹r + βp as a pass of its own after phase B (and a
#   third grid sync), phase A reading p, as the parent did, but still one
#   apply for both columns.
#   "one run a block": each block walks one contiguous run of ⌈n / blocks⌉
#   points, so that every SM walks the same number of points (a
#   grid-stride walk gives its ragged last round to the first blocks, on
#   the first SMs).
#   "whole points a thread": ⌈n / (256·k)⌉ blocks, k = ⌈n / (256·resident
#   blocks)⌉ points a thread, so that no thread takes a ragged extra round
#   (287 blocks of two points a thread at TH-192, where the occupancy
#   launch has 528).
#   "plane loop unrolled by 4": the loads of four offsets issued together
#   in apply_cols.
#   "4 blocks/SM in L2", "6 blocks/SM in L2": K2's f32 register budget,
#   where an iteration fits in L2, at 64 and 40 registers a thread (the
#   tree's 5 at 48; 6 blocks/SM: one point a thread at TH-192).
#   "5 blocks/SM at every size": the L2 budget also where an iteration
#   streams from HBM.
WIDE_TOTALS = [
    ("grid_cg.cu", "template <typename T>\nstruct ViscousArgs {",
     """template <typename T, int NV>
__device__ void grid_totals_wide(const T* partials, T (&v)[NV]) {
  __shared__ T sm[kWarps][NV];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T s[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) s[j] = T(0);
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
#pragma unroll
    for (int j = 0; j < NV; ++j) s[j] += partials[b * kSlots + j];
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const T w = warp_sum(s[j]);
    if (lane == 0) sm[warp][j] = w;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const T w = warp_sum(lane < kWarps ? sm[lane][j] : T(0));
    v[j] = __shfl_sync(0xffffffffu, w, 0);
  }
  __syncthreads();
}

template <typename T, int NV>
__device__ __forceinline__ void reduce_grid_wide(cg::grid_group& grid, T (&v)[NV], T* partials,
                                                 int& slot) {
  T* base = partials + (size_t)slot * kMaxBlocks * kSlots;
  block_partials<T, NV>(v, base + (size_t)blockIdx.x * kSlots);
  grid.sync();
  grid_totals_wide<T, NV>(base, v);
  slot ^= 1;
}

template <typename T>
struct ViscousArgs {"""),
] + [("grid_cg.cu", f"reduce_grid(grid, s{i}, a.partials, slot);",
      f"reduce_grid_wide(grid, s{i}, a.partials, slot);") for i in range(3)]
THREE_SYNCS = [
    ("grid_cg.cu", "    const T* pold = pick(a.p, (k & 1) ^ 1);\n    T* pnew = pick(a.p, k & 1);",
     "    T* pnew = a.p[0];  // one copy of p, updated in place by phase C"),
    ("grid_cg.cu", "        const T z = dj * a.r[e];\n        pv[c] = first ? z : z + beta[c] * pold[e];",
     "        pv[c] = first ? dj * a.r[e] : pnew[e];"),
    ("grid_cg.cu", "        pnew[e] = pv[c];\n        a.q[e] = qv[c];",
     "        if (first) pnew[e] = pv[c];\n        a.q[e] = qv[c];"),
    ("grid_cg.cu", "      rr[c] = s2[C + c];\n    }\n  }\n  if (k == 0) {",
     """      rr[c] = s2[C + c];
    }

    // C: p = D⁻¹r + βp
    for_points(n, [&](int i) {
      const T di = invd[i];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = c * n + i;
        pnew[e] = di * a.r[e] + beta[c] * pnew[e];
      }
    });
    grid.sync();
  }
  if (k == 0) {"""),
]
ONE_RUN = [
    ("grid_cg.cu", """  const int stride = (int)gridDim.x * kThreads;
  for (int i = (int)blockIdx.x * kThreads + (int)threadIdx.x; i < n; i += stride) body(i);""",
     """  const int per = (n + (int)gridDim.x - 1) / (int)gridDim.x;
  const int end = min(n, ((int)blockIdx.x + 1) * per);
  for (int i = (int)blockIdx.x * per + (int)threadIdx.x; i < end; i += kThreads) body(i);"""),
]
WHOLE_POINTS = [
    ("grid_cg.cu", "template <typename T>\nint viscous_cg(",
     """// ⌈n / (256·k)⌉ blocks, k = ⌈n / (256·resident blocks)⌉ points a thread
template <typename Args>
cudaError_t launch_whole(void (*kernel)(Args), Args& args, int n, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  blocks_per_sm(kernel, &per_sm);
  int resident = per_sm * sms < kMaxBlocks ? per_sm * sms : kMaxBlocks;
  resident = resident > 0 ? resident : 1;
  const int k = (n + resident * kThreads - 1) / (resident * kThreads);
  const int blocks = (n + kThreads * k - 1) / (kThreads * k);
  return launch_coop(kernel, args, blocks * kThreads, stream);  // launches `blocks`
}

template <typename T>
int viscous_cg("""),
    ("grid_cg.cu", "launch_coop(viscous_cg_kernel<T, ", "launch_whole(viscous_cg_kernel<T, "),
]
UNROLL4 = [("grid_common.cuh", "  for (int g = 0; g < op.n_off; ++g) {\n    int sy = iy + op.sh.rs[g];",
            "#pragma unroll 4\n  for (int g = 0; g < op.n_off; ++g) {\n    int sy = iy + op.sh.rs[g];")]
IN_L2 = "constexpr int kInL2MinBlocks = sizeof(T) == 4 ? 5 : kFusedMinBlocks<T>;"
VARIANTS = {
    "wide totals": WIDE_TOTALS,
    "three syncs": THREE_SYNCS,
    "one run a block": ONE_RUN,
    "whole points a thread": WHOLE_POINTS,
    "plane loop unrolled by 4": UNROLL4,
    "4 blocks/SM in L2": [("grid_cg.cu", IN_L2, IN_L2.replace("? 5 :", "? 4 :"))],
    "6 blocks/SM in L2": [("grid_cg.cu", IN_L2, IN_L2.replace("? 5 :", "? 6 :"))],
    "5 blocks/SM at every size": [("grid_cg.cu", "const bool in_l2 = (double)",
                                   "const bool in_l2 = true || (double)")],
}
PARENT_K2_PASSES = 3 + 11 * 2  # vector passes of the parent's K2 an iteration, two columns
TH_ITERS = 288  # the engine's velocity cap at n_side 192
SCALE_ITERS = 30  # the Scale cell's viscous cap
TH_STEPS = 10
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


def use(libs: dict, label: str) -> None:
    """Make ``label``'s libraries the ones the wrappers launch.  The tree's
    K2 wrapper launches the parent's K2 too (the same C entry; its work
    buffer is larger than the parent's three planes a column)."""
    lib, step_lib = libs[label]
    grid_cg._lib = lib
    if step_lib is not None:
        gs._lib = step_lib


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
            runs += [(torch.float64, cs.TH_TOL_INNER[torch.float64], True), (torch.float64, 0.0, False)]
        for dtype, tol, gated in runs:
            s = dataclasses.replace(s32, K=s32.K.astype(dtype), tol=tol,
                                    interior_mask=s32.interior_mask.to(dtype))
            b = b32.to(dtype)
            it_p = torch.zeros(1, dtype=torch.int32, device=b.device)
            want = grid_cg.viscous_cg_ref(s, b, torch.zeros_like(b), it_p)
            lim = (cs.TH_RTOL if case == "TH-192" else cs.GRID_RTOL)[(dtype, tol)]
            parts = []
            for label in libs:
                use(libs, label)
                it = torch.zeros(1, dtype=torch.int32, device=b.device)
                got = grid_cg.viscous_cg(s, b, torch.zeros_like(b), it)
                again = grid_cg.viscous_cg(s, b, torch.zeros_like(b))
                err = cs.rel(got, want)
                parts.append(f"{label} {err:.3e} ({int(it.item())} it.)")
                cs.check(torch.equal(got, again), f"K2 {label} {case} {dtype}: repeats differ")
                if gated:
                    cs.check(err <= lim, f"K2 {label} {case} {dtype} tol {tol}: rel {err}")
            print(f"[check] K2 {str(dtype)[6:]} {case}, at most {s.iters} iterations from zero, tol "
                  f"{tol:g} (plain {int(it_p.item())} it.), rel L2 to the plain version "
                  + (f"(<= {lim:g})" if gated else "(not gated)")
                  + ", repeats bit-equal: " + ", ".join(parts))


def bit_equal(libs: dict, dev, ns_big) -> None:
    """K3, K4 and K5 of the parent's and the tree's libraries on the same
    inputs, bit for bit."""
    rng = np.random.default_rng(40)
    small = cs.scale_problem(dev, 40, 48)
    ns_small = cs.ns_problem(dev, 40, 48)
    cases = 0

    def same(what: str, run) -> None:
        nonlocal cases
        ys = []
        for label in ("parent", "change"):
            use(libs, label)
            ys.append(run())
        torch.cuda.synchronize()
        a, c = ys
        a, c = (a, c) if isinstance(a, tuple) else ((a,), (c,))
        cs.check(all(torch.equal(u, v) for u, v in zip(a, c)), f"{what}: parent and change differ")
        cases += 1

    for dtype in (torch.float32, torch.float64):
        for name, solver, _ in cs.solver_variants(small, dtype):
            if name == "K2":
                continue
            ns = solver.K.ns
            b = torch.as_tensor(rng.standard_normal((ns, ns)), dtype=dtype, device=dev)
            b = b * solver.act_grid
            for tol in (0.0, 1e-5):
                s = dataclasses.replace(solver, tol=tol)
                same(f"{name} {dtype} tol {tol}",
                     lambda s=s, b=b: grid_cg.pressure_cg(s, b, torch.zeros_like(b)))
        op, mask, invd, u, b_step = cs.ns_operator(ns_small, dtype)
        b = torch.as_tensor(rng.standard_normal(tuple(u.shape)), dtype=dtype, device=dev)
        for iters, tol, rhs, x0 in ((30, 0.0, b, torch.zeros_like(u)), (30, 1e-5, b_step, u)):
            s = cs.ns_solver(ns_small, op, iters=iters, tol=tol)
            same(f"K4 {dtype} tol {tol}",
                 lambda s=s, rhs=rhs, x0=x0: grid_cg.ns_bicgstab(s, op, mask, invd, rhs, x0))
    pres = ns_big.pressure_solver
    b = torch.as_tensor(rng.standard_normal((pres.K.ns, pres.K.ns)), dtype=pres.K.dtype,
                        device=dev) * pres.act_grid
    same("K3 on the NS pressure operator", lambda: grid_cg.pressure_cg(pres, b, torch.zeros_like(b)))
    k5 = cs.with_k5(cs.scale_problem(dev, 40, 48))
    state, _ = cs.stokes.run(k5, steps=3)
    for dtype in (torch.float32, torch.float64):
        coarse = k5.grid_step.pressure.ac_inv.dtype if dtype == torch.float32 else torch.float64
        step = cs.k5_cast(k5.grid_step, dtype, coarse)
        args = cs.k5_state(step, state, dtype)
        same(f"K5 {dtype}", lambda step=step, args=args: tuple(gs.grid_step(step, *args)))
    print(f"[check] K3, K4 and K5: parent and change bit-equal in all {cases} cases (n_side=40 "
          f"f32 and f64, fixed and tol 1e-5; K3 on the {ns_big.mesh.n_nodes}-node NS pressure "
          f"operator)")


def iteration_ms(solver, b, iters: int, calls: int = 5) -> float:
    """K2's ms an iteration: fixed-iteration solves from zero of ``iters``
    and ``iters // 2`` iterations, the difference (chip_smoke's
    per_iteration_ms at another length)."""
    x0 = torch.zeros_like(b)
    t = [cs.solve_timed_ms(grid_cg.viscous_cg, dataclasses.replace(solver, iters=k, tol=0.0), b,
                           x0, calls) for k in (iters, iters // 2)]
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
        warm = cs.solve_timed_ms(k2, warm_solver, b, x0, 5)
        bd = cs.iteration_bound("K2", s.K, 2)
        bd_parent = cs.iteration_bound("K2", s.K, 2, passes=PARENT_K2_PASSES)
        out[case] = {"ms_per_iteration": ms, "warm_solve_ms": warm,
                     "warm_solve_iterations": int(it.item()), "bound_ms": bd,
                     "bound_parent_count_ms": bd_parent}
        print(f"[time] {label} K2 at {case} ({len(s.K.offsets)} planes, {s.K.n_rest} remainder "
              f"entries): {ms:.5f} ms an iteration, bound {bd:.5f} ({100 * bd / ms:.1f} %; at the "
              f"parent's {PARENT_K2_PASSES} passes {bd_parent:.5f}), warm solve {warm:.4f} ms "
              f"({int(it.item())} iterations, tol {warm_solver.tol:g})")
    return out


def th_row(label: str, base, restarts: int, dev) -> dict:
    row = bench_large.run_th_sparse(cs.TH_ROW_SIDE, cs.TH_ROW_SIDE, TH_STEPS, precision="f32",
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
    dev = cs.phase_device()
    head = cs.card()
    t0 = time.perf_counter()
    src = sources(args.parent, Path("_checkout") / "ab_variants")
    paths = [p for pair in src.values() for p in pair if p is not None]
    _nvcc.build_all(paths)
    libs = {label: (grid_cg.load(cu), gs.load(step) if step else None)
            for label, (cu, step) in src.items()}
    print(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    base = bench_large.th_problem(cs.TH_ROW_SIDE, cs.TH_ROW_SIDE, "f32", dev)
    th = th_sparse.GridTHProblem.build(base[1])
    scale, _ = cs.built(*cs.SCALE_MESH, cs.scale_problem)
    ns_big, _ = cs.built(*cs.SCALE_MESH, cs.ns_problem)
    cases = k2_cases(th, scale, dev)
    print(f"[setup] TH-192, the Scale and the NS problems in {time.perf_counter() - t0:.1f} s")
    for label, (cu, _) in src.items():
        blocks = grid_cg.blocks_per_sm(libs[label][0])
        for line in cs.instance_report(_nvcc.library_path(cu), blocks, "viscous_cg"):
            print(f"[build] {label}: {line}")
    check_k2(libs, cases)
    bit_equal(libs, dev, ns_big)
    if args.check_only:
        print(f"[done] {head}")
        return

    for label in libs:  # the first launch of a library carries its module load
        use(libs, label)
        k2_times(f"warm-up {label}", cases)
    turns = ["parent", "change", *VARIANTS, "change", "parent"]
    times = []
    for label in turns:
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
