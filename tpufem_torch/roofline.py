"""Roofline of the grid whole-solve kernels on the card (``python -m
tpufem_torch.roofline``).

The Hopper counterpart of ``tpufem.roofline``: it times the viscous and
pressure whole-solve kernels (K2 and K3) at fixed iteration counts
(tol 0, so every iteration runs) and sets each iteration's time against
the least HBM traffic an iteration needs on the card's split of the
operator (``GridOperator.dense_split``): the planes and remainder once an
apply, plus the vector passes the fused kernels make.  That byte model,
and the bounds ``chip_smoke.py`` prints for every kernel, have their one
source here.

The peaks are the NVIDIA H100 SXM data sheet's (dense rates), which
assume the card's full 700 W power limit: a card set below it runs slower
under load, so every measurement is printed beside the card's name and
power limit.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from tpufem_torch import config as tconfig

# H100 SXM data sheet, at its 700 W limit: the HBM3 rate and float32
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the float32 rate, in ms."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def solve_bound(kernel: str, K, cols: int, iters: int, ac_inv=None) -> dict:
    """The bound of one whole solve of K2, K3 or K4: its inputs read once
    (operator planes, masks and diagonals, right-hand sides, warm starts,
    K3's coarse inverse) and its solutions written once, against the flops
    of this run's iterations (two a plane entry for each apply; the vector
    updates: K2 21 a point and column, K3 30, K4 15; K3's coarse
    product)."""
    n, n_off, item = K.n, len(K.offsets), K.diags.element_size()
    planes = (n_off * n + 3 * K.n_rest) * item
    if kernel == "K2":
        # a column's point, an iteration: p = D⁻¹r + βp 3, m·p 1, the
        # operator's m(p + dtν·Kmp) + (1 − m)p 6, p·q 2, x and r 4, r·D⁻¹r
        # 3, r·r 2
        nbytes = planes + (2 + 3 * cols) * n * item
        flops = (iters + 1) * cols * (2 * n_off + 21) * n
    elif kernel == "K3":
        m = ac_inv.shape[0]
        nbytes = planes + 5 * n * item + m * m * ac_inv.element_size()
        flops = (iters + 1) * ((3 * 2 * n_off + 30) * n + 2 * m * m)
    else:
        nbytes = planes + (2 + 3 * cols) * n * item
        flops = (2 * iters + 1) * cols * (2 * n_off + 15) * n
    return bound(nbytes, flops)


# Vector passes an iteration makes at least: K2 the shared mask and inverse
# diagonal three times and 10 a column (its two fused phases, csrc/
# grid_cg.cu: A reads r and p_old and writes p and q, 4 a column, plus the
# mask and D⁻¹; B reads x, p, r and q and writes x and r, 6, plus D⁻¹; the
# three-phase first version made 11 a column), K3 and K5's
# pressure solve 17 (the fused iteration of csrc/grid_common.cuh), K4 17 a
# column and 5 shared (its three fused phases, csrc/grid_cg.cu: P reads r,
# p_old, v_old and r̂ and writes p and v, 6 a column, plus the mask and D⁻¹;
# S reads r and v and writes t, 3, plus the mask and D⁻¹; X reads x, p, r,
# v, t and r̂ and writes x and r, 8, plus D⁻¹); each apply reads the
# operator's planes and remainder once.  (K4's five-phase first version
# made 27 a column.)
APPLIES = {"K2": 1, "K3": 3, "K4": 2}


def iteration_bytes(kernel: str, K, cols: int = 1, ac_inv=None,
                    passes: int | None = None) -> float:
    """The least HBM bytes one iteration of K2, K3 or K4 moves on operator
    ``K`` (``passes``: the vector passes, if not the kernel's own count;
    ``ac_inv``: K3's coarse inverse, read once an iteration)."""
    n, item = K.n, K.diags.element_size()
    op = (len(K.offsets) * n + 3 * K.n_rest) * item
    if passes is None:
        passes = {"K2": 3 + 10 * cols, "K3": 17, "K4": 17 * cols + 5}[kernel]
    nbytes = APPLIES[kernel] * op + passes * n * item
    if ac_inv is not None:
        nbytes += ac_inv.numel() * ac_inv.element_size()
    return float(nbytes)


def iteration_bound(kernel: str, K, cols: int = 1, ac_inv=None,
                    passes: int | None = None) -> float:
    """ms of one iteration's least HBM traffic at the card's peak rate."""
    return iteration_bytes(kernel, K, cols, ac_inv, passes) / HBM_BYTES_PER_S * 1e3


def apply_bytes(op, cols: int = 1) -> float:
    """The least HBM bytes of one apply y = A x of a sparse operator on
    ``cols`` columns, each input read once and y written once: x and y, the
    stored values, and the index arrays the storage reads (the port keeps
    them as int64 tensors; the grid remainder's target, source and lane as
    int32).

    * CSR: nnz values, a row and a column index each;
    * stencil (``ops/stencil.py``): s·N diagonal values, a remainder of m
      entries with a row and a column index each;
    * banded (``ops/banded.py``): the (2b + 1)·N band and the permutation
      in and out (two int64 N-vectors);
    * grid split (``ops/gridop.py``): the planes and the remainder."""
    item = _values(op).element_size()
    vectors = 2 * (op.n if hasattr(op, "n") else op.shape[0]) * item * cols
    if hasattr(op, "ns"):  # GridOperator
        return float(len(op.offsets) * op.n * item + op.n_rest * (item + 12) + vectors)
    if hasattr(op, "bandwidth"):
        return float(op.diags.numel() * item + 16 * op.n + vectors)
    if hasattr(op, "rest_data"):
        return float(op.diags.numel() * item + op.n_rest * (item + 16) + vectors)
    return float(len(op.indices) * (item + 16) + vectors)


def apply_flops(op, cols: int = 1) -> float:
    """Two operations a stored value and column."""
    stored = (op.diags.numel() + getattr(op, "n_rest", 0) if hasattr(op, "diags")
              else len(op.indices))
    return float(2 * stored * cols)


def apply_bound(op, cols: int = 1) -> dict:
    """The bound (ms, and what binds it) of one apply of ``op``."""
    return bound(apply_bytes(op, cols), apply_flops(op, cols))


def _values(op) -> torch.Tensor:
    return op.diags if hasattr(op, "diags") else op.data


SIZES = [
    ("160k", 400, 448),
    ("410k", 640, 720),
    ("1.05M", 1024, 1088),
]


def card(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or the
    device's name off the card."""
    from tpufem_torch.bench import card as first_card

    return first_card() if device.type == "cuda" else str(device)


def build_problem(n_side: int, n_circle: int, storage: str = "auto", device=None, **overrides):
    """The bench configuration (``bench_large.bench_config``) on the pad_hole
    mesh of this size: (problem, build seconds).  On CUDA at f32 "auto" is
    the grid storage (K2/K3)."""
    from tpufem_torch import bench_large
    from tpufem_torch.mesh.generate import generate_annulus_mesh
    from tpufem_torch.workloads import stokes

    t0 = time.perf_counter()
    mesh = generate_annulus_mesh(n_side=n_side, n_circle=n_circle, pad_hole=True)
    config = bench_large.bench_config("twolevel", n_nodes=int(mesh.n_nodes), transport="none",
                                      storage=storage, **overrides)
    problem = stokes.StokesProblem.build(mesh, config, device=tconfig.device(device))
    return problem, time.perf_counter() - t0


def _fixed(problem, iters_p: int, iters_v: int):
    """The problem's grid solvers at fixed iteration counts (tol 0)."""
    if not hasattr(problem.pressure_solver, "act_grid"):
        raise ValueError("the roofline measures the grid storage (cg_storage 'grid', "
                         "'grid_interpret' or 'auto' on CUDA at f32)")
    ps = dataclasses.replace(problem.pressure_solver, tol=0.0, iters=iters_p)
    vs = dataclasses.replace(problem.visc_solver, tol=0.0, iters=iters_v)
    return ps, vs


def _rhs(problem):
    """Seeded right-hand sides: (N,) for the pressure, (N, 2) for the
    viscous solve."""
    rng = np.random.default_rng(0)
    n, dtype, dev = problem.mesh.n_nodes, problem.dtype, problem.device
    return (torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev),
            torch.as_tensor(rng.standard_normal((n, 2)), dtype=dtype, device=dev))


def _seconds(fn, b) -> float:
    """Seconds of one synchronised call: CUDA events on the card, the host
    clock elsewhere."""
    if b.device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(b)
        end.record()
        torch.cuda.synchronize(b.device)
        return start.elapsed_time(end) * 1e-3
    t0 = time.perf_counter()
    fn(b)
    return time.perf_counter() - t0


def _row(problem, ps, vs, t_p: float, t_v: float, label: str | None) -> dict:
    """One roofline row from the best solve times ``t_p`` and ``t_v``."""
    ns = ps.K.ns
    ac = ps.ac_inv if ps.use_coarse else None
    bytes_p = iteration_bytes("K3", ps.K, 1, ac)
    bytes_v = iteration_bytes("K2", vs.K, 2)
    s_p, s_v = t_p / ps.iters, t_v / vs.iters  # seconds an iteration
    bound_p, bound_v = bytes_p / HBM_BYTES_PER_S, bytes_v / HBM_BYTES_PER_S
    return {
        "label": label or f"{ns}x{ns}",
        "n_nodes": int(problem.mesh.n_nodes),
        "ns": int(ns),
        "device": card(problem.device),
        "itemsize": ps.K.diags.element_size(),
        "n_off_p": len(ps.K.offsets),
        "n_off_v": len(vs.K.offsets),
        "n_rest_p": ps.K.n_rest,
        "n_rest_v": vs.K.n_rest,
        "iters_p": ps.iters,
        "iters_v": vs.iters,
        "t_pressure_s": t_p,
        "t_viscous_s": t_v,
        "us_per_p_iter": s_p * 1e6,
        "us_per_v_iter": s_v * 1e6,  # both velocity columns: K2 runs them in lockstep
        "bytes_per_p_iter": bytes_p,
        "bytes_per_v_iter": bytes_v,
        "gbps_pressure": bytes_p / s_p / 1e9,
        "gbps_viscous": bytes_v / s_v / 1e9,
        "bound_us_p": bound_p * 1e6,
        "bound_us_v": bound_v * 1e6,
        "pct_bound_pressure": 100 * bound_p / s_p,
        "pct_bound_viscous": 100 * bound_v / s_v,
    }


def measure_problem(problem, iters_p: int = 120, iters_v: int = 30, reps: int = 5,
                    label: str | None = None) -> dict:
    """One roofline row of ``problem`` (grid storage): the best of ``reps``
    timed solves of each kernel at fixed iteration counts, after one
    untimed call."""
    ps, vs = _fixed(problem, iters_p, iters_v)
    bp, bv = _rhs(problem)
    ps.solve(bp)
    vs.solve(bv)
    t_p = min(_seconds(ps.solve, bp) for _ in range(reps))
    t_v = min(_seconds(vs.solve, bv) for _ in range(reps))
    return _row(problem, ps, vs, t_p, t_v, label)


def measure(n_side: int, n_circle: int, iters_p: int = 120, iters_v: int = 30, reps: int = 5,
            label: str | None = None, storage: str = "auto", device=None) -> dict:
    """One roofline row: build the bench problem at this size, time the two
    whole-solve kernels at fixed iteration counts, set each iteration
    against its byte bound."""
    problem, build_s = build_problem(n_side, n_circle, storage, device)
    row = measure_problem(problem, iters_p, iters_v, reps, label)
    row["build_s"] = build_s
    return row


def ab(n_side: int, n_circle: int, knobs: list[dict], iters_p: int = 120, iters_v: int = 30,
       reps: int = 8, label: str | None = None, storage: str = "auto", device=None) -> list[dict]:
    """Interleaved A/B of ``StokesConfig`` overrides (``knobs``, a list of
    dicts) at one size: every configuration built and warmed first, then
    timed round-robin (rep 0 of each, rep 1 of each, ...) so drift in the
    card's clocks hits each alike.  One row per entry of ``knobs``."""
    entries = []
    for knob in knobs:
        problem, build_s = build_problem(n_side, n_circle, storage, device, **knob)
        ps, vs = _fixed(problem, iters_p, iters_v)
        bp, bv = _rhs(problem)
        ps.solve(bp)
        vs.solve(bv)
        entries.append(dict(knob=knob, problem=problem, ps=ps, vs=vs, bp=bp, bv=bv,
                            build_s=build_s, best_p=float("inf"), best_v=float("inf")))
        print(f"# built {knob or 'defaults'} ({build_s:.1f} s)", flush=True)
    for _ in range(reps):
        for e in entries:
            e["best_p"] = min(e["best_p"], _seconds(e["ps"].solve, e["bp"]))
            e["best_v"] = min(e["best_v"], _seconds(e["vs"].solve, e["bv"]))
    rows = []
    for e in entries:
        row = _row(e["problem"], e["ps"], e["vs"], e["best_p"], e["best_v"], label)
        rows.append({**row, "knobs": e["knob"], "reps": reps, "build_s": e["build_s"]})
    return rows


def main(argv=None) -> list[dict]:
    import argparse

    parser = argparse.ArgumentParser(prog="python -m tpufem_torch.roofline")
    parser.add_argument("--sizes", default=None,
                        help="comma-separated labels from %s (default all)" % [s[0] for s in SIZES])
    parser.add_argument("--iters-p", type=int, default=120)
    parser.add_argument("--iters-v", type=int, default=30)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--ab", default=None,
                        help='a JSON list of StokesConfig overrides to time in turns, e.g. '
                             '\'[{}, {"cg_coarse_dtype": "same"}]\'')
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    wanted = set(args.sizes.split(",")) if args.sizes else None
    rows = []
    for label, n_side, n_circle in SIZES:
        if wanted is not None and label not in wanted:
            continue
        if args.ab:
            new = ab(n_side, n_circle, json.loads(args.ab), iters_p=args.iters_p,
                     iters_v=args.iters_v, reps=args.reps, label=label, device=args.device)
        else:
            new = [measure(n_side, n_circle, iters_p=args.iters_p, iters_v=args.iters_v,
                           reps=args.reps, label=label, device=args.device)]
        for r in new:
            print(json.dumps(r), flush=True)
        rows += new
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows


if __name__ == "__main__":
    main()
