"""Large-mesh benchmark of the scale regime on one CUDA device.

The counterpart of ``tpufem/bench_large.py`` for the squirmer Stokes step
on ring-in-grid pad_hole meshes (N = n_side²), solved matrix-free: K2 for
the viscous solve and K3 (two-level PCG, warm start, tolerance exit) for
both pressure solves, f32 fields, bf16 coarse inverse.

    python -m tpufem_torch.bench_large --size 1.05M [--steps 200] [--transport tracers]

prints one JSON row like tpufem's (cold and warm steps/s, the physics
report), plus the card's name and power limit, the mean CG iterations per
solve of each run, and a device-time breakdown of the warm run, repeated
under ``torch.profiler``.  There is no CPU fallback: without a CUDA device it
fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from tpufem_torch.workloads import stokes

# (label, n_side, n_circle): pad_hole annulus sizes, N = n_side²
SIZES = [
    ("2k", 40, 48),
    ("6k", 80, 96),
    ("26k", 160, 192),
    ("79k", 280, 320),
    ("160k", 400, 448),
    ("410k", 640, 720),
    ("518k", 720, 800),
    ("803k", 896, 960),
    ("1.05M", 1024, 1088),
    ("1.64M", 1280, 1344),
    ("2M", 1408, 1472),
]

# normalized-divergence gates ‖div u‖_M·h/‖u‖_M, tpufem's (they track its
# measured curves: Stokes/dye/tracers 0.0197–0.0272 across 2k–2M)
DIV_REL_GATES = {"stokes": 0.05, "imported": 0.2, "ns": 0.3}
# velocity boundedness: max|u| < 1.25·(|B1| + |B2|), the squirmer BC scale
MAX_U_FACTOR = 1.25


def bench_config(precond: str = "twolevel", n_nodes: int = 0, transport: str = "none",
                 storage: str = "auto", hbm_io: str = "auto", **overrides) -> stokes.StokesConfig:
    """tpufem's ``bench_config``, field for field (``overrides`` replace
    fields, e.g. ``precision``)."""
    if precond == "twolevel":
        iters_p, tol = 60, 1e-5
    else:
        iters_p, tol = 300, 0.0
    # tpufem's crossover: the warm-started early-exit viscous CG from 10k nodes
    tol_visc = 1e-5 if (tol and n_nodes >= 10_000) else 0.0
    kw = dict(
        dt=0.01, nu=1.0, transport=transport, tracer_density=115, solver="cg",
        cg_storage=storage, precision="f32", cg_iters_visc=30, cg_iters_pressure=iters_p,
        cg_precond=precond, cg_warm_start=True, cg_tol_pressure=tol, cg_tol_visc=tol_visc,
        cg_coarse_dtype="bf16", cg_hbm_io=hbm_io,
    )
    kw.update(overrides)
    return stokes.StokesConfig(**kw)


def physics_report(problem, state, metrics, steps: int, gate: str = "stokes") -> dict:
    """The normalized divergence and tpufem's gates; raises on a failed gate."""
    div_gate = DIV_REL_GATES[gate]
    u = state["u"].detach().double().cpu().numpy()
    if not np.isfinite(u).all():
        raise FloatingPointError("large-mesh run diverged: non-finite velocity")
    cfg = problem.config
    u_scale = abs(float(cfg.B1)) + abs(float(cfg.B2))
    if not np.abs(u).max() < MAX_U_FACTOR * u_scale:
        raise AssertionError(f"velocity {np.abs(u).max():.3f} exceeds {MAX_U_FACTOR}×BC scale "
                             f"{u_scale}: boundedness gate")
    div = problem.div(state["u"]).detach().double().cpu().numpy()
    ml = problem.m_lumped.detach().double().cpu().numpy()
    h = float(np.sqrt(2.0 * np.median(np.asarray(problem.mesh.area))))
    div_l2 = float(np.sqrt((ml * div**2).sum()))
    u_l2 = float(np.sqrt((ml * (u**2).sum(axis=1)).sum()))
    div_rel = div_l2 * h / max(u_l2, 1e-30)
    if not div_rel < div_gate:
        raise AssertionError(f"normalized divergence {div_rel:.4f} ≥ {div_gate} ({gate} gate)")
    # blow-up guard: the max-norm divergence must plateau
    fd = metrics["final_div_max"].detach().double().cpu().numpy()
    if not fd[-1] < 5.0 * (fd[: max(2, steps // 10)].max() + 1.0):
        raise AssertionError(f"divergence did not plateau: {fd[:: max(1, steps // 8)]!r}")
    row = {
        "div_star_max": float(metrics["div_star_max"][-1]),
        "final_div_max": float(fd[-1]),
        "div_rel": round(div_rel, 4),
        "max_u": float(np.abs(u).max()),
    }
    if "c" in state:
        c = state["c"].detach().double().cpu().numpy()
        if not (np.isfinite(c).all() and -0.05 <= c.min() and c.max() <= 1.05):
            raise AssertionError(f"dye left [0, 1]: [{c.min():.3f}, {c.max():.3f}]")
        prog = float(metrics["mixing_progress"][-1])
        if not prog > 0.0:
            raise AssertionError(f"mixing index not advancing: {prog}")
        row["c_range"] = [float(c.min()), float(c.max())]
        row["mixing_progress"] = prog
    return row


def with_iteration_counters(problem):
    """(problem, counters): the problem with int32 device counters on its
    grid solvers, to which each solve adds its iteration count."""
    dev = problem.device
    counters = {}
    changes = {}
    for field in ("visc_solver", "pressure_solver"):
        solver = getattr(problem, field)
        if hasattr(solver, "iters_count"):
            counters[field] = torch.zeros(1, dtype=torch.int32, device=dev)
            changes[field] = dataclasses.replace(solver, iters_count=counters[field])
    return dataclasses.replace(problem, **changes), counters


def _sync(problem) -> None:
    if problem.device.type == "cuda":
        torch.cuda.synchronize(problem.device)


def _timed_run(problem, steps: int, state=None):
    """One synchronised ``run``: (steps/s, state, metrics)."""
    _sync(problem)
    t0 = time.perf_counter()
    state, metrics = stokes.run(problem, steps=steps, state=state)
    _sync(problem)
    return steps / (time.perf_counter() - t0), state, metrics


def run_problem(problem, steps: int):
    """A from-rest run, then a steady continuation from its end state:
    (cold steps/s, state, metrics, warm steps/s, warm state)."""
    cold, state, metrics = _timed_run(problem, steps)
    warm, state2, _ = _timed_run(problem, steps, state)
    return cold, state, metrics, warm, state2


def iterations_per_solve(counters: dict, steps: int) -> dict:
    """Mean iterations per solve since the counters were zeroed (one
    viscous and two pressure solves a step); zeroes them again."""
    out = {}
    for key, per_step in (("visc_solver", 1), ("pressure_solver", 2)):
        if key in counters:
            out[key.split("_")[0]] = int(counters[key].item()) / (per_step * steps)
            counters[key].zero_()
    return out


def run_one(n_side: int, n_circle: int, steps: int, precond: str = "twolevel",
            transport: str = "none", storage: str = "auto", device="cuda",
            profile: bool = True) -> dict:
    """One row: build; the cold run from rest and the warm continuation,
    each with its mean iterations per solve (counted on the device); the
    physics report; on CUDA, the warm run repeated under
    ``torch.profiler`` (the same steps from the same state) for the device
    time a step and the device's busy share of the warm run."""
    from tpufem_torch.bench import card, profile_steps
    from tpufem_torch.mesh import generate_annulus_mesh

    t0 = time.perf_counter()
    mesh = generate_annulus_mesh(n_side=n_side, n_circle=n_circle, pad_hole=True)
    config = bench_config(precond, n_nodes=mesh.n_nodes, transport=transport, storage=storage)
    problem = stokes.StokesProblem.build(mesh, config, device=device)
    problem, counters = with_iteration_counters(problem)
    _sync(problem)
    t_build = time.perf_counter() - t0
    cold, state, metrics = _timed_run(problem, steps)
    iters = {"cold": iterations_per_solve(counters, steps)}
    warm, _, _ = _timed_run(problem, steps, state)
    iters["warm"] = iterations_per_solve(counters, steps)
    row = {
        "n_nodes": int(mesh.n_nodes),
        "n_tris": int(mesh.n_tris),
        "steps": steps,
        "cold_steps_per_sec": cold,
        "warm_steps_per_sec": warm,
        "precond": precond,
        "transport": transport,
        "storage": type(problem.visc_solver.K).__name__,
        "build_s": t_build,
    }
    if hasattr(problem.visc_solver.K, "offsets"):
        row["planes"] = {"visc": len(problem.visc_solver.K.offsets),
                         "pressure": len(problem.pressure_solver.K.offsets)}
        row["remainder"] = {"visc": problem.visc_solver.K.n_rest,
                            "pressure": problem.pressure_solver.K.n_rest}
    if counters:
        row["iters_per_solve"] = iters
    row.update(physics_report(problem, state, metrics, steps))
    if transport == "tracers":
        n_tr = int(problem.tracer_init.shape[0])
        row["n_tracers"] = n_tr
        row["captured_fraction"] = float(metrics["eaten"][-1]) / n_tr
    if problem.device.type == "cuda":
        row["device"] = torch.cuda.get_device_name(problem.device)
        row["card"] = card()
        if profile:
            prof = profile_steps(problem, steps, state=state)
            if counters:
                prof["iters_per_solve"] = iterations_per_solve(counters, steps)
            prof["device_busy_share"] = prof["device_ms_per_step"] * warm / 1e3
            row["profile_of_warm_run"] = prof
    return row


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(prog="python -m tpufem_torch.bench_large")
    parser.add_argument("--size", default="1.05M",
                        help="comma-separated labels from %s" % [s[0] for s in SIZES])
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--precond", default="twolevel", choices=["twolevel", "jacobi"])
    parser.add_argument("--transport", default="none", choices=["none", "tracers", "dye"])
    parser.add_argument("--storage", default="auto", help="cg_storage: auto | grid | csr")
    parser.add_argument("--out", default=None, help="write the rows as JSON lines here too")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_large measures the card: no CUDA device found")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wanted = args.size.split(",")
    unknown = set(wanted) - {s[0] for s in SIZES}
    if unknown:
        raise SystemExit(f"unknown sizes {sorted(unknown)}")
    rows = []
    for label, n_side, n_circle in SIZES:
        if label not in wanted:
            continue
        row = run_one(n_side, n_circle, args.steps, precond=args.precond,
                      transport=args.transport, storage=args.storage)
        row["label"] = label
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows


if __name__ == "__main__":
    main()
