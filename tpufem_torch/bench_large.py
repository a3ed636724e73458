"""Large-mesh benchmark of the scale regime on one CUDA device.

The counterpart of ``tpufem/bench_large.py`` for the squirmer Stokes step
on ring-in-grid pad_hole meshes (N = n_side²), solved matrix-free: K2 for
the viscous solve and K3 (two-level PCG, warm start, tolerance exit) for
both pressure solves, f32 fields, bf16 coarse inverse.

    python -m tpufem_torch.bench_large --size 1.05M [--steps 200] [--transport tracers]
        [--steps-per-call K] [--no-pad-hole] [--storage grid|stencil|banded|csr]
    python -m tpufem_torch.bench_large --poisson | --heat [--size L] [--precision f64]
    python -m tpufem_torch.bench_large --th [--n-side 96] [--engine csr|grid]
        [--precision f64|f32] [--restarts R] [--steps 50]

prints one JSON row like tpufem's (cold and warm steps/s, the physics
report), plus the card's name and power limit, the mean CG iterations per
solve of each run, and a device-time breakdown of the warm run, repeated
under ``torch.profiler``.  ``--steps-per-call K`` runs the step as kernel
K5 (K whole steps a launch); ``--no-pad-hole`` generates the compacted
numbering, which ``--storage grid`` renumbers onto a raster (``gridify``);
``--mesh PATH`` runs an imported Triangle mesh (:func:`run_imported`,
tpufem's "imported" gate) instead of the generated sizes.  ``--ns`` runs
tpufem's Navier–Stokes row instead (:func:`run_ns`: f32, the grid path's K4
velocity and K3 pressure solves on CUDA).  ``--poisson`` and ``--heat`` run
tpufem's matrix-free Poisson and heat rows (:func:`run_poisson_large`,
:func:`run_heat_large`: f32, BiCGStab on the surgery operator, on the
stencil at ≥ 90 % coverage as in tpufem, at
1,048,576 and 160,000 nodes by default).  ``--th`` runs tpufem's sparse
Taylor–Hood row (:func:`run_th_sparse`: f64 by default, the CSR engine or
the grid engine on K2 and K3, beside the same mesh's P1/P1 projection).
There is no CPU fallback: without a CUDA device it fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from tpufem_torch.workloads import navier_stokes, stokes

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


def with_iteration_counters(problem, solves_per_step: dict | None = None):
    """(problem, counters): the problem with int32 device counters on the
    grid solvers named in ``solves_per_step`` (field → solves a step;
    default the Stokes step's one viscous and two pressure solves), to which
    each solve adds its iteration count.  ``counters`` maps each field that
    has a grid solver to (counter, solves a step)."""
    if solves_per_step is None:
        solves_per_step = {"visc_solver": 1, "pressure_solver": 2}
    counters = {}
    changes = {}
    for field, per_step in solves_per_step.items():
        solver = getattr(problem, field)
        if hasattr(solver, "iters_count"):
            count = torch.zeros(1, dtype=torch.int32, device=problem.device)
            counters[field] = (count, per_step)
            changes[field] = dataclasses.replace(solver, iters_count=count)
    step = getattr(problem, "grid_step", None)
    if step is not None:  # K5 runs the same solvers: count there too
        changes["grid_step"] = dataclasses.replace(
            step, visc=changes.get("visc_solver", step.visc),
            pressure=changes.get("pressure_solver", step.pressure))
    return dataclasses.replace(problem, **changes), counters


def _build_kernels(device) -> None:
    """Build (or load) the grid kernels' libraries before any timing, so a
    cold run does not include nvcc; a set-up cost, counted in ``build_s``."""
    if torch.device(device).type == "cuda":
        from tpufem_torch.ops import _nvcc
        from tpufem_torch.solve import grid_cg, grid_step

        _nvcc.build_all([grid_cg.SOURCE, grid_step.SOURCE])
        grid_cg.build()
        grid_step.build()


def _sync(problem) -> None:
    _device_sync(problem.device)


def _device_sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


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
    """Mean iterations per solve since the counters were zeroed, keyed by
    the solver field's first word; zeroes them again."""
    out = {}
    for field, (count, per_step) in counters.items():
        out[field.split("_")[0]] = int(count.item()) / (per_step * steps)
        count.zero_()
    return out


def run_one(n_side: int, n_circle: int, steps: int, precond: str = "twolevel",
            transport: str = "none", storage: str = "auto", device="cuda",
            profile: bool = True, pad_hole: bool = True, steps_per_call: int = 0) -> dict:
    """One row on a generated annulus: see :func:`run_mesh`.  ``pad_hole``
    False takes the compacted numbering, which explicit grid storage
    renumbers (``gridify``)."""
    from tpufem_torch.mesh import generate_annulus_mesh

    t0 = time.perf_counter()
    _build_kernels(device)
    mesh = generate_annulus_mesh(n_side=n_side, n_circle=n_circle, pad_hole=pad_hole)
    return run_mesh(mesh, steps, t0, precond, transport, storage, device, profile,
                    steps_per_call)


def run_imported(path: str, steps: int, precond: str = "twolevel", transport: str = "none",
                 storage: str = "grid", device="cuda", profile: bool = True,
                 steps_per_call: int = 0) -> dict:
    """One row on a Triangle mesh (see :func:`imported_mesh`), through the
    grid kernels by renumbering, under tpufem's "imported" gate (its
    ``run_imported``)."""
    t0 = time.perf_counter()
    _build_kernels(device)
    mesh = imported_mesh(path)
    row = run_mesh(mesh, steps, t0, precond, transport, storage, device, profile,
                   steps_per_call, gate="imported")
    row["mesh"] = path
    row["n_nodes_input"] = int(mesh.n_nodes)
    return row


def imported_mesh(path: str):
    """The mesh of a reference stem such as ``mesh_fine.1``, or of
    ``<path>.node``/``.ele`` (and ``.poly`` where present)."""
    from tpufem_torch import config as tconfig
    from tpufem_torch.mesh import load_mesh

    return load_mesh(tconfig.reference_mesh_path(path) or path)


def run_mesh(mesh, steps: int, t0: float, precond: str = "twolevel", transport: str = "none",
             storage: str = "auto", device="cuda", profile: bool = True,
             steps_per_call: int = 0, gate: str = "stokes") -> dict:
    """One row: build (timed from ``t0``); the cold run from rest and the
    warm continuation, each with its mean iterations per solve (counted on
    the device); the physics report under ``gate``; on CUDA, the warm run
    repeated under ``torch.profiler`` (the same steps from the same state)
    for the device time a step and the device's busy share of the warm
    run.  ``steps_per_call`` ≥ 1 runs K5 (``steps`` a multiple of it)."""
    from tpufem_torch.bench import card, profile_steps

    config = bench_config(precond, n_nodes=mesh.n_nodes, transport=transport, storage=storage,
                          grid_steps_per_call=steps_per_call)
    problem = stokes.StokesProblem.build(mesh, config, device=device)
    problem, counters = with_iteration_counters(problem)
    _sync(problem)
    t_build = time.perf_counter() - t0
    cold, state, metrics = _timed_run(problem, steps)
    iters = {"cold": iterations_per_solve(counters, steps)}
    warm, _, _ = _timed_run(problem, steps, state)
    iters["warm"] = iterations_per_solve(counters, steps)
    row = {
        "n_nodes": int(problem.mesh.n_nodes),
        "n_tris": int(mesh.n_tris),
        "steps": steps,
        "cold_steps_per_sec": cold,
        "warm_steps_per_sec": warm,
        "precond": precond,
        "transport": transport,
        "storage": type(problem.visc_solver.K).__name__,
        "steps_per_call": 0 if problem.grid_step is None else problem.grid_step.steps_per_call,
        "renumbered": problem.gridified is not None,
        "build_s": t_build,
    }
    if hasattr(problem.visc_solver.K, "ns"):  # the grid storage
        row["planes"] = {"visc": len(problem.visc_solver.K.offsets),
                         "pressure": len(problem.pressure_solver.K.offsets)}
        row["remainder"] = {"visc": problem.visc_solver.K.n_rest,
                            "pressure": problem.pressure_solver.K.n_rest}
    if counters:
        row["iters_per_solve"] = iters
    row.update(physics_report(problem, state, metrics, steps, gate))
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


NS_SOLVES = {"vel_solver_grid": 1, "pressure_solver": 1}  # grid solves a step (one projection)


def ns_config(precision: str = "f32", precond: str = "twolevel", storage: str = "auto",
              **overrides) -> navier_stokes.NSConfig:
    """tpufem's ``run_ns`` configuration: implicit advection at Δt = 1e-4,
    ν = 1, BiCGStab capped at 30 iterations, pressure PCG capped at 120,
    both exiting at tol 1e-5 (f32) or 1e-8 (f64)."""
    kw = dict(dt=1e-4, nu=1.0, solver="cg", precision=precision, cg_precond=precond,
              cg_iters_visc=30, cg_iters_pressure=120,
              cg_tol=1e-5 if precision == "f32" else 1e-8, cg_storage=storage)
    kw.update(overrides)
    return navier_stokes.NSConfig(**kw)


def ns_physics_report(problem, u: torch.Tensor, steps: int) -> dict:
    """tpufem's NS gates after ``steps`` steps from rest: a finite velocity,
    max|u| < 10·|f|·t (the ballistic growth of the impulsively forced
    channel, ten times over) and the normalized divergence below
    ``DIV_REL_GATES["ns"]``; raises on a failed gate."""
    from tpufem_torch.ops import assembly, calculus

    mesh, cfg = problem.mesh, problem.config
    uh = u.detach().double().cpu().numpy()
    if not np.isfinite(uh).all():
        raise FloatingPointError("NS run diverged: non-finite velocity")
    u_cap = 10.0 * float(np.abs(np.asarray(cfg.body_force)).max()) * steps * cfg.dt
    if not np.abs(uh).max() < u_cap:
        raise AssertionError(f"NS velocity {np.abs(uh).max():.3e} exceeds 10·|f|·t = {u_cap:.3e}")
    div = calculus.divergence(mesh, u.double()).cpu().numpy()
    ml = assembly.lumped_mass(mesh).numpy()
    h = float(np.sqrt(2.0 * np.median(np.asarray(mesh.area))))
    div_l2 = float(np.sqrt((ml * div**2).sum()))
    u_l2 = float(np.sqrt((ml * (uh**2).sum(axis=1)).sum()))
    div_rel = div_l2 * h / max(u_l2, 1e-30)
    if not div_rel < DIV_REL_GATES["ns"]:
        raise AssertionError(f"NS normalized divergence {div_rel:.4f} ≥ {DIV_REL_GATES['ns']}")
    return {"max_u": float(np.abs(uh).max()), "u_cap": u_cap, "div_rel": div_rel}


def _timed_ns(problem, steps: int, state=None):
    """One synchronised NS ``run``: (steps/s, u, metrics, (u, p))."""
    _sync(problem)
    t0 = time.perf_counter()
    u, metrics, state = navier_stokes.run(problem, steps=steps, state=state, return_state=True)
    _sync(problem)
    return steps / (time.perf_counter() - t0), u, metrics, state


def run_ns_problem(problem, steps: int, counters: dict | None = None) -> dict:
    """A run of ``steps`` from rest and a continuation from its end state,
    with tpufem's gates on both (the continuation at its own elapsed time)
    and, given ``counters``, the mean iterations per solve of each."""
    cold, u, metrics, state = _timed_ns(problem, steps)
    out = {"cold_steps_per_sec": cold, "div_star_max": float(metrics["div_star_max"][-1]),
           "cold": ns_physics_report(problem, u, steps), "state": state}
    if counters:
        out["iters_per_solve"] = {"cold": iterations_per_solve(counters, steps)}
    warm, u2, _, _ = _timed_ns(problem, steps, state)
    out["warm_steps_per_sec"] = warm
    out["warm"] = ns_physics_report(problem, u2, 2 * steps)
    if counters:
        out["iters_per_solve"]["warm"] = iterations_per_solve(counters, steps)
    return out


def run_ns(n_side: int, n_circle: int, steps: int, precision: str = "f32",
           precond: str = "twolevel", storage: str = "auto", device="cuda",
           profile: bool = True) -> dict:
    """One NS row, the twin of tpufem's ``run_ns``: build; a run from rest
    and a continuation from its end state, each with its steps/s and mean
    iterations per solve; tpufem's gates on both (the continuation at its
    own elapsed time); on CUDA the continuation repeated under
    ``torch.profiler`` from the same state."""
    from tpufem_torch.bench import card, profile_run
    from tpufem_torch.mesh import generate_annulus_mesh

    t0 = time.perf_counter()
    _build_kernels(device)
    mesh = generate_annulus_mesh(n_side=n_side, n_circle=n_circle, pad_hole=True)
    config = ns_config(precision, precond, storage)
    problem = navier_stokes.NSProblem.build(mesh, config, device=device)
    problem, counters = with_iteration_counters(problem, NS_SOLVES)
    _sync(problem)
    t_build = time.perf_counter() - t0
    runs = run_ns_problem(problem, steps, counters)
    state = runs.pop("state")
    grid = problem.grid_refill is not None
    row = {
        "workload": "navier_stokes",
        "n_nodes": int(mesh.n_nodes),
        "n_tris": int(mesh.n_tris),
        "steps": steps,
        "precision": precision,
        "precond": precond,
        "storage": "grid" if grid else type(problem.K_csr).__name__,
        "build_s": t_build,
        **runs,
    }
    if grid:
        row["planes"] = {"velocity": len(problem.grid_refill.template.offsets),
                         "pressure": len(problem.pressure_solver.K.offsets)}
        row["remainder"] = {"velocity": problem.grid_refill.template.n_rest,
                            "pressure": problem.pressure_solver.K.n_rest}
    if problem.device.type == "cuda":
        row["device"] = torch.cuda.get_device_name(problem.device)
        row["card"] = card()
        if profile:
            prof = profile_run(lambda: navier_stokes.run(problem, steps=steps, state=state),
                               steps)
            if counters:
                prof["iters_per_solve"] = iterations_per_solve(counters, steps)
            prof["device_busy_share"] = prof["device_ms_per_step"] * row["warm_steps_per_sec"] / 1e3
            row["profile_of_warm_run"] = prof
    return row


def index_share(prof: dict) -> float:
    """The share of a profile's device time spent in index kernels (the
    gathers and ``index_add_`` scatters of the CSR matvec and of the
    two-level restriction), from its ``top`` list."""
    index_ms = sum(k["ms_per_step"] for k in prof["top"] if "index" in k["name"].lower())
    return index_ms / prof["device_ms_per_step"]


def stored_values(op) -> int:
    """The values an operator stores: CSR entries, or a stencil's diagonals
    and remainder."""
    if hasattr(op, "indices"):
        return len(op.indices)
    return int(op.diags.numel()) + op.n_rest


def run_poisson_large(n_side: int, n_circle: int, precision: str = "f32", device="cuda",
                      mesh=None) -> dict:
    """tpufem's ``run_poisson_large``: the matrix-free Poisson solve (the
    row-surgery operator on the stencil, or as CSR where the stencil covers
    under 90 % of it, two-level BiCGStab, at most 2000
    iterations, tol 1e-6 at f32 or 1e-10 at f64) on the pad_hole annulus
    (or ``mesh``), timed twice (the first call and a second, warm one),
    under tpufem's gates: relative residual below 1e-4 and the Dirichlet
    values within 1e-3.  On CUDA the solve is repeated under
    ``torch.profiler``: device ms and kernels an iteration, the device's
    busy share of the warm solve and the index kernels' share."""
    from tpufem_torch.bench import card, profile_run
    from tpufem_torch.mesh import generate_annulus_mesh
    from tpufem_torch.workloads import poisson

    t0 = time.perf_counter()
    if mesh is None:
        mesh = generate_annulus_mesh(n_side=n_side, n_circle=n_circle, pad_hole=True)
    cfg = poisson.PoissonConfig(solver="cg", precision=precision, cg_iters=2000,
                                cg_tol=1e-6 if precision == "f32" else 1e-10)
    run, op, b, boundary = poisson.make_cg_solver(mesh, cfg, device)
    _device_sync(device)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    run(b)
    _device_sync(device)
    first_s = time.perf_counter() - t0
    first_iters = run.iterations
    t0 = time.perf_counter()
    f, res = run(b)
    f_host = f.double().cpu().numpy()
    solve_s = time.perf_counter() - t0

    if not np.isfinite(f_host).all():
        raise AssertionError("Poisson solve non-finite")
    b_norm = float(torch.linalg.norm(b.double()))
    res_rel = float(res) / max(b_norm, 1e-30)
    if not res_rel < 1e-4:
        raise AssertionError(f"Poisson relative residual {res_rel:.2e} ≥ 1e-4")
    # Dirichlet rows are identity rows: the solution carries their values
    want = poisson.dirichlet_values(boundary, cfg.outer_value, cfg.inner_value)
    bc_err = float(np.abs(f_host[boundary.dirichlet] - want).max())
    if not bc_err < 1e-3:
        raise AssertionError(f"Poisson Dirichlet values off by {bc_err:.2e}")
    row = {
        "workload": "poisson",
        "n_nodes": int(mesh.n_nodes),
        "n_tris": int(mesh.n_tris),
        "precision": precision,
        "storage": type(op).__name__,
        "nnz": stored_values(op),
        "build_s": t_build,
        "compile_plus_solve_s": first_s,  # the first call (the port compiles nothing)
        "solve_s": solve_s,
        "iterations": run.iterations,
        "first_iterations": first_iters,
        "res_rel": res_rel,
        "bc_err_max": bc_err,
        "f_range": [float(f_host.min()), float(f_host.max())],
    }
    if torch.device(device).type == "cuda":
        row["device"] = torch.cuda.get_device_name(device)
        row["card"] = card()
        iters = run.iterations
        prof = profile_run(lambda: run(b), iters, top=40)
        prof["device_busy_share"] = prof["device_ms_per_step"] * iters / (solve_s * 1e3)
        prof["index_share"] = index_share(prof)
        prof["top"] = prof["top"][:8]
        row["profile_per_iteration"] = prof
    return row


def run_heat_large(n_side: int, n_circle: int, steps: int = 50, precision: str = "f32",
                   device="cuda", mesh=None) -> dict:
    """tpufem's ``run_heat_large``: the matrix-free implicit-Euler heat run
    (BiCGStab on I + dt·K_mod, on the stencil at ≥ 90 % coverage, warm-started, at most 60 iterations a
    step, tol 1e-6 at f32 or 1e-10 at f64) on the pad_hole annulus (or
    ``mesh``), ``steps`` steps from the initial state twice (the first run
    cold, the second warm), under tpufem's gate: u within [−1e-2, 1 + 1e-2].
    On CUDA the run is repeated under ``torch.profiler``."""
    from tpufem_torch.bench import card, profile_run
    from tpufem_torch.mesh import generate_annulus_mesh
    from tpufem_torch.workloads import heat

    t0 = time.perf_counter()
    if mesh is None:
        mesh = generate_annulus_mesh(n_side=n_side, n_circle=n_circle, pad_hole=True)
    cfg = heat.HeatConfig(solver="cg", precision=precision, steps=steps, cg_iters=60,
                          cg_tol=1e-6 if precision == "f32" else 1e-10)
    problem = heat.HeatProblem.build(mesh, cfg, device)
    u0 = heat.initial_state(problem, mesh.n_nodes)
    _device_sync(device)
    t_build = time.perf_counter() - t0
    applications = problem.solver.applications

    def timed():
        applications[0] = 0
        _device_sync(device)
        t0 = time.perf_counter()
        u, maxu = heat.run_problem(problem, u0, steps)
        _device_sync(device)
        return time.perf_counter() - t0, u, maxu, applications[0] / (2 * steps)

    cold_s, _, _, cold_iters = timed()
    warm_s, u, maxu, warm_iters = timed()
    u_host = u.double().cpu().numpy()
    if not np.isfinite(u_host).all():
        raise AssertionError("heat run non-finite")
    if not (-1e-2 <= u_host.min() and u_host.max() <= 1.0 + 1e-2):
        raise AssertionError(f"heat field left [0,1]: [{u_host.min():.3e}, {u_host.max():.3e}]")
    row = {
        "workload": "heat",
        "n_nodes": int(mesh.n_nodes),
        "n_tris": int(mesh.n_tris),
        "steps": steps,
        "steps_per_sec": steps / warm_s,
        "cold_steps_per_sec": steps / cold_s,
        "precision": precision,
        "storage": type(problem.solver.op).__name__,
        "build_s": t_build,
        "compile_s": cold_s,  # the first run's seconds (the port compiles nothing)
        "iterations_per_step": {"cold": cold_iters, "warm": warm_iters},
        "u_range": [float(u_host.min()), float(u_host.max())],
        "max_u_final": float(maxu[-1]),
    }
    if torch.device(device).type == "cuda":
        row["device"] = torch.cuda.get_device_name(device)
        row["card"] = card()
        prof = profile_run(lambda: heat.run_problem(problem, u0, steps), steps, top=40)
        prof["device_busy_share"] = prof["device_ms_per_step"] * row["steps_per_sec"] / 1e3
        prof["index_share"] = index_share(prof)
        prof["top"] = prof["top"][:8]
        row["profile_per_step"] = prof
    return row


def th_budgets(n_side: int) -> dict:
    """tpufem's h-scaled iteration budgets of the sparse TH row: the inner
    velocity CG's condition number grows like dt·ν/h², so the caps grow
    linearly in ``n_side`` (on the grid engine the velocity solves and the
    outer CG exit on tolerance, so these are caps)."""
    return dict(iters_inner=max(60, int(1.5 * n_side)), iters_outer=max(40, n_side // 2),
                iters_plap=max(20, n_side // 3))


def th_problem(n_side: int, n_circle: int, precision: str = "f64", device="cuda"):
    """(P1 mesh, ``SparseTHProblem``) of tpufem's sparse TH row: the
    enclosed-box squirmer on ``p2_refine(generate_annulus_mesh(n_side,
    n_circle))``, dt 0.01, ν 1, :func:`th_budgets`."""
    from tpufem_torch import generate_annulus_mesh, p2_refine
    from tpufem_torch.workloads import th_sparse

    mesh = generate_annulus_mesh(n_side=n_side, n_circle=n_circle)
    m2 = p2_refine(mesh, snap_center=(0.5, 0.5), snap_radius=0.25)
    cfg = th_sparse.SparseTHConfig(dt=0.01, nu=1.0, precision=precision, **th_budgets(n_side))
    return mesh, th_sparse.SparseTHProblem.build(m2, cfg, device=device)


def run_th_sparse(n_side: int, n_circle: int, steps: int, precision: str = "f64",
                  engine: str = "csr", vel_restarts: int = 0, device="cuda",
                  base=None) -> dict:
    """tpufem's timed sparse Taylor–Hood row (Uzawa-CG) with its same-mesh
    P1/P1 comparison: build (kernels included); one step (tpufem's compile
    step), a timed run of ``steps`` from rest and a continuation of
    ``steps`` from its end; the weak divergence ∫ψ ∇·u against the P1 test
    space beside the P1/P1 projection's (the same mesh, dt, ν and steps;
    f32 CG, two-level, tol 1e-5) under tpufem's gate th_weak < 0.1·p1_weak,
    and the nodal divergence beside it (reported, not gated).

    ``engine="grid"`` runs every velocity solve on K2 and every
    Cahouet–Chabard sweep on K3 (tol_inner 1e-8 at f64, 1e-6 at f32;
    tol_outer 1e-9 or 2e-6; ``vel_restarts`` true-residual passes a
    velocity solve).  On CUDA the row also has the card, the K2 and K3
    launches and mean iterations of the timed run, their iterations a step
    in the timed and in the warm run, and the warm run again under
    ``torch.profiler``.  ``base``: a
    ``(mesh, SparseTHProblem)`` pair from :func:`th_problem` for these
    arguments, to share one build between rows."""
    from tpufem_torch.bench import card, profile_run
    from tpufem_torch.ops import calculus
    from tpufem_torch.solve import grid_cg
    from tpufem_torch.workloads import th_sparse

    t0 = time.perf_counter()
    _build_kernels(device)
    mesh, prob = base if base is not None else th_problem(n_side, n_circle, precision, device)
    counters = {}
    if engine == "grid":
        gprob = th_sparse.GridTHProblem.build(
            prob, tol_inner=1e-8 if precision == "f64" else 1e-6,
            tol_outer=1e-9 if precision == "f64" else 2e-6, vel_restarts=vel_restarts)
        gprob, counters = with_iteration_counters(gprob, {"vel_solver": 1, "plap_solver": 1})
        runner = lambda steps, **kw: th_sparse.run_grid(gprob, steps=steps, **kw)
    elif engine == "csr":
        runner = lambda steps, **kw: th_sparse.run(prob, steps=steps, host_loop=True, **kw)
    else:
        raise ValueError(f"engine {engine!r}: expected 'csr' or 'grid'")
    _device_sync(device)
    t_build = time.perf_counter() - t0

    def launches():
        return grid_cg.viscous_cg.launches, grid_cg.pressure_cg.launches

    t0 = time.perf_counter()
    runner(1)
    _device_sync(device)
    t_first = time.perf_counter() - t0
    for count, _ in counters.values():
        count.zero_()
    before = launches()
    t0 = time.perf_counter()
    u, _, mets, state = runner(steps, return_state=True)
    _device_sync(device)
    elapsed = time.perf_counter() - t0
    after = launches()
    iters = iterations_per_solve(counters, 1)
    u_host = u.double().cpu().numpy()
    if not np.isfinite(u_host).all():
        raise FloatingPointError("sparse TH bench diverged")
    t0 = time.perf_counter()
    runner(steps, state=state)
    _device_sync(device)
    warm = steps / (time.perf_counter() - t0)
    warm_iters = iterations_per_solve(counters, 1)

    th_weak = float(prob.b_apply(u).abs().max())
    th_div = float(mets["final_div_max"])
    p1 = stokes.StokesProblem.build(mesh, stokes.StokesConfig(
        dt=0.01, nu=1.0, solver="cg", precision="f32", transport="none", all_walls=True,
        cg_precond="twolevel", cg_warm_start=True, cg_tol_pressure=1e-5, cg_tol_visc=1e-5),
        device=device)
    s1, m1 = stokes.run(p1, steps=steps)
    p1_div = float(m1["final_div_max"][-1])
    p1_weak = float(calculus.consistent_divergence_rhs(mesh, s1["u"]).abs().max())
    if not th_weak < 0.1 * p1_weak:
        raise AssertionError(f"sparse TH weak divergence {th_weak} not ≪ P1/P1 {p1_weak}")
    row = {
        "n1": int(prob.n1),
        "n2": int(prob.n2),
        "dofs": int(2 * prob.n2 + prob.n1),
        "device": str(torch.device(device)),
        "steps": steps,
        "steps_per_sec": steps / elapsed,
        "warm_steps_per_sec": warm,
        "precision": precision,
        "engine": engine,
        "build_s": t_build,
        "compile_s": t_first,  # the first step's seconds (the port compiles nothing)
        "max_u": float(np.abs(u_host).max()),
        "th_final_div_max": th_div,
        "th_div_weak_max": th_weak,
        "p1p1_final_div_max": p1_div,
        "p1p1_div_weak_max": p1_weak,
        "div_ratio_weak": p1_weak / max(th_weak, 1e-30),
    }
    if engine == "grid":
        row.update(vel_restarts=vel_restarts, ns2=gprob.ns2, ns1=gprob.ns1,
                   planes={"velocity": len(gprob.vel_solver.K.offsets),
                           "pressure": len(gprob.plap_solver.K.offsets)},
                   remainder={"velocity": gprob.vel_solver.K.n_rest,
                              "pressure": gprob.plap_solver.K.n_rest})
    if torch.device(device).type == "cuda":
        row["device"] = torch.cuda.get_device_name(device)
        row["card"] = card()
        if engine == "grid":
            k2, k3 = after[0] - before[0], after[1] - before[1]
            row["launches_per_step"] = {"K2": k2 / steps, "K3": k3 / steps}
            row["iters_per_solve"] = {"K2": iters["vel"] / max(k2, 1),
                                      "K3": iters["plap"] / max(k3, 1)}
            row["iters_per_step"] = {"K2": iters["vel"] / steps, "K3": iters["plap"] / steps}
            row["warm_iters_per_step"] = {"K2": warm_iters["vel"] / steps,
                                          "K3": warm_iters["plap"] / steps}
        prof = profile_run(lambda: runner(steps, state=state), steps, top=40)
        prof["device_busy_share"] = prof["device_ms_per_step"] * warm / 1e3
        for name, key in (("viscous_cg", "K2_share"), ("pressure_cg", "K3_share")):
            prof[key] = sum(k["ms_per_step"] for k in prof["top"]
                            if name in k["name"]) / prof["device_ms_per_step"]
        prof["top"] = prof["top"][:8]
        row["profile_of_warm_run"] = prof
    return row


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(prog="python -m tpufem_torch.bench_large")
    parser.add_argument("--size", default=None,
                        help="comma-separated labels from %s (default 1.05M; 160k with --heat)"
                        % [s[0] for s in SIZES])
    parser.add_argument("--steps", type=int, default=None,
                        help="steps a run (default 200; 50 with --heat)")
    parser.add_argument("--precond", default="twolevel", choices=["twolevel", "jacobi"])
    parser.add_argument("--transport", default="none", choices=["none", "tracers", "dye"])
    parser.add_argument("--storage", default="auto",
                        help="cg_storage: auto | grid | stencil | banded | csr (NS: auto | "
                             "grid | stencil | csr)")
    parser.add_argument("--steps-per-call", type=int, default=0,
                        help="grid_steps_per_call: K ≥ 1 runs kernel K5, K steps a launch")
    parser.add_argument("--no-pad-hole", action="store_true",
                        help="compacted (non-grid) numbering: with --storage grid it is "
                             "renumbered onto a raster (gridify)")
    parser.add_argument("--mesh", default=None,
                        help="an imported Triangle mesh (path stem or reference mesh name) "
                             "instead of the generated sizes; storage grid unless --storage")
    parser.add_argument("--ns", action="store_true",
                        help="run the Navier–Stokes configuration (run_ns) instead of Stokes")
    parser.add_argument("--poisson", action="store_true",
                        help="run the matrix-free Poisson solve (run_poisson_large) instead")
    parser.add_argument("--heat", action="store_true",
                        help="run the matrix-free heat run (run_heat_large) instead")
    parser.add_argument("--precision", default=None, choices=["f32", "f64"],
                        help="--poisson/--heat/--th precision (default f32; f64 with --th)")
    parser.add_argument("--th", action="store_true",
                        help="run the sparse Taylor–Hood row (run_th_sparse) instead")
    parser.add_argument("--n-side", type=int, default=96,
                        help="--th mesh resolution (P2 dofs about 4·n_side²)")
    parser.add_argument("--engine", default="csr", choices=["csr", "grid"],
                        help="--th engine: csr (plain CSR Uzawa-CG) or grid (K2 and K3)")
    parser.add_argument("--restarts", type=int, default=0,
                        help="--th --engine grid: true-residual passes a velocity solve")
    parser.add_argument("--out", default=None, help="write the rows as JSON lines here too")
    args = parser.parse_args(argv)
    if args.size is None:
        args.size = "160k" if args.heat else "1.05M"
    if args.steps is None:
        args.steps = 50 if args.heat or args.th else 200
    if args.precision is None:
        args.precision = "f64" if args.th else "f32"
    if not torch.cuda.is_available():
        raise SystemExit("bench_large measures the card: no CUDA device found")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.th:
        row = run_th_sparse(args.n_side, args.n_side, args.steps, precision=args.precision,
                            engine=args.engine, vel_restarts=args.restarts)
        row["label"] = f"th-{args.n_side}"
        print(json.dumps(row), flush=True)
        return [row]
    wanted = args.size.split(",")
    unknown = set(wanted) - {s[0] for s in SIZES}
    if unknown:
        raise SystemExit(f"unknown sizes {sorted(unknown)}")
    rows = []
    if args.mesh:
        rows.append(run_imported(args.mesh, args.steps, precond=args.precond,
                                 transport=args.transport,
                                 storage="grid" if args.storage == "auto" else args.storage,
                                 steps_per_call=args.steps_per_call))
        print(json.dumps(rows[-1]), flush=True)
    for label, n_side, n_circle in SIZES:
        if args.mesh or label not in wanted:
            continue
        if args.poisson:
            row = run_poisson_large(n_side, n_circle, precision=args.precision)
        elif args.heat:
            row = run_heat_large(n_side, n_circle, args.steps, precision=args.precision)
        elif args.ns:
            row = run_ns(n_side, n_circle, args.steps, precond=args.precond,
                         storage=args.storage)
        else:
            row = run_one(n_side, n_circle, args.steps, precond=args.precond,
                          transport=args.transport, storage=args.storage,
                          pad_hole=not args.no_pad_hole, steps_per_call=args.steps_per_call)
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
