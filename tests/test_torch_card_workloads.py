"""The other workloads on the card: Navier–Stokes (K4, K3, E, G), Poisson,
heat, the small workloads, Stam's grid solver, the Taylor–Hood solvers, the
diagnostics, the convergence studies, every CLI subcommand and the
gallery, each against the port's CPU path or under tpufem's gates."""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from _card import (BIG, CPU, DIAG_TOL, GALLERY_RTOL, MID, PARITY, STORAGE_APPLY_RTOL, XL_C_SLACK,
                   annulus, cached, card, counting, kernels, max_abs, ns_grid, rel, stokes_grid,
                   xl_problem)
from tpufem_torch import bench_large, cli, diag, gallery, interop, p2_refine, transport
from tpufem_torch.ops import assembly, calculus
from tpufem_torch.ops.gridop import GridOperator
from tpufem_torch.ops.stencil import StencilOperator
from tpufem_torch.solve import grid_cg
from tpufem_torch.workloads import (advection_diffusion, graph_average, heat, navier_stokes,
                                    poisson, stam_grid, stokes, th_sparse)

assert card  # the fixture, imported for the tests below
pytestmark = pytest.mark.card


def test_ns_step_at_scale(card):
    """tpufem's ``run_ns`` at 10⁶ nodes, 200 steps and 200 more, under its gates."""
    problem, counters = bench_large.with_iteration_counters(ns_grid(card, *BIG),
                                                            bench_large.NS_SOLVES)
    with counting() as n:
        row = bench_large.run_ns_problem(problem, 200, counters)
    assert n == {"K3": 400, "K4": 400, "E": 400, "G": 400}
    u, p = row["state"]
    assert bool(torch.isfinite(u).all() and torch.isfinite(p).all())


def test_ns_grid_step_card_against_cpu(card):
    """n_side=40, 10 steps; |u| is ~1e-5 here, so the absolute bound alone
    would let a wrong f64 kernel through."""
    u = []
    for device, precision in ((card, "f64"), (CPU, "f64"), (card, "f32")):
        problem = ns_grid(device, *PARITY, precision)
        assert problem.grid_refill is not None
        u.append(navier_stokes.run(problem, steps=10)[0])
    g, c, f = u
    assert max_abs(g, c) <= 1e-6 and rel(g, c) <= 1e-9
    assert rel(f, g) <= 5e-3


def test_ns_dense_step_card_against_cpu(card):
    mesh = annulus(12, 16)
    u = [navier_stokes.run(navier_stokes.NSProblem.build(mesh, navier_stokes.NSConfig(),
                                                         device=d), steps=20)[0]
         for d in (card, CPU)]
    assert rel(*u) <= 1e-10


def test_poisson_at_scale(card):
    """tpufem's ``run_poisson_large`` at 10⁶ nodes, under its gates."""
    with counting() as n:
        bench_large.run_poisson_large(*BIG, device=card, mesh=annulus(*BIG, pad_hole=True))
    assert n == {}


@cached
def poisson_system(device) -> tuple:
    """The 10⁶-node Poisson operator on the stencil, as CSR, and its rhs."""
    cfg = poisson.PoissonConfig(solver="cg", precision="f32", cg_iters=2000, cg_tol=1e-6)
    mesh = annulus(*BIG, pad_hole=True)
    op, K, b, _ = poisson.build_system_csr(mesh, cfg, device)
    return mesh, cfg, op, K, b.to(torch.float32)


@pytest.mark.parametrize("storage", ["csr", "stencil", "grid"])
def test_poisson_on_each_storage(card, storage):
    """The operator on CSR, on the stencil (the solve's) and on the card's
    grid split (plain apply), with tpufem's residual gate."""
    mesh, cfg, op, K, b = poisson_system(card)
    assert isinstance(op, StencilOperator)
    csr = K.astype(torch.float32)
    ops = {"csr": csr, "stencil": op.astype(torch.float32),
           "grid": GridOperator.dense_split(K, int(round(mesh.n_nodes ** 0.5)), device=card)}
    x = torch.randn(mesh.n_nodes, generator=torch.Generator(device=card).manual_seed(5),
                    device=card)
    assert rel(ops[storage].matvec(x), csr.matvec(x)) <= STORAGE_APPLY_RTOL
    with counting() as n:
        _, res = poisson.cg_solver_on(ops[storage], K, mesh, cfg)(b)
    assert n == {} and float(res) / float(torch.linalg.norm(b)) < 1e-4


@pytest.mark.parametrize("size", ["160k", "1m"])
def test_heat_at_scale(card, size):
    sides = {"160k": MID, "1m": BIG}[size]  # tpufem's run_heat_large, under its gate
    with counting() as n:
        bench_large.run_heat_large(*sides, 50, device=card, mesh=annulus(*sides, pad_hole=True))
    assert n == {}


SMALL_RUNS = {
    **{f"poisson-{s}": (lambda m, d, s=s: poisson.solve(
        m, poisson.PoissonConfig(solver=s), device=d)[0], 1e-9 if s == "cg" else 1e-10)
       for s in ("lu", "inverse", "cg")},
    **{f"heat-{s}": (lambda m, d, s=s: heat.run(m, heat.HeatConfig(solver=s), steps=50,
                                                device=d)[0], 1e-9 if s == "cg" else 1e-10)
       for s in ("lu", "cg")},
    "advection-diffusion": (lambda m, d: advection_diffusion.run(
        advection_diffusion.ADProblem.build(m, device=d), 100)[0], 1e-10),
    "graph-average": (lambda m, d: graph_average.solve(m, device=d)[0], 1e-10),
}


@pytest.mark.parametrize("case", SMALL_RUNS)
def test_small_workloads_card_against_cpu(card, case):
    run, limit = SMALL_RUNS[case]
    with counting() as n:
        g, c = (run(annulus(20, 24), d).detach().double().cpu() for d in (card, CPU))
    assert n == {} and rel(g, c) <= limit


def test_stam_runs_on_the_card(card):
    with counting() as n:
        state, speed = stam_grid.run(stam_grid.StamConfig(), frames=200, device=card)
    assert n == {}
    assert bool(torch.isfinite(state["density"]).all() and torch.isfinite(speed).all())


def test_stam_card_frame_against_cpu(card):
    """Each card frame from the CPU's state: the flow amplifies roundoff ~4×
    a frame, so free-running runs part."""
    cfg = stam_grid.StamConfig(size=64, precision="f64")
    host, worst = stam_grid.initial_state(cfg, device=CPU), 0.0
    with counting() as n:
        for _ in range(50):
            from_host = stam_grid.step(cfg, {k: v.to(card) for k, v in host.items()})
            host = stam_grid.step(cfg, host)
            worst = max([worst] + [max_abs(from_host[k], host[k]) for k in ("vx", "vy", "density")])
    assert n == {} and worst <= 1e-10


def test_dense_taylor_hood_card_against_cpu(card):
    """5,192 dofs: the steady solve, and the θ-scheme built on the host and
    carried to the card."""
    mesh = p2_refine(annulus(28, 32), snap_center=(0.5, 0.5), snap_radius=0.25)
    with counting() as n:
        u, p, res = navier_stokes.solve_taylor_hood(mesh, device=card)
        assert float(res) < 1e-10 and bool(torch.isfinite(u).all() and torch.isfinite(p).all())
        cfg = navier_stokes.TransientTHConfig(dt=0.01)
        host = navier_stokes.TransientTHProblem.build(mesh, cfg, device=CPU)
        arrays = {"e_inv": host.e_inv.numpy(), "r_op": host.r_op.numpy(),
                  "bc_dofs": host.bc_dofs, "bc_values": host.bc_values.numpy(),
                  "corners": host.corners}
        u_gpu, p_gpu, m_gpu = navier_stokes.run_transient_th(
            interop.th_problem_from_numpy(arrays, mesh, cfg, card), 200)
        u_cpu, p_cpu, m_cpu = navier_stokes.run_transient_th(host, 200)
        u32, _, _ = navier_stokes.run_transient_th(interop.th_problem_from_numpy(
            arrays, mesh, navier_stokes.TransientTHConfig(dt=0.01, precision="f32"), card), 200)
    assert n == {}
    assert rel(u_gpu, u_cpu) <= 1e-10 and rel(p_gpu, p_cpu) <= 1e-10
    assert rel(m_gpu["div_max"], m_cpu["div_max"]) <= 1e-10
    assert rel(u32, u_gpu) <= 1e-4


@pytest.mark.parametrize("restarts", [0, 1])
def test_taylor_hood_row_on_the_grid_engine(card, restarts):
    """The TH-192 row (241,880 dofs, f32) under tpufem's gate (in
    ``run_th_sparse``); a step launches K2 (1 + restarts)·(K3 + 2) times."""
    with counting() as n:
        row = bench_large.run_th_sparse(192, 192, 10, precision="f32", engine="grid",
                                        vel_restarts=restarts, device=card, base=th_base(card))
    assert set(kernels(n)) == {"K2", "K3"}
    per = row["launches_per_step"]
    assert round(per["K2"] * 10) == (1 + restarts) * (round(per["K3"] * 10) + 2 * 10)


th_base = cached(lambda device: bench_large.th_problem(192, 192, "f32", device))


@pytest.mark.parametrize("engine", ["csr", "grid", "steady"])
def test_sparse_taylor_hood_card_against_cpu(card, engine):
    """The CSR and grid engines (f64, 10 steps) and the steady Uzawa solve
    against the dense one."""
    mesh = p2_refine(annulus(20, 20), snap_center=(0.5, 0.5), snap_radius=0.25)
    if engine == "steady":
        with counting() as n:
            us, _ = th_sparse.steady_solve(th_sparse.SparseTHProblem.build(mesh, device=card),
                                           iters_inner=200, iters_outer=40)
            ud, _, _ = navier_stokes.solve_taylor_hood(mesh, device=card)
        assert n == {} and max_abs(us, ud) <= 1e-9
        return

    def run(d):
        problem = th_sparse.SparseTHProblem.build(mesh, th_sparse.SparseTHConfig(), device=d)
        if engine == "csr":
            return th_sparse.run(problem, steps=10)[0]
        gp = th_sparse.GridTHProblem.build(problem, tol_inner=0.0, target_coarse=64)
        return th_sparse.run_grid(gp, steps=10)[0]

    with counting() as n:
        g = run(card)
    assert set(kernels(n)) == (set() if engine == "csr" else {"K2", "K3"})
    assert rel(g, run(CPU)) <= (1e-10 if engine == "csr" else 1e-9)


def test_ns_against_taylor_hood(card):
    """``benchmarks/ns_th_xcheck_r5.py``'s rotational row at n_side 28: NS
    with ``mass_consistent`` against the CSR TH engine at the P1 nodes in
    the lumped-mass L2 norm (tpufem's committed 0.051)."""
    mesh = annulus(28, 28)

    def force(xy):
        return np.stack([2.0 * (0.5 - xy[:, 1]), 2.0 * (xy[:, 0] - 0.5)], axis=1)

    m2 = p2_refine(mesh, snap_center=(0.5, 0.5), snap_radius=0.25)
    th = th_sparse.SparseTHProblem.build(m2, th_sparse.SparseTHConfig(
        dt=1e-4, nu=1.0, B1=0.0, B2=0.0, body_force=force(m2.coords), precision="f64",
        **bench_large.th_budgets(28)), device=card)
    u_th = th_sparse.run(th, steps=50, host_loop=True)[0].double().cpu().numpy()[th.corners]
    ns = navier_stokes.NSProblem.build(mesh, navier_stokes.NSConfig(
        dt=1e-4, nu=1.0, body_force=force(mesh.coords), solver="cg", precision="f64",
        cg_iters_visc=40, cg_iters_pressure=200, cg_tol=1e-10, cg_precond="twolevel",
        mass_consistent=True), device=card)
    u_ns = navier_stokes.run(ns, steps=50)[0].double().cpu().numpy()
    ml = assembly.lumped_mass(mesh).numpy()

    def l2(v):
        return float(np.sqrt((ml * (v ** 2).sum(axis=1)).sum()))

    assert l2(u_ns - u_th) / max(l2(u_th), 1e-30) <= 0.1


# tpufem's gates on Tests A–J (tests/test_diag.py); the Laplacian against
# div∘grad is held to the mesh's own gate: tpufem's 0.9 is for mesh.1, and
# generated meshes hold its jittered-mesh 0.5 (tpufem reads 0.734 on (40, 48))
DIAG_GATES = {
    "gradient_test": lambda g: float((g - torch.tensor([2.0, 3.0])).abs().max()) <= 0.1,
    "divergence_test": lambda d: abs(float(d) - 5.0) < 0.1,
    "adjointness_test": lambda v: float(v) < 1e-6,
    "laplacian_vs_divgrad_test": lambda v: float(v) > 0.5,
    "checkerboard_response": lambda v: float(v) > 1.0,
    "laplacian_blind_spot_test": lambda v: float(v) > 1.0,
    "gradient_of_checkerboard_test": lambda v: float(v) > 0.1,
    "projection_consistency_test": lambda v: float(v) > 0.9,
    "rhs_handling_test": lambda v: float(v) < 1e-12,
}
DIAG_MESHES = {"(40, 48)": dict(n_side=40, n_circle=48),
               "jittered (24, 28)": dict(n_side=24, n_circle=28, jitter=0.25, seed=3)}


def diag_close(card_value, cpu_value) -> float:
    """max |card − CPU| / max(|CPU|, 1): values that are roundoff themselves
    (adjointness, RHS handling, the smallest eigenvalue) held absolutely."""
    a = torch.as_tensor(card_value, dtype=torch.float64).cpu()
    b = torch.as_tensor(cpu_value, dtype=torch.float64)
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())


@pytest.mark.parametrize("mesh", DIAG_MESHES)
def test_diagnostics_card_against_cpu(card, mesh):
    mesh = annulus(**DIAG_MESHES[mesh])
    for name, gate in DIAG_GATES.items():
        fn = getattr(diag, name)
        got = fn(mesh, device=card)
        assert diag_close(got, fn(mesh, device=CPU)) <= DIAG_TOL, name
        assert gate(torch.as_tensor(got).cpu()), name
    rep = diag.preflight(mesh)
    assert rep.ok and rep.n_degenerate == 0 and rep.min_area > 1e-6 and rep.viscous_cfl_dt(0.1) > 0
    K = assembly.assemble_dense(mesh, assembly.element_stiffness(mesh, device=card))
    eig, eig_cpu = diag.pressure_matrix_eigen_check(K), diag.pressure_matrix_eigen_check(K.cpu())
    assert eig[2] == eig_cpu[2] == 0 and eig[1] > 0 and diag_close(eig[:2], eig_cpu[:2]) <= DIAG_TOL
    rng = np.random.default_rng(13)
    u, p = rng.standard_normal((mesh.n_nodes, 2)), rng.standard_normal(mesh.n_nodes)
    assert rel(calculus.vorticity(mesh, torch.as_tensor(u, device=card)),
               calculus.vorticity(mesh, torch.as_tensor(u))) <= DIAG_TOL
    gx, gy = (torch.as_tensor(g, device=card) for g in calculus.gradient_matrices(mesh))
    pt = torch.as_tensor(p, device=card)
    assert rel(torch.stack([gx @ pt, gy @ pt], dim=1), calculus.gradient(mesh, pt)) <= DIAG_TOL


def test_diagnostics_on_the_scale_problem(card):
    """At 10⁶ nodes.  The projection oracle as tests/test_diag.py applies
    it, to a bare projection of (sin 2πx, 0): on the max-norm single-step
    numbers it does not hold (0.64)."""
    big = dataclasses.replace(stokes_grid(card, *BIG))  # its own graph cache
    with counting() as n:
        d = diag.single_step_diagnostics(big)
    assert n == {"K2": 1, "K3": 1}
    assert d["max_u_star"] > 0 and np.isfinite(d["max_p"])
    assert d["div_after_max"] < d["div_star_max"]
    coords = torch.as_tensor(big.mesh.coords, dtype=big.dtype, device=card)
    u0 = torch.stack([torch.sin(2 * np.pi * coords[:, 0]), torch.zeros_like(coords[:, 0])], dim=1)
    dt, interior = big.config.dt, torch.as_tensor(big.mesh.markers == 0, device=card)
    d0 = big.div(u0)
    d1 = big.div(u0 - dt * big.grad(big.pressure_solver.solve(-d0 / dt)))
    assert diag.projection_reduces_divergence({"initial_div": float(d0[interior].abs().mean()),
                                               "final_div": float(d1[interior].abs().mean())})
    _, first = stokes.run(big, steps=50)
    _, ok = diag.run_guarded(big, 200, chunk=50)
    assert ok == {"status": "ok", "completed_steps": 200, "reason": None}
    _, bad = diag.run_guarded(big, 200, chunk=50,
                              max_div=0.5 * float(first["final_div_max"].max()))
    assert bad["status"] == "aborted" and bad["completed_steps"] == 0


# (study, flags, the kernels its path launches): th runs to T = 8 (--steps0
# 800): at the CLI's default T = 1.5 the flow is not yet steady and fails
# tpufem's monotone gate in both packages
CONVERGE = {"self": (["--sizes", "1.6k,6.5k,26k"], {"K2", "K3"}),
            "ns": (["--sizes", "2k,6.5k,26k"], {"K4", "K3"}),
            "th": (["--sizes", "0.5k,0.8k,1.2k", "--steps0", "800"], set())}


@pytest.mark.parametrize("study", CONVERGE)
def test_convergence_studies(card, study):
    """``cli.main`` raises on a failed monotone gate (and ``self`` on the
    Stokes div_rel gate)."""
    flags, launched = CONVERGE[study]
    with counting() as n:
        cli.main(["converge", "--study", study] + flags)
    assert set(kernels(n)) - {"E", "G"} == launched


def cli_json(argv: list) -> list:
    """``python -m tpufem_torch`` in process → its JSON lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]


def finite(tree) -> bool:
    if isinstance(tree, dict):
        return all(finite(v) for v in tree.values())
    return bool(np.isfinite(tree))


SQUIRMER = bench_large.MAX_U_FACTOR * 2.0  # max|u| < 1.25·(|B1| + |B2|), B1 = −2, B2 = 0


def omega_r() -> float:
    """The rotating cylinder's surface speed on the CLI's generated mesh."""
    mesh = annulus(24, 32)
    return 5.0 * float(np.hypot(*(mesh.coords[mesh.markers == 2] - 0.5).T).max())


# each subcommand on --mesh generated, held to the gates of tpufem's CLI
# tests and workloads
CLI = {
    "poisson": (["poisson"], lambda j: j["residual"] < 1e-8),
    "heat": (["heat", "--steps", "20"],
             lambda j: -1e-2 <= j["max_u"]["min"] and j["max_u"]["max"] <= 1 + 1e-2),
    "stokes": (["stokes", "--steps", "20"],
               lambda j: j["max_u"]["max"] < SQUIRMER and 0 <= j["mixing_progress"]["final"] <= 1),
    "food": (["food", "--steps", "20", "--precision", "f32"],
             lambda j: j["max_u"]["max"] < SQUIRMER and j["eaten"]["min"] >= 0),
    "report": (["report", "--steps", "20"], lambda j: j["max_u"]["max"] <= omega_r()),
    "ns": (["ns", "--steps", "20"], lambda j: j["max_u"]["max"] < 1.0),
    "monolithic": (["monolithic"], lambda j: j["residual"] < 1e-8),
    "taylorhood": (["taylorhood"], lambda j: j["residual"] < 1e-8 and j["max_u"] < SQUIRMER),
    "taylorhood-transient": (["taylorhood", "--steps", "20"], lambda j: j["max_u"] < SQUIRMER),
    "taylorhood-sparse": (["taylorhood", "--sparse", "--steps", "5"],
                          lambda j: j["max_u"] < SQUIRMER and j["div_weak_max"] < 1e-3),
    "ad": (["ad", "--steps", "20"], lambda j: j["max_f"]["min"] >= 0),
    "graph": (["graph"], lambda j: j["residual"] < 1e-8),
    "sweep": (["sweep", "--steps", "100"], lambda j: all(0 <= v <= 100 for v in j.values())),
}


@pytest.mark.parametrize("command", CLI)
def test_cli_subcommands(card, command):
    argv, gate = CLI[command]
    with counting() as n:
        lines = cli_json(argv[:1] + ["--mesh", "generated"] + argv[1:])
    assert len(lines) == 1
    (_, value), = lines[0].items()
    assert finite(value) and gate(value)
    if command == "food":
        assert n.get("K1") == 20


def test_cli_help_stam_and_bench(card):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exited:
        cli.main(["--help"])
    assert exited.value.code == 0 and "usage" in out.getvalue().lower()
    lines = cli_json(["stam", "--frames", "20"])
    assert len(lines) == 1 and np.isfinite(lines[0]["stam"]["final_max_speed"])
    with counting() as n:
        lines = cli_json(["bench", "--large", "--sizes", "160k", "--steps", "20"])
    assert len(lines) == 1 and lines[0]["n_nodes"] == 160_000 and {"K2", "K3"} <= set(n)


def test_gallery_fields_card_against_cpu(card):
    """Full sizes on the card; quick sizes against the CPU, where the full
    ones take minutes."""
    with counting() as n:
        full = gallery.fields(quick=False, device=card)
        quick, host = (gallery.fields(quick=True, device=d) for d in (card, CPU))
    assert not kernels(n)
    for fields in (full, quick, host):
        assert all(np.isfinite(v).all() for v in fields.values())
    for k, v in quick.items():
        if k.endswith("tracer_status"):
            assert np.array_equal(v, host[k]), k
        elif k not in ("coords", "tris"):
            err = float(np.linalg.norm(v - host[k]) / max(np.linalg.norm(host[k]), 1e-300))
            assert err <= GALLERY_RTOL, k


def test_xl_dye_movie_path(card):
    """The flagship dye movie's 409,600-node problem, 100 of its 600 steps."""
    problem = xl_problem(card)
    assert isinstance(problem.pressure_solver, grid_cg.PressureGridCG)
    with counting() as n:
        run = gallery.xl_run(problem, 100, 20)
    assert kernels(n) == {"K2": 100, "K3": 200}
    frames = run["frames"]
    lo, hi = float(frames[0].min()), float(frames[0].max())
    mass, mask = problem.m_lumped, stokes._interior_mask(problem)
    for f in frames:
        assert np.isfinite(f).all()
        assert f.min() >= lo - XL_C_SLACK and f.max() <= hi + XL_C_SLACK
        index = float(transport.mixing_index(torch.as_tensor(f, device=card), mass, mask)[0])
        assert np.isfinite(index) and -XL_C_SLACK <= index <= 1.0 + XL_C_SLACK
    metrics = {k: torch.cat([m[k] for m in run["metrics"]]) for k in run["metrics"][0]}
    phys = bench_large.physics_report(problem, run["state"], metrics, 100)
    assert phys["div_rel"] < bench_large.DIV_REL_GATES["stokes"]
