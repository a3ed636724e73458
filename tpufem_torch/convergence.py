"""Accuracy-at-scale convergence study (``python -m tpufem_torch converge``).

The PyTorch counterpart of ``tpufem.convergence``, with its ladders, its
dt ∝ h law (a fixed physical horizon, so every size integrates the same
flow) and its monotone gates.  It shows that the fast paths compute
converging physics, not fast noise:

1. ``self``: velocity self-convergence of the squirmer Stokes run.  Every
   rung's solution is sampled at one fixed probe set (P1 interpolation
   through the transport locator) and measured against the finest rung
   (relative L2); the error must fall monotonically.  Each row also gives
   the normalized divergence ‖div u‖_M·h/‖u‖_M (``bench_large``'s gate).
2. ``th``: the P1/P1 projection's steady state against the LBB-stable
   P2/P1 Taylor–Hood solution of the same mesh (dense ``solve_taylor_hood``
   below ``DENSE_TH_DOF_CEIL`` dofs, ``th_sparse.steady_solve`` above).
3. ``ns``: Navier–Stokes velocity self-convergence and the normalized
   divergence on the transient.

On the card, ``self`` and ``ns`` take the grid storage at f32 (kernels K2
and K3, and K4 and K3); ``th`` runs CSR and dense solves.  Output: one JSON
line per rung and a markdown table.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from tpufem_torch import config as tconfig

# (label, n_side, n_circle): pad_hole ladder; dt ∝ 1/(n_side−1) ∝ h
SELF_SIZES = [
    ("1.6k", 40, 48),
    ("6.5k", 80, 96),
    ("26k", 160, 192),
    ("79k", 280, 320),
    ("160k", 400, 448),
]
DT0 = 0.01  # at n_side = 40 (the reference's food-run dt, StokesFood.py:42)
T_FINAL = 1.0  # physical horizon: ~viscous time L²/ν, well into steady state
NU = 1.0


def probe_points(n: int = 1600, seed: int = 7) -> np.ndarray:
    """Fixed probe set: quasi-uniform points in the annulus interior,
    ≥0.33 from the center (off the squirmer surface) and ≥0.08 from the
    outer boundary, identical across every mesh size."""
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < n:
        cand = rng.uniform(0.08, 0.92, size=(4 * n, 2))
        r = np.hypot(cand[:, 0] - 0.5, cand[:, 1] - 0.5)
        cand = cand[r > 0.33]
        pts.extend(cand.tolist())
    return np.asarray(pts[:n])


def _steady_config(n_side: int, steps: int, dt: float, storage: str = "auto",
                   all_walls: bool = False, lift: bool = True):
    from tpufem_torch.workloads import stokes

    return stokes.StokesConfig(
        dt=dt, nu=NU, transport="none", solver="cg", cg_storage=storage,
        precision="f32", cg_iters_visc=30, cg_iters_pressure=60,
        cg_precond="twolevel", cg_warm_start=True, cg_tol_pressure=1e-5,
        cg_tol_visc=1e-5 if n_side >= 160 else 0.0, all_walls=all_walls,
        # consistent Dirichlet-column lifting: without it the projection
        # inherits the reference's accuracy ceiling and does not converge
        # to the Taylor–Hood solution
        dirichlet_lift=lift,
    )


def _locator(mesh, dtype, device):
    """The locator a default Stokes problem would build on ``mesh``: the NS
    ladder's probe (tpufem builds a throwaway Stokes problem for it)."""
    from tpufem_torch.workloads import stokes

    return stokes._make_locator(mesh, stokes.StokesConfig(), dtype, device)


def _probe(mesh, u: torch.Tensor, pts: np.ndarray, locator):
    """P1 samples of ``u`` at ``pts`` (in ``u``'s dtype): (values f64, found)
    on the host."""
    from tpufem_torch import transport

    vals, found = transport.interpolate(
        mesh, u, torch.as_tensor(pts, dtype=u.dtype, device=u.device), locator)
    return vals.detach().double().cpu().numpy(), found.cpu().numpy()


def _errors_vs_finest(rows: list, sampled: list) -> None:
    ref = sampled[-1]
    ref_norm = float(np.sqrt((ref**2).mean()))
    for row, vals in zip(rows, sampled):
        row["err_vs_finest"] = round(float(np.sqrt(((vals - ref) ** 2).mean())) / ref_norm, 6)


def _check_decreasing(rows: list, key: str, what: str) -> None:
    errs = [r[key] for r in rows]
    if not all(a > b for a, b in zip(errs, errs[1:])):
        raise AssertionError(f"{what} not decreasing under refinement: {errs}")


def run_self(sizes=None, steps0: int | None = None, storage: str = "auto",
             check: bool = True, device=None):
    """Self-convergence ladder → list of row dicts (finest = reference)."""
    from tpufem_torch import bench_large
    from tpufem_torch.mesh.generate import generate_annulus_mesh
    from tpufem_torch.workloads import stokes

    dev = tconfig.device(device)
    sizes = sizes or SELF_SIZES
    pts = probe_points()
    sampled, rows = [], []
    for label, n_side, n_circle in sizes:
        dt = DT0 * (40 - 1) / (n_side - 1)
        steps = int(round((steps0 * DT0 if steps0 else T_FINAL) / dt))
        t0 = time.perf_counter()
        mesh = generate_annulus_mesh(n_side=n_side, n_circle=n_circle, pad_hole=True)
        problem = stokes.StokesProblem.build(
            mesh, _steady_config(n_side, steps, dt, storage), device=dev)
        state, metrics = stokes.run(problem, steps=steps)
        phys = bench_large.physics_report(problem, state, metrics, steps)  # waits for the device
        elapsed = time.perf_counter() - t0
        vals, found = _probe(problem.mesh, state["u"], pts, problem.get_locator())
        if not found.all():
            raise AssertionError(f"{(~found).sum()} probe points not located")
        h = float(np.sqrt(2.0 * np.median(problem.mesh.area)))
        sampled.append(vals)
        rows.append({"label": label, "n_nodes": int(mesh.n_nodes), "h": round(h, 5), "dt": dt,
                     "steps": steps, "wall_s": round(elapsed, 1), **phys})
    _errors_vs_finest(rows, sampled)
    if check:
        # each coarser rung must be strictly worse than the next finer one
        # (the finest's self-error is 0 by construction)
        _check_decreasing(rows[:-1], "err_vs_finest", "velocity error")
        divs = [r["div_rel"] for r in rows]
        if not max(divs) < bench_large.DIV_REL_GATES["stokes"]:
            raise AssertionError(f"div_rel {divs} over the Stokes gate")
    return rows


# non-pad_hole geometries small enough for the dense Taylor–Hood factor
TH_SIZES = [
    ("0.5k", 24, 32), ("0.8k", 32, 40), ("1.2k", 40, 48), ("1.7k", 48, 56),
]
# Finer rungs (the reference switches to th_sparse.steady_solve past the
# dense ceiling), outside the monotone gate: the lifted P1/P1 error against
# same-mesh Taylor–Hood bottoms out near h ≈ 1/48 and grows under further
# refinement in tpufem's measurements (the un-stabilized pair's accuracy
# floor).
TH_SIZES_EXT = [("3.6k", 60, 68), ("6.4k", 80, 88)]
DENSE_TH_DOF_CEIL = 15_000  # 2N₂+N₁ above this → sparse steady Uzawa
T_STEADY = 12.0  # enclosed-box spin-up: steady by T ≈ 6–12


def run_th(sizes=None, steps0: int | None = None, check: bool = True,
           extended: bool = False, device=None):
    """P1/P1 projection steady state against same-mesh Taylor–Hood.

    ``extended=True`` appends the TH_SIZES_EXT rungs, where the lifted P1/P1
    error turns non-monotone; the monotone gate then applies to the base
    rungs only."""
    from tpufem_torch.mesh.generate import generate_annulus_mesh
    from tpufem_torch.mesh.p2 import p2_refine
    from tpufem_torch.workloads import navier_stokes as ns
    from tpufem_torch.workloads import stokes, th_sparse

    dev = tconfig.device(device)
    pts = probe_points(800)
    rows = []
    base = sizes or TH_SIZES
    table = list(base) + (TH_SIZES_EXT if extended and sizes is None else [])
    for label, n_side, n_circle in table:
        dt = DT0 * (40 - 1) / (n_side - 1)
        steps = int(round((steps0 * DT0 if steps0 else T_STEADY) / dt))
        mesh = generate_annulus_mesh(n_side=n_side, n_circle=n_circle)
        # enclosed box (all outer nodes no-slip): the BC set the TH solver
        # imposes; the periodic channel would compare different flows
        problem = stokes.StokesProblem.build(
            mesh, _steady_config(n_side, steps, dt, storage="csr", all_walls=True), device=dev)
        state, _ = stokes.run(problem, steps=steps)
        locator = problem.get_locator()
        u1, found1 = _probe(mesh, state["u"], pts, locator)

        m2 = p2_refine(mesh, snap_center=(0.5, 0.5), snap_radius=0.25)
        if 2 * m2.coords.shape[0] + mesh.n_nodes > DENSE_TH_DOF_CEIL:
            sp = th_sparse.SparseTHProblem.build(
                m2, th_sparse.SparseTHConfig(nu=NU, B1=-2.0, B2=0.0), device=dev)
            uth, _ = th_sparse.steady_solve(sp)
        else:
            uth, _, res = ns.solve_taylor_hood(m2, ns.TaylorHoodConfig(nu=NU, B1=-2.0, B2=0.0),
                                               device=dev)
            if not float(res) < 1e-8:
                raise AssertionError(f"Taylor–Hood residual {float(res)}")
        # the P2 velocity sampled through the P1 interpolant of its corner
        # values (both fields share the corner nodes), in float64
        vals2, found2 = _probe(mesh, uth[: mesh.n_nodes], pts, locator)
        ok = found1 & found2
        err = float(np.sqrt(((u1[ok] - vals2[ok]) ** 2).mean()) / np.sqrt((vals2[ok] ** 2).mean()))
        h = float(np.sqrt(2.0 * np.median(mesh.area)))
        rows.append({"label": label, "n_nodes": int(mesh.n_nodes), "h": round(h, 5), "dt": dt,
                     "steps": steps, "err_vs_taylor_hood": round(err, 6)})
    if check:
        _check_decreasing(rows[: len(base)], "err_vs_taylor_hood", "P1 error vs Taylor–Hood")
    return rows


# Navier–Stokes ladder (channel + inner body, body-force driven: the
# matrix-free NS path).  dt ∝ h from the reference's own dt at the coarsest
# rung; horizon fixed.
NS_SIZES = [
    ("2k", 40, 48),
    ("6.5k", 80, 96),
    ("26k", 160, 192),
    ("79k", 280, 320),
    ("160k", 400, 448),
]
NS_DT0 = 4e-4  # at n_side = 40
NS_T = 0.05  # physical horizon (125 coarse steps): the impulsively forced
# flow is still developing, so convergence is tested on the transient
NS_CHUNK = 5  # tpufem's steps a dispatch on its grid path: its step counts round to it


def run_ns_conv(sizes=None, steps0: int | None = None, check: bool = True, device=None):
    """NS velocity self-convergence and normalized-divergence ladder under
    dt ∝ h refinement: err_vs_finest must fall monotonically."""
    from tpufem_torch.mesh.generate import generate_annulus_mesh
    from tpufem_torch.ops import assembly, calculus
    from tpufem_torch.workloads import navier_stokes as ns

    dev = tconfig.device(device)
    sizes = sizes or NS_SIZES
    pts = probe_points()
    sampled, rows = [], []
    for label, n_side, n_circle in sizes:
        dt = NS_DT0 * (40 - 1) / (n_side - 1)
        steps = int(round((steps0 * NS_DT0 if steps0 else NS_T) / dt))
        t0 = time.perf_counter()
        mesh = generate_annulus_mesh(n_side=n_side, n_circle=n_circle, pad_hole=True)
        cfg = ns.NSConfig(dt=dt, nu=NU, solver="cg", precision="f32",
                          cg_iters_visc=30, cg_iters_pressure=120, cg_tol=1e-5)
        prob = ns.NSProblem.build(mesh, cfg, device=dev)
        if prob.grid_refill is not None:
            steps -= steps % NS_CHUNK
        u, _ = ns.run(prob, steps=steps)
        u_host = u.detach().double().cpu().numpy()  # waits for the device
        elapsed = time.perf_counter() - t0
        if not np.isfinite(u_host).all():
            raise FloatingPointError(f"NS {label} diverged")

        div = calculus.divergence(mesh, u).detach().double().cpu().numpy()
        ml = assembly.lumped_mass(mesh).numpy()
        h = float(np.sqrt(2.0 * np.median(mesh.area)))
        div_l2 = float(np.sqrt((ml * div**2).sum()))
        u_l2 = float(np.sqrt((ml * (u_host**2).sum(axis=1)).sum()))
        vals, found = _probe(mesh, u, pts, _locator(mesh, u.dtype, dev))
        if not found.all():
            raise AssertionError(f"{(~found).sum()} probe points not located")
        sampled.append(vals)
        rows.append({"label": label, "n_nodes": int(mesh.n_nodes), "h": round(h, 5), "dt": dt,
                     "steps": steps, "wall_s": round(elapsed, 1),
                     "max_u": float(np.abs(u_host).max()),
                     "div_rel": round(div_l2 * h / max(u_l2, 1e-30), 4)})
    _errors_vs_finest(rows, sampled)
    if check:
        _check_decreasing(rows[:-1], "err_vs_finest", "NS velocity error")
    return rows


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(prog="tpufem_torch converge")
    parser.add_argument("--study", default="self", choices=["self", "th", "ns"])
    parser.add_argument("--sizes", default=None, help="comma-separated labels to include")
    parser.add_argument("--steps0", type=int, default=None,
                        help="step count at the coarsest size (default: the study's horizon)")
    parser.add_argument("--storage", default="auto")
    parser.add_argument("--extended", action="store_true",
                        help="th: append the beyond-convergent-range rungs (sparse steady "
                             "Taylor–Hood reference)")
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    args = parser.parse_args(argv)

    wanted = set(args.sizes.split(",")) if args.sizes else None

    def pick(table):
        return [s for s in table if wanted is None or s[0] in wanted]

    if args.study == "self":
        rows = run_self(pick(SELF_SIZES), steps0=args.steps0, storage=args.storage,
                        device=args.device)
        cols = ("label", "n_nodes", "h", "dt", "steps", "err_vs_finest", "div_rel",
                "final_div_max")
    elif args.study == "ns":
        rows = run_ns_conv(pick(NS_SIZES), steps0=args.steps0, device=args.device)
        cols = ("label", "n_nodes", "h", "dt", "steps", "err_vs_finest", "div_rel", "max_u")
    else:
        rows = run_th(pick(TH_SIZES) if wanted is not None else None,
                      steps0=args.steps0 or 150, extended=args.extended, device=args.device)
        cols = ("label", "n_nodes", "h", "dt", "steps", "err_vs_taylor_hood")

    for r in rows:
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    print("\n| " + " | ".join(cols) + " |")
    print("|" + "---|" * len(cols))
    for r in rows:
        print("| " + " | ".join(str(r.get(c)) for c in cols) + " |")
    return rows


if __name__ == "__main__":
    main()
