"""Navier–Stokes workloads: the monolithic saddle-point Stokes solve and the
operator-split Navier–Stokes with implicit advection.

The PyTorch counterpart of ``tpufem.workloads.navier_stokes``:

* :func:`solve_monolithic`: the 3N×3N coupled [uₓ; u_y; p] steady Stokes
  solve, assembled and solved on the host in float64 (min-norm ``lstsq`` by
  default: the P1/P1 system is rank-deficient by construction).
* :class:`NSProblem` / :func:`run`: the projection scheme.  Each step solves
  (I + Δt·C(u) + νΔt·K) u* = uⁿ + Δt·f with the advection C(u) rebuilt from
  the current velocity, then a pressure Poisson (pinned at node 0, or
  deflated on the grid path), u = u* − Δt·∇p, and u = 0 on the walls.

Three solver paths:

* ``solver="dense"``: the parity path, a dense C(u) and ``torch.linalg.solve``
  every step, the pressure factored once (N up to a few thousand);
* ``solver="cg"`` on CSR storage: C(u)·x applied matrix-free, a
  Jacobi-BiCGStab per velocity column, the node-0-pinned pressure PCG; the
  only path for ``mass_consistent=True``;
* ``solver="cg"`` on grid storage (ring-in-grid pad_hole meshes, N = ns²):
  C(u) refilled into offset planes (``GridRefill``), then one launch of K4
  for both velocity columns and one of K3 for the pressure.

``cg_storage``: ``"auto"`` takes the grid on CUDA at f32 when N = ns² and
``GridRefill`` decomposes, else CSR; ``"grid"`` runs K4/K3 at f32 and f64;
``"grid_interpret"`` runs their plain versions on any device; ``"csr"`` asks
for CSR.  The Taylor–Hood functions of the JAX module are not ported
(ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from tpufem_torch import config as tconfig
from tpufem_torch.mesh.core import Mesh
from tpufem_torch.ops import assembly, calculus
from tpufem_torch.solve.cg import bicgstab_fixed
from tpufem_torch.solve.dense import DenseInverse, make_dense_solver

# ---------------------------------------------------------------------------
# Monolithic saddle-point Stokes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MonolithicConfig:
    nu: float = 1.0
    U0: float = 1.0  # squirmer swimming speed
    outer_marker: int = 1
    inner_marker: int = 2
    solver: str = "lstsq"  # min-norm least squares, or a dense solver name ("lu", "inverse")


def assemble_monolithic(mesh: Mesh, config: MonolithicConfig = MonolithicConfig()):
    """(A, b) of the 3N×3N coupled system with BCs applied (host NumPy f64):
    viscous blocks, the symmetric B/Bᵀ pressure coupling (−y_diffs/6,
    −x_diffs/6), no-slip outer walls, the tangential inner velocity
    U0·(−y/r, x/r) normalized by the distance from the origin (the
    reference's quirk, kept), the pressure pinned at node 0."""
    n = mesh.n_nodes
    A = np.zeros((3 * n, 3 * n))
    tris = mesh.tris
    det = mesh.det
    valid = det != 0.0  # the reference skips exact zeros only
    pc = mesh.coords[tris]
    x, y = pc[..., 0], pc[..., 1]
    yd = np.stack([y[:, 1] - y[:, 2], y[:, 2] - y[:, 0], y[:, 0] - y[:, 1]], axis=1)
    xd = np.stack([x[:, 2] - x[:, 1], x[:, 0] - x[:, 2], x[:, 1] - x[:, 0]], axis=1)

    safe = np.where(valid, det, 1.0)
    ke = config.nu * (yd[:, :, None] * yd[:, None, :] + xd[:, :, None] * xd[:, None, :]) / (
        2.0 * safe[:, None, None])
    ke = np.where(valid[:, None, None], ke, 0.0)
    rows = np.repeat(tris, 3, axis=1).reshape(-1)
    cols = np.tile(tris, (1, 3)).reshape(-1)
    np.add.at(A, (rows, cols), ke.reshape(-1))
    np.add.at(A, (rows + n, cols + n), ke.reshape(-1))

    # pressure coupling: B[p_i, u_j] += −diff_j/6 for every i
    bx = np.broadcast_to((-yd / 6.0)[:, None, :], ke.shape).reshape(-1)
    by = np.broadcast_to((-xd / 6.0)[:, None, :], ke.shape).reshape(-1)
    p_rows = rows + 2 * n
    np.add.at(A, (p_rows, cols), bx)
    np.add.at(A, (p_rows, cols + n), by)
    np.add.at(A, (cols, p_rows), bx)
    np.add.at(A, (cols + n, p_rows), by)

    b = np.zeros(3 * n)
    for idx in np.nonzero(mesh.markers == config.outer_marker)[0]:
        for dof in (idx, idx + n):
            A[dof, :] = 0.0
            A[dof, dof] = 1.0
            b[dof] = 0.0
    for idx in np.nonzero(mesh.markers == config.inner_marker)[0]:
        px, py = mesh.coords[idx]
        r = np.hypot(px, py) or 1.0
        for dof, val in ((idx, -config.U0 * py / r), (idx + n, config.U0 * px / r)):
            A[dof, :] = 0.0
            A[dof, dof] = 1.0
            b[dof] = val
    A[2 * n, :] = 0.0
    A[2 * n, 2 * n] = 1.0
    b[2 * n] = 0.0
    return A, b


def solve_monolithic(mesh: Mesh, config: MonolithicConfig = MonolithicConfig(),
                     dtype=torch.float64, device=None):
    """One-shot coupled solve → (u (N, 2), p (N,), residual ‖A·sol − b‖) on
    ``device``.  ``lstsq`` solves on the host in float64."""
    A, b = assemble_monolithic(mesh, config)
    dev = tconfig.device(device)
    A_t = torch.as_tensor(A, dtype=dtype, device=dev)
    b_t = torch.as_tensor(b, dtype=dtype, device=dev)
    if config.solver == "lstsq":
        sol = torch.as_tensor(np.linalg.lstsq(A, b, rcond=None)[0], dtype=dtype, device=dev)
    else:
        sol = make_dense_solver(A, config.solver, dtype=dtype, device=dev).solve(b_t)
    n = mesh.n_nodes
    u = torch.stack([sol[:n], sol[n:2 * n]], dim=1)
    return u, sol[2 * n:], torch.linalg.norm(A_t @ sol - b_t)


# ---------------------------------------------------------------------------
# Taylor–Hood (not ported: needs mesh/p2.py)
# ---------------------------------------------------------------------------


def _taylor_hood_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} (P2/P1 Taylor–Hood) is not ported to tpufem_torch yet; it needs "
        "mesh/p2.py (ROADMAP Queue 1 item 9)")


def assemble_taylor_hood(mesh, config=None):
    raise _taylor_hood_not_ported("assemble_taylor_hood")


def solve_taylor_hood(mesh, config=None):
    raise _taylor_hood_not_ported("solve_taylor_hood")


class TransientTHProblem:
    @classmethod
    def build(cls, mesh, config=None):
        raise _taylor_hood_not_ported("TransientTHProblem")


def th_step(problem, u_flat):
    raise _taylor_hood_not_ported("th_step")


def run_transient_th(problem, steps=None):
    raise _taylor_hood_not_ported("run_transient_th")


# ---------------------------------------------------------------------------
# Operator-split Navier–Stokes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NSConfig:
    """Same fields and defaults as ``tpufem.workloads.navier_stokes.NSConfig``.
    ``cg_batch_cols``, ``cg_stream_diags`` and ``cg_hbm_io`` are TPU layouts:
    accepted, and the port runs the columns in lockstep at every size."""

    dt: float = 1e-4
    steps: int = 1000
    nu: float = 1.0
    rho: float = 1.0
    body_force: tuple[float, float] = (0.1, 0.0)  # a 2-vector, or an (N, 2) nodal field
    mass_consistent: bool = False  # M_L⁻¹-scaled velocity system (CSR path)
    double_projection: bool = False  # a second pressure projection per step
    inner_marker: int = 2
    L: float = 1.0
    H: float = 1.0
    tol: float = 1e-6
    precision: str = "f64"
    pressure_scaling: str = "mass_lumped"  # "mass_lumped" | "raw" (the unstable original)
    solver: str = "dense"  # "dense" (parity) | "cg" (matrix-free)
    cg_iters_visc: int = 80  # BiCGStab cap
    cg_iters_pressure: int = 160
    cg_tol: float = 1e-8  # relative residual early exit (0: fixed counts)
    cg_precond: str = "twolevel"  # pressure PCG: "jacobi" | "twolevel"
    cg_coarse_nodes: int = 2048
    cg_storage: str = "auto"  # "auto" | "grid" | "grid_interpret" | "csr" | "stencil"
    cg_batch_cols: str = "on"
    cg_stream_diags: str = "auto"
    cg_hbm_io: str = "auto"


_NS_STORAGES = ("auto", "grid", "grid_interpret", "csr", "stencil")


def check_config(config: NSConfig) -> None:
    """Raise for settings this port does not implement, before any work."""
    if config.solver not in ("dense", "cg"):
        raise ValueError(f"unknown NS solver {config.solver!r}; expected 'dense' or 'cg'")
    if config.pressure_scaling not in ("mass_lumped", "raw"):
        raise ValueError(f"unknown pressure_scaling {config.pressure_scaling!r}")
    tconfig.dtype(config.precision)
    if config.solver != "cg":
        return
    if config.cg_storage not in _NS_STORAGES:
        raise ValueError(f"unknown cg_storage {config.cg_storage!r}; expected one of {_NS_STORAGES}")
    if config.cg_storage == "stencil":
        raise NotImplementedError(
            "cg_storage='stencil' is not ported to tpufem_torch yet (ROADMAP Queue 1 item 5); "
            "use 'csr' or 'grid'")
    if config.cg_precond not in ("jacobi", "twolevel"):
        raise ValueError(f"unknown cg_precond {config.cg_precond!r} for NS")


@dataclasses.dataclass(frozen=True)
class NSProblem:
    """Everything a run needs, on the run's device in its dtype."""

    mesh: Mesh
    wall_mask: np.ndarray  # outer walls, inner body (and, under cg, inert nodes): u = 0
    config: NSConfig
    wall: torch.Tensor  # wall_mask on the device
    body_force: torch.Tensor  # (2,) or (N, 2)
    pressure_solver: Any  # DenseLU | DenseInverse | PressureCG | PressureGridCG
    # dense path
    k_signed: torch.Tensor | None = None  # signed-det stiffness (N, N)
    # CSR path
    K_csr: Any = None  # signed-det stiffness, CSROperator
    inv_diag_visc: torch.Tensor | None = None  # Jacobi for the velocity solves
    inv_ml: torch.Tensor | None = None  # 1/M_L (mass_consistent=True)
    # grid path
    grid_refill: Any = None  # gridop.GridRefill: C(u) into the offset planes
    Kg_diags: torch.Tensor | None = None  # νΔt·K on the same planes
    Kg_rest: torch.Tensor | None = None
    vel_solver_grid: Any = None  # grid_cg.NSGridBiCGStab
    ones_mask: torch.Tensor | None = None  # the velocity system is unmasked

    @property
    def dtype(self) -> torch.dtype:
        return tconfig.dtype(self.config.precision)

    @property
    def device(self) -> torch.device:
        return self.wall.device

    @classmethod
    def build(cls, mesh: Mesh, config: NSConfig = NSConfig(), device=None) -> "NSProblem":
        """Assemble on the host in float64, move to ``device`` (see
        :func:`tpufem_torch.config.device`)."""
        check_config(config)
        dtype = tconfig.dtype(config.precision)
        dev = tconfig.device(device)
        x, y = mesh.coords[:, 0], mesh.coords[:, 1]
        on_outer = ((np.abs(x) < config.tol) | (np.abs(x - config.L) < config.tol)
                    | (np.abs(y) < config.tol) | (np.abs(y - config.H) < config.tol))
        wall_mask = on_outer | (mesh.markers == config.inner_marker)
        force = torch.as_tensor(np.asarray(config.body_force), dtype=dtype, device=dev)
        if config.solver == "cg":
            return cls._build_matfree(mesh, config, wall_mask, force, dtype, dev)
        k = assembly.assemble_dense(mesh, assembly.element_stiffness(mesh, signed=True)).numpy()
        a_p = k.copy()
        if config.pressure_scaling == "mass_lumped":
            a_p = a_p / (assembly.lumped_mass(mesh).numpy()[:, None] + 1e-12)
        a_p[0, :] = 0.0  # row-only pin
        a_p[0, 0] = 1.0
        if config.precision == "f64":
            pressure = make_dense_solver(a_p, "lu", dtype=dtype, device=dev)
        else:
            pressure = DenseInverse.factor(a_p, dtype=dtype, device=dev)
        return cls(mesh=mesh, wall_mask=wall_mask, config=config,
                   wall=torch.as_tensor(wall_mask, device=dev), body_force=force,
                   pressure_solver=pressure, k_signed=torch.as_tensor(k, dtype=dtype, device=dev))

    @classmethod
    def _build_matfree(cls, mesh, config, wall_mask, force, dtype, dev) -> "NSProblem":
        """``solver="cg"``: O(nnz) operators and iterative solves.  As in
        tpufem, the pressure uses the unsigned-det stiffness (equal to the
        signed one on counter-clockwise meshes), and inert nodes (pad_hole
        dummies, no valid triangle) are held at u = 0."""
        from tpufem_torch.ops.gridop import GridDecompositionError, GridRefill

        n = mesh.n_nodes
        K_signed = assembly.assemble_csr(mesh, assembly.element_stiffness(mesh, signed=True))
        K_p = assembly.assemble_csr(mesh, assembly.element_stiffness(mesh, signed=False))
        if config.pressure_scaling == "mass_lumped":
            m_l = assembly.lumped_mass(mesh).numpy()
        else:
            m_l = np.ones(n)
        deg = np.zeros(n)
        np.add.at(deg, mesh.tris.reshape(-1), np.repeat(mesh.valid.astype(np.float64), 3))
        wall_mask = wall_mask | (deg == 0)
        k_diag = torch.abs(K_signed.diag())
        inv_ml = None
        if config.mass_consistent:
            ml_full = assembly.lumped_mass(mesh)
            inv_ml = torch.where(ml_full > 0, 1.0 / torch.where(ml_full > 0, ml_full, 1.0), 1.0)
            inv_diag = 1.0 / (1.0 + config.nu * config.dt * inv_ml * k_diag)
            inv_ml = inv_ml.to(dtype=dtype, device=dev)
        else:
            inv_diag = 1.0 / (1.0 + config.nu * config.dt * k_diag)
        common = dict(mesh=mesh, wall_mask=wall_mask, config=config,
                      wall=torch.as_tensor(wall_mask, device=dev), body_force=force,
                      inv_diag_visc=inv_diag.to(dtype=dtype, device=dev), inv_ml=inv_ml)

        ns = int(round(np.sqrt(n)))
        storage = config.cg_storage
        explicit = storage in ("grid", "grid_interpret")
        # mass_consistent runs the CSR step (the refilled planes are not
        # M_L⁻¹-scaled), as in tpufem
        want_grid = not config.mass_consistent and (
            explicit or (storage == "auto" and dev.type == "cuda" and dtype == torch.float32
                         and ns * ns == n))
        if want_grid:
            try:
                refill = GridRefill.build(mesh, ns, dtype=dtype, device=dev)
            except GridDecompositionError:
                if explicit:
                    raise  # asked for by name: say why it cannot be had
                refill = None
            if refill is not None:
                return cls(**common, **_grid_fields(mesh, config, refill, K_p, m_l, deg, dtype, dev))

        K_p_op = K_p.astype(dtype, dev)
        lmax, tl = 0.0, None
        if config.cg_precond == "twolevel":
            from tpufem_torch.solve.cg import estimate_lmax
            from tpufem_torch.solve.twolevel import build_twolevel

            d = K_p.diag()
            inv_d = torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)),
                                torch.ones_like(d)).to(dev)
            lmax = estimate_lmax(K_p_op.matvec, inv_d, n)
            tl = build_twolevel(K_p, np.asarray(mesh.coords), K_p_op.matvec, inv_d,
                                target_coarse=config.cg_coarse_nodes, dtype=dtype, lmax=lmax)
        from tpufem_torch.solve.matfree import PressureCG

        empty = np.zeros(0, dtype=np.int64)
        pressure = PressureCG(
            K_merged=K_p_op, m_lumped=torch.as_tensor(m_l, dtype=dtype, device=dev), masters=empty,
            slaves=empty, active_mask=torch.ones(n, dtype=dtype, device=dev),
            iters=config.cg_iters_pressure, precond=config.cg_precond, lmax=lmax, twolevel=tl,
            tol=config.cg_tol, pin=0,
        )
        return cls(**common, pressure_solver=pressure, K_csr=K_signed.astype(dtype, dev))


def _grid_fields(mesh, config, refill, K_p, m_l, deg, dtype, dev) -> dict:
    """The grid path's operators and solvers: νΔt·K on the refill's planes,
    K4 for the velocity, K3 for the pressure (constant deflation on the
    deg > 0 nodes instead of the CSR path's node-0 pin: u is the same, p
    differs by a constant)."""
    from tpufem_torch.ops.gridop import GridOperator
    from tpufem_torch.solve.grid_cg import NSGridBiCGStab, PressureGridCG

    plain = config.cg_storage == "grid_interpret"
    Kg = refill.refill(assembly.element_stiffness(mesh, signed=True).to(dtype=dtype, device=dev))
    nudt = float(config.nu * config.dt)
    kp = K_p.astype(dtype)  # the coarse operator from the run-precision values, as tpufem
    empty = np.zeros(0, dtype=np.int64)
    pressure = PressureGridCG.build(
        kp, GridOperator.dense_split(kp, refill.template.ns, dtype=dtype, device=dev), m_l,
        empty, empty, (deg > 0).astype(np.float64), iters=config.cg_iters_pressure, tol=config.cg_tol,
        target_coarse=config.cg_coarse_nodes, use_coarse=config.cg_precond == "twolevel",
        plain=plain,
    )
    velocity = NSGridBiCGStab(ns=refill.template.ns, offsets=refill.template.offsets,
                              n_rest=refill.template.n_rest, iters=config.cg_iters_visc,
                              tol=config.cg_tol, interpret=plain)
    return dict(pressure_solver=pressure, grid_refill=refill, Kg_diags=nudt * Kg.diags,
                Kg_rest=nudt * Kg.rest_vals, vel_solver_grid=velocity,
                ones_mask=torch.ones(mesh.n_nodes, dtype=dtype, device=dev))


def _project(problem: NSProblem, u_star: torch.Tensor, p0: torch.Tensor):
    """The pressure projection(s) and the wall condition after the velocity
    solve: → (u, p, metrics)."""
    cfg, mesh = problem.config, problem.mesh
    dt = cfg.dt
    div = calculus.divergence(mesh, u_star)
    p = problem.pressure_solver.solve(-(cfg.rho / dt) * div, x0=p0)
    u_new = u_star - dt * calculus.gradient(mesh, p)
    if cfg.double_projection:
        div2 = calculus.divergence(mesh, u_new)
        p2 = problem.pressure_solver.solve(-(cfg.rho / dt) * div2, x0=p)
        u_new = u_new - dt * calculus.gradient(mesh, p2)
    u_new = torch.where(problem.wall[:, None], torch.zeros((), dtype=u_new.dtype,
                                                           device=u_new.device), u_new)
    return u_new, p, _metrics(u_new, p, div)


def _metrics(u, p, div) -> dict:
    return {"max_u": torch.max(torch.abs(u)), "max_p": torch.max(torch.abs(p)),
            "div_star_max": torch.max(torch.abs(div))}


def _ns_step_grid(problem: NSProblem, u: torch.Tensor, p0: torch.Tensor):
    """One step on the grid path: C(u) refilled into the planes, one K4
    launch for both velocity columns (warm start uⁿ), the K3 pressure."""
    cfg = problem.config
    dt = cfg.dt
    Cg = problem.grid_refill.refill_flat(assembly.element_convection_flat(problem.mesh, u, "opsplit"))
    Ag = dataclasses.replace(Cg, diags=dt * Cg.diags + problem.Kg_diags,
                             rest_vals=dt * Cg.rest_vals + problem.Kg_rest)
    u_star = problem.vel_solver_grid.solve(Ag, problem.ones_mask, problem.inv_diag_visc,
                                           u + dt * problem.body_force, u)
    return _project(problem, u_star, p0)


def _ns_step_matfree(problem: NSProblem, u: torch.Tensor, p0: torch.Tensor):
    """One step on the CSR path: a Jacobi-BiCGStab of fixed length per
    velocity column (warm start uⁿ) with C(u)·x applied matrix-free, the
    pinned pressure PCG warm-started from the previous pressure."""
    cfg = problem.config
    dt = cfg.dt

    def conv(x):
        return calculus.convection_apply(problem.mesh, u, x, variant="opsplit")

    K = problem.K_csr
    if cfg.mass_consistent:
        iml = problem.inv_ml

        def a_mv(x):
            return x + dt * iml * conv(x) + cfg.nu * dt * (iml * K.matvec(x))
    else:
        def a_mv(x):
            return x + dt * conv(x) + cfg.nu * dt * K.matvec(x)

    invd = problem.inv_diag_visc
    f = problem.body_force
    cols = []
    for c in range(2):
        fc = f[:, c] if f.ndim == 2 else f[c]
        xc, _ = bicgstab_fixed(a_mv, u[:, c] + dt * fc, x0=u[:, c], iters=cfg.cg_iters_visc,
                               precond=lambda r: invd * r)
        cols.append(xc)
    return _project(problem, torch.stack(cols, dim=1), p0)


def ns_step(problem: NSProblem, u: torch.Tensor):
    """One step on the dense path → (u, metrics): a dense C(u) and
    ``torch.linalg.solve`` for both velocity columns, the pressure row-pinned
    at node 0 and solved with the factors from set-up."""
    cfg, mesh = problem.config, problem.mesh
    dt = cfg.dt
    n = mesh.n_nodes
    c_adv = assembly.assemble_dense(mesh, assembly.element_convection(mesh, u, "opsplit"))
    a_new = torch.eye(n, dtype=u.dtype, device=u.device) + dt * c_adv + cfg.nu * dt * problem.k_signed
    u_star = torch.linalg.solve(a_new, u + dt * problem.body_force)
    div = calculus.divergence(mesh, u_star)
    b_p = -(cfg.rho / dt) * div
    b_p[0] = 0.0
    p = problem.pressure_solver.solve(b_p)
    u_new = u_star - dt * calculus.gradient(mesh, p)
    u_new = torch.where(problem.wall[:, None], torch.zeros((), dtype=u.dtype, device=u.device), u_new)
    return u_new, _metrics(u_new, p, div)


def run(problem: NSProblem, steps: int | None = None, state=None, return_state: bool = False):
    """Run ``steps`` steps (default ``config.steps``) from rest, or from
    ``state=(u, p)`` → (u, metrics), plus the ``(u, p)`` carry with
    ``return_state=True``.

    A Python loop that only enqueues device work: each step's metrics go
    into preallocated (steps,) device tensors.  The dense path carries p
    unchanged (its pressure solve takes no warm start)."""
    n_steps = steps if steps is not None else problem.config.steps
    n, dtype, dev = problem.mesh.n_nodes, problem.dtype, problem.device
    if state is None:
        u = torch.zeros((n, 2), dtype=dtype, device=dev)
        p = torch.zeros(n, dtype=dtype, device=dev)
    else:
        u, p = state
    metrics = {k: torch.empty(n_steps, dtype=dtype, device=dev)
               for k in ("max_u", "max_p", "div_star_max")}
    for i in range(n_steps):
        if problem.config.solver != "cg":
            u, m = ns_step(problem, u)
        elif problem.grid_refill is not None:
            u, p, m = _ns_step_grid(problem, u, p)
        else:
            u, p, m = _ns_step_matfree(problem, u, p)
        for k, series in metrics.items():
            series[i] = m[k]
    if return_state:
        return u, metrics, (u, p)
    return u, metrics
