"""Operator-split Stokes solver with squirmer BCs and transport, dense regime.

The PyTorch counterpart of ``tpufem.workloads.stokes`` along its dense
branch (``solver="lu"`` or ``"inverse"``, ``variant="color"``).  Per step:

  1. implicit viscous solve  (I + Δt·ν·K) u* = uⁿ + Δt·F
  2. periodic copy + Dirichlet/squirmer overwrite on u*
  3. lumped divergence → pressure solve, u = u* − Δt·∇p, BCs again
  4. second projection applied to interior nodes only
  5. metrics: max|div u*|, max|div u| final, max|u|
  6. optional transport: semi-Lagrangian dye + mixing index, or tracer
     advection + capture statistics

All matrices are assembled, factored and (with ``fused=True``) composed
once on the host in float64; a fused step is then one affine matvec
``u ← M u + b`` (kernel K1 under ``matvec_impl="pallas"``).  :func:`run`
is a Python loop on the device that keeps every per-step metric in
preallocated device tensors: it never waits for the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from tpufem_torch import bc, transport
from tpufem_torch import config as tconfig
from tpufem_torch.mesh.core import Mesh
from tpufem_torch.ops import assembly, calculus
from tpufem_torch.ops.fused_matvec import fused_step_matvec, fused_step_matvec_ref
from tpufem_torch.solve.dense import DenseInverse, make_dense_solver
from tpufem_torch.solve.pressure import merged_pressure_apply_matrix


@dataclasses.dataclass
class StokesConfig:
    """Same fields and defaults as ``tpufem.workloads.stokes.StokesConfig``,
    so a configuration carries across unchanged.  The iterative-solver
    (``cg_*``, ``grid_steps_per_call``) fields belong to the scale regime,
    which is not ported yet: setting any of them away from its default is
    refused."""

    # physics & stepping
    dt: float = 0.05
    nu: float = 0.1
    steps: int = 6000
    body_force: tuple[float, float] = (0.0, 0.0)
    # squirmer (B2<0 pusher, >0 puller, 0 neutral)
    bc_kind: str = "squirmer"  # or "rotating"
    B1: float = -2.0
    B2: float = 0.0
    omega: float = 5.0  # rotating-cylinder rate
    ramp_steps: int = 0  # linear BC ramp
    center: tuple[float, float] = (0.5, 0.5)
    # domain / markers
    inner_marker: int = 2
    outer_value: tuple[float, float] = (0.0, 0.0)  # wall velocity
    all_walls: bool = False  # enclosed box: every marked node Dirichlet
    L: float = 1.0
    H: float = 1.0
    tol: float = 1e-6
    # numerics
    solver: str = "lu"  # "lu" (parity) | "inverse" (one matvec) | "cg" (not ported)
    cg_iters_visc: int = 60
    cg_iters_pressure: int = 300
    cg_iters_dye: int = 40
    cg_storage: str = "auto"
    cg_warm_start: bool = True
    cg_tol_pressure: float = 0.0
    cg_tol_visc: float = 0.0
    cg_precond: str = "jacobi"
    cg_cheby_degree: int = 4
    grid_steps_per_call: int = 0
    cg_stream_diags: str = "auto"
    cg_stream_loop: str = "auto"
    cg_hbm_io: str = "auto"
    cg_coarse_nodes: int = 2048
    cg_coarse_dtype: str = "same"
    cg_batch_cols: str = "on"
    cg_roll_cache: str = "on"
    cg_stream_chunk: int = 1
    cg_precond_bf16: str = "off"
    precision: str = "f64"  # "f64" (parity) | "f32" (fast); set-up is f64 regardless
    pressure_mode: str = "penalty"  # "penalty" (±1e10, f64 only) | "merge" (exact)
    dense_ops: bool = True  # div/grad as precomputed (N,N) matvecs
    matvec_impl: str = "xla"  # "xla": torch.addmv | "pallas": kernel K1 on CUDA
    fused: bool = False  # compose the whole velocity update into one (2N,2N) map
    double_projection: bool = True  # second, interior-only projection
    variant: str = "color"  # "report" is not ported
    pressure_smoothing: float = 0.0  # used by the "report" variant only
    dirichlet_lift: bool = False  # lift eliminated Dirichlet columns into the RHS
    # transport
    transport: str = "none"  # "none" | "dye" | "tracers"
    D: float = 1e-3  # dye diffusivity (Eulerian dye, not ported)
    dye_threshold: float = 0.5  # initial dye: c=1 where x < threshold
    tracer_density: int = 25
    capture_radius: float = 0.28
    tracer_method: str = "euler"
    locator: str = "grid"  # "grid" | "topk" (not ported)
    locator_k: int = 10
    locator_grid: int = 0  # 0 = auto (~2√T cells per side)


_SCALE_REGIME_FIELDS = (
    "cg_iters_visc", "cg_iters_pressure", "cg_iters_dye", "cg_storage",
    "cg_warm_start", "cg_tol_pressure", "cg_tol_visc", "cg_precond",
    "cg_cheby_degree", "grid_steps_per_call", "cg_stream_diags",
    "cg_stream_loop", "cg_hbm_io", "cg_coarse_nodes", "cg_coarse_dtype",
    "cg_batch_cols", "cg_roll_cache", "cg_stream_chunk", "cg_precond_bf16",
)
_TRANSPORTS = ("none", "dye", "tracers", "eulerian_dye", "dye_griddata")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to tpufem_torch yet (ROADMAP Queue 1 item {item})")


def check_config(config: StokesConfig) -> None:
    """Raise for anything this port does not implement, before any work."""
    if config.transport not in _TRANSPORTS:
        raise ValueError(f"unknown transport {config.transport!r}; expected one of {_TRANSPORTS}")
    if config.transport in ("eulerian_dye", "dye_griddata"):
        raise _not_ported(f"transport={config.transport!r}", "10")
    if config.solver == "cg":
        raise _not_ported("solver='cg' (the matrix-free scale regime)", "5-6")
    if config.solver not in ("lu", "inverse"):
        raise ValueError(f"unknown dense solver method: {config.solver}")
    if config.variant == "report":
        raise _not_ported("variant='report'", "10")
    if config.variant != "color":
        raise ValueError(f"unknown variant {config.variant!r}")
    if config.locator == "topk":
        raise _not_ported("locator='topk' (TopKLocator)", "3")
    if config.locator != "grid":
        raise ValueError(f"unknown locator {config.locator!r}")
    if not config.dense_ops:
        raise _not_ported("dense_ops=False (sparse div/grad)", "5")
    if config.matvec_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown matvec_impl {config.matvec_impl!r}")
    if config.pressure_mode not in ("penalty", "merge"):
        raise ValueError(f"unknown pressure_mode {config.pressure_mode!r}")
    default = StokesConfig()
    changed = [f for f in _SCALE_REGIME_FIELDS if getattr(config, f) != getattr(default, f)]
    if changed:
        raise _not_ported(f"scale-regime settings {changed}", "5-6")
    tconfig.dtype(config.precision)  # refuses bf16 and unknown names
    if config.precision != "f64" and config.pressure_mode != "merge":
        raise ValueError(
            "the ±1e10 penalty pressure operator is numerically unusable below "
            "f64; use pressure_mode='merge' (exact periodic)"
        )
    if config.fused and (config.pressure_mode != "merge" or config.ramp_steps != 0):
        raise ValueError("fused step requires pressure_mode='merge' and no BC ramp")


@dataclasses.dataclass(frozen=True)
class StokesProblem:
    """Everything a run needs: host geometry and index sets, and the
    device operators, index tensors and tables in the run's dtype."""

    mesh: Mesh
    boundary: bc.ChannelBoundary
    visc_solver: Any  # DenseLU | DenseInverse
    pressure_solver: Any  # DenseLU | DenseInverse
    inner_values: torch.Tensor  # (k,2) squirmer / rotation surface velocities
    m_lumped: torch.Tensor
    locator: transport.GridLocator | None
    tracer_init: np.ndarray | None
    config: StokesConfig
    bidx: dict[str, torch.Tensor]  # boundary index sets on the device
    outer_value: torch.Tensor  # (2,) wall velocity
    body_force: torch.Tensor  # (2,)
    div_x: torch.Tensor  # (N,N) dense div/grad operators
    div_y: torch.Tensor
    fused_M: torch.Tensor | None = None  # (2N,2N) whole-step matrix
    fused_b: torch.Tensor | None = None  # (2N,) whole-step offset
    fused_Dstar: torch.Tensor | None = None  # (N,2N) u → div(u*) map
    fused_dstar0: torch.Tensor | None = None  # (N,)
    visc_lift: torch.Tensor | None = None  # (N,2) −Δt·ν·K[:, D]·u_D lift

    @property
    def dtype(self) -> torch.dtype:
        return self.m_lumped.dtype

    @property
    def device(self) -> torch.device:
        return self.m_lumped.device

    def div(self, u: torch.Tensor) -> torch.Tensor:
        return self.div_x @ u[:, 0] + self.div_y @ u[:, 1]

    def grad(self, p: torch.Tensor) -> torch.Tensor:
        return torch.stack([self.div_x @ p, self.div_y @ p], dim=1)

    @classmethod
    def build(cls, mesh: Mesh, config: StokesConfig = StokesConfig(), device=None) -> "StokesProblem":
        """Assemble, factor and compose on the host in float64; move the
        finished operators to ``device`` (see :func:`tpufem_torch.config.device`)."""
        check_config(config)
        dtype = tconfig.dtype(config.precision)
        dev = tconfig.device(device)
        boundary = bc.ChannelBoundary.build(
            mesh, inner_marker=config.inner_marker, L=config.L, H=config.H,
            tol=config.tol, all_walls=config.all_walls,
        )
        m_lumped = assembly.lumped_mass(mesh).numpy()
        n = mesh.n_nodes
        K = assembly.assemble_dense(mesh, assembly.element_stiffness(mesh)).numpy()

        # viscous system: (I + Δt·ν·K), symmetric Dirichlet surgery
        A_visc = bc.dirichlet_rows_cols(np.eye(n) + config.dt * config.nu * K, boundary.dirichlet)

        if config.pressure_mode == "merge":
            A_eff = merged_pressure_apply_matrix(mesh, m_lumped, boundary.masters, boundary.slaves)
            pressure_solver = DenseInverse(inv=torch.as_tensor(A_eff, dtype=dtype, device=dev))
        else:  # reference form: (K / M_L) p = b with the periodic penalty
            A_p = K / (m_lumped[:, None] + 1e-12)
            if len(boundary.masters):
                A_p = bc.periodic_penalty(A_p, boundary.masters, boundary.slaves)
            pressure_solver = make_dense_solver(A_p, config.solver, dtype=dtype, device=dev)

        if config.precision == "f64":
            visc_solver = make_dense_solver(A_visc, config.solver, dtype=dtype, device=dev)
        else:
            visc_solver = DenseInverse.factor(A_visc, dtype=dtype, device=dev)

        dx, dy = calculus.divergence_matrices(mesh)
        inner_values = _inner_values(mesh, boundary, config)
        visc_lift = None
        if config.dirichlet_lift:
            visc_lift = _viscous_lift_dense(K, mesh, boundary, inner_values, config)

        fused = None
        if config.fused:
            # the pressure matrix as the device holds it (rounded to the run's
            # dtype), as tpufem composes it
            a_eff_dev = pressure_solver.inv.cpu().to(torch.float64).numpy()
            fused = _compose_fused_step(
                mesh, boundary, inner_values, A_visc, a_eff_dev, dx, dy, config, lift=visc_lift,
            )
        locator = None if config.transport == "none" else _make_locator(mesh, config, dtype, dev)
        tracer_init = None
        if config.transport == "tracers":
            tracer_init = transport.init_tracer_grid(
                config.tracer_density, L=config.L, H=config.H,
                exclude_center=config.center, exclude_radius=0.25,
            )
        return cls.from_host(
            mesh, config, dev, boundary=boundary, visc_solver=visc_solver,
            pressure_solver=pressure_solver, inner_values=inner_values,
            m_lumped=m_lumped, div_xy=(dx, dy), fused=fused, visc_lift=visc_lift,
            locator=locator, tracer_init=tracer_init,
        )

    @classmethod
    def from_host(cls, mesh, config, device, *, boundary, visc_solver, pressure_solver,
                  inner_values, m_lumped, div_xy, fused=None, visc_lift=None,
                  locator=None, tracer_init=None) -> "StokesProblem":
        """Assemble a problem from host arrays (moved to ``device``; arrays
        that are already tensors keep their dtype) and ready solvers."""
        dtype = tconfig.dtype(config.precision)

        def t(a, dt=dtype):
            if a is None:
                return None
            if isinstance(a, torch.Tensor):
                return a.to(device)
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        fused = fused if fused is not None else (None,) * 4
        return cls(
            mesh=mesh,
            boundary=boundary,
            visc_solver=visc_solver,
            pressure_solver=pressure_solver,
            inner_values=t(inner_values),
            m_lumped=t(m_lumped),
            locator=locator,
            tracer_init=tracer_init,
            config=config,
            bidx=boundary.index_tensors(device),
            outer_value=t(config.outer_value),
            body_force=t(config.body_force),
            div_x=t(div_xy[0]),
            div_y=t(div_xy[1]),
            fused_M=t(fused[0]),
            fused_b=t(fused[1]),
            fused_Dstar=t(fused[2]),
            fused_dstar0=t(fused[3]),
            visc_lift=t(visc_lift),
        )


def _bc_field(mesh, boundary, inner_values, config) -> np.ndarray:
    """(N,2) zeros with the Dirichlet values written in."""
    ubc = np.zeros((mesh.n_nodes, 2))
    ubc[np.asarray(boundary.walls, dtype=np.int64)] = config.outer_value
    ubc[np.asarray(boundary.inner, dtype=np.int64)] = np.asarray(inner_values)
    return ubc


def _viscous_lift_dense(K_np, mesh, boundary, inner_values, config):
    """−Δt·ν·K[:, D]·u_D restricted to interior rows (consistent lifting
    of the columns dirichlet_rows_cols eliminates)."""
    ubc = _bc_field(mesh, boundary, inner_values, config)
    lift = -config.dt * config.nu * (np.asarray(K_np, dtype=np.float64) @ ubc)
    lift[np.asarray(boundary.dirichlet, dtype=np.int64)] = 0.0
    return lift


def _inner_values(mesh, boundary, config) -> np.ndarray:
    if config.bc_kind == "squirmer":
        return bc.squirmer_values(mesh.coords, boundary.inner, config.center, config.B1, config.B2)
    if config.bc_kind == "rotating":
        return bc.rotating_cylinder_values(mesh.coords, boundary.inner, config.center, config.omega)
    raise ValueError(f"unknown bc_kind: {config.bc_kind}")


def _make_locator(mesh, config, dtype, device) -> transport.GridLocator:
    """The grid locator; with ``locator_grid=0`` it probes a few grid
    resolutions around 2√T and keeps the narrowest candidate table (ties →
    the coarser grid), as tpufem does."""
    if config.locator_grid:
        return transport.GridLocator.build(mesh, g=config.locator_grid, dtype=dtype, device=device)
    base = np.sqrt(mesh.n_tris)
    best = None
    for scale in (2.0, 2.3, 2.7, 3.1):
        g = int(np.clip(scale * base, 8, 192))
        cells, origin, extent = transport._bin_triangles(mesh, g)
        if best is None or cells.shape[1] < best[0].shape[1]:
            best = (cells, origin, extent, g)
    return transport.GridLocator.from_tables(mesh, *best, dtype=dtype, device=device)


def _compose_fused_step(mesh, boundary, inner_values, A_visc, A_eff, dx, dy, config, lift=None):
    """Compose the whole affine velocity update into (M, b, Dstar, dstar0),
    host NumPy float64.

    Stacked layout u_flat = [uₓ; u_y] (2N).  Every stage is affine in u:

      u*  = E₂ V₂ (u + Δt f) + q          viscous solve + BC overwrite
      u₁  = E₂ (I + G A_eff D) u* + q     1st projection + BC overwrite
      u₂  = (I + S₂ G A_eff D) u₁         2nd projection (interior only)

    with V the viscous inverse, E the BC row surgery (periodic copy, wall
    zero, inner overwrite; offset q carries the boundary values), D/G the
    lumped div/grad operators, A_eff the merged-pressure solve matrix and
    S₂ the interior selector.  M = T₂ E₂ T₁ E₂V₂ is exact linear algebra.
    """
    n = mesh.n_nodes
    dt = config.dt
    V = np.linalg.inv(A_visc.astype(np.float64))

    # BC row surgery E and offset q (periodic copy, then walls, then inner)
    E = np.eye(n)
    for m_, s_ in zip(boundary.masters, boundary.slaves):
        E[s_, :] = E[m_, :]
    E[boundary.walls, :] = 0.0
    E[boundary.inner, :] = 0.0
    qx = np.zeros(n)
    qy = np.zeros(n)
    qx[boundary.walls] = config.outer_value[0]
    qy[boundary.walls] = config.outer_value[1]
    qx[boundary.inner] = inner_values[:, 0]
    qy[boundary.inner] = inner_values[:, 1]

    def blockdiag(A):
        z = np.zeros_like(A)
        return np.block([[A, z], [z, A]])

    V2 = blockdiag(V)
    E2 = blockdiag(E)
    q = np.concatenate([qx, qy])
    D = np.concatenate([dx, dy], axis=1)  # (N, 2N)
    G = np.concatenate([dx, dy], axis=0)  # (2N, N): the same coefficients
    GAD = G @ (A_eff @ D)  # (2N, 2N)

    f = np.concatenate([np.full(n, config.body_force[0]), np.full(n, config.body_force[1])])
    rhs0 = dt * f
    if lift is not None:
        rhs0 = rhs0 + np.concatenate([lift[:, 0], lift[:, 1]])
    M1 = E2 @ V2
    c1 = M1 @ rhs0 + q  # u* = M1 u + c1
    T1 = np.eye(2 * n) + GAD
    M2 = E2 @ T1  # u1 = E2 T1 u* + q
    if config.double_projection:
        s_mask = np.zeros(n)
        s_mask[boundary.interior] = 1.0
        S2 = np.concatenate([s_mask, s_mask])[:, None]
        T2 = np.eye(2 * n) + S2 * GAD
    else:
        T2 = np.eye(2 * n)
    M = T2 @ (M2 @ M1)
    b = T2 @ (M2 @ c1 + q)
    Dstar = D @ M1  # div(u*) = Dstar u + dstar0
    dstar0 = D @ c1
    return M, b, Dstar, dstar0


def apply_field_bcs(problem: StokesProblem, u: torch.Tensor, scale=1.0) -> torch.Tensor:
    """Periodic copy, then walls = outer value, then inner surface velocity."""
    b = problem.bidx
    if len(problem.boundary.masters):
        u = bc.apply_periodic_field(u, b["masters"], b["slaves"])
    u = u.index_put((b["walls"],), problem.outer_value)
    return u.index_put((b["inner"],), problem.inner_values * scale)


def initial_state(problem: StokesProblem) -> dict:
    cfg = problem.config
    n = problem.mesh.n_nodes
    dtype, dev = problem.dtype, problem.device
    u = apply_field_bcs(problem, torch.zeros((n, 2), dtype=dtype, device=dev))
    state = {"u": u, "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.transport == "dye":
        # half-domain dye
        left = problem.mesh.coords[:, 0] < cfg.dye_threshold
        state["c"] = torch.as_tensor(left, device=dev).to(dtype)
    elif cfg.transport == "tracers":
        state["tracers"] = torch.as_tensor(problem.tracer_init, dtype=dtype, device=dev)
        state["tracer_status"] = torch.zeros(
            problem.tracer_init.shape[0], dtype=torch.int32, device=dev
        )
    return state


def _interior_mask(problem: StokesProblem) -> torch.Tensor:
    return torch.as_tensor(problem.mesh.markers == 0, device=problem.device)


def dye_baseline(problem: StokesProblem, state: dict) -> torch.Tensor:
    """Initial mixing variance var₀ (0-d tensor)."""
    _, _, var0 = transport.mixing_index(state["c"], problem.m_lumped, mask=_interior_mask(problem))
    return var0


def projection_step(problem: StokesProblem, u: torch.Tensor, bc_scale=1.0):
    """The double-projection Stokes update → (u, p, metrics); ``p`` is None
    on the fused path, whose pressure never materializes."""
    cfg = problem.config
    dt = cfg.dt

    if problem.fused_M is not None:
        n = problem.mesh.n_nodes
        u_flat = torch.cat([u[:, 0], u[:, 1]])
        div_star = problem.fused_Dstar @ u_flat + problem.fused_dstar0
        matvec = fused_step_matvec if cfg.matvec_impl == "pallas" else fused_step_matvec_ref
        new_flat = matvec(problem.fused_M, u_flat, problem.fused_b)
        u_new = torch.stack([new_flat[:n], new_flat[n:]], dim=1)
        final_div = problem.div(u_new)
        metrics = {
            "div_star_max": torch.max(torch.abs(div_star)),
            "final_div_max": torch.max(torch.abs(final_div)),
            "max_u": torch.max(torch.abs(u_new)),
        }
        return u_new, None, metrics

    # 1. tentative velocity: one batched solve for both components
    rhs = u + dt * problem.body_force
    if problem.visc_lift is not None:
        rhs = rhs + bc_scale * problem.visc_lift
    u_star = apply_field_bcs(problem, problem.visc_solver.solve(rhs), bc_scale)

    # 2. pressure correction
    div_star = problem.div(u_star)
    p = problem.pressure_solver.solve(-div_star / dt)

    # 3. velocity update
    u_new = apply_field_bcs(problem, u_star - dt * problem.grad(p), bc_scale)

    # 4. second projection, interior only
    if cfg.double_projection:
        p2 = problem.pressure_solver.solve(-problem.div(u_new) / dt)
        g2 = problem.grad(p2)
        interior = problem.bidx["interior"]
        u_new = u_new.index_add(0, interior, -dt * g2[interior])

    final_div = problem.div(u_new)
    metrics = {
        "div_star_max": torch.max(torch.abs(div_star)),
        "final_div_max": torch.max(torch.abs(final_div)),
        "max_u": torch.max(torch.abs(u_new)),
    }
    return u_new, p, metrics


def make_step(problem: StokesProblem, var0=None):
    """The step function: state → (state, metrics), all on the device."""
    cfg = problem.config
    mesh = problem.mesh
    interior_mask = _interior_mask(problem)

    def step(state):
        if cfg.ramp_steps > 0:
            ramp = torch.clamp(state["step"].to(problem.dtype) / cfg.ramp_steps, max=1.0)
        else:
            ramp = 1.0
        u, _, metrics = projection_step(problem, state["u"], bc_scale=ramp)
        new_state = {"u": u, "step": state["step"] + 1}
        if cfg.transport == "dye":
            c = transport.advect_semilagrange(
                mesh, problem.locator, state["c"], u, cfg.dt, L=cfg.L, H=cfg.H
            )
            _, _, var = transport.mixing_index(c, problem.m_lumped, mask=interior_mask)
            new_state["c"] = c
            metrics["mixing_var"] = var
            if var0 is not None:
                metrics["mixing_progress"] = 1.0 - var / (var0 + 1e-16)
        elif cfg.transport == "tracers":
            pts = transport.tracer_step(
                mesh, problem.locator, state["tracers"], u, cfg.dt,
                L=cfg.L, method=cfg.tracer_method,
            )
            status = transport.capture_update(
                pts, state["tracer_status"], cfg.center, cfg.capture_radius
            )
            new_state["tracers"] = pts
            new_state["tracer_status"] = status
            metrics["eaten"] = torch.sum(status)
        return new_state, metrics

    return step


def _metric_dtypes(problem: StokesProblem) -> dict[str, torch.dtype]:
    keys = {k: problem.dtype for k in ("div_star_max", "final_div_max", "max_u")}
    if problem.config.transport == "dye":
        keys["mixing_var"] = problem.dtype
    elif problem.config.transport == "tracers":
        keys["eaten"] = torch.int64
    return keys


def run(problem: StokesProblem, steps: int | None = None, state: dict | None = None):
    """Run ``steps`` steps (default ``config.steps``) → (state, metrics).

    A Python loop that only enqueues device work: each step's metrics go
    into preallocated (steps,) device tensors, and nothing here reads a
    value back to the host.  Dye runs also report ``mixing_progress``
    against the canonical initial state's variance."""
    cfg = problem.config
    if state is None:
        state = initial_state(problem)
    n_steps = steps if steps is not None else cfg.steps
    metrics = {
        k: torch.empty(n_steps, dtype=dt, device=problem.device)
        for k, dt in _metric_dtypes(problem).items()
    }
    step = make_step(problem)
    for i in range(n_steps):
        state, m = step(state)
        for k, series in metrics.items():
            series[i] = m[k]
    if cfg.transport == "dye":
        var0 = dye_baseline(problem, initial_state(problem))
        metrics["mixing_progress"] = 1.0 - metrics["mixing_var"] / (var0 + 1e-16)
    return state, metrics
