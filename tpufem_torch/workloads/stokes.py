"""Operator-split Stokes solver with squirmer BCs and transport.

The PyTorch counterpart of ``tpufem.workloads.stokes`` (``variant="color"``)
in its two regimes: the dense one (``solver="lu"`` or ``"inverse"``) and the
matrix-free scale regime (``solver="cg"``).  Per step:

  1. implicit viscous solve  (I + Δt·ν·K) u* = uⁿ + Δt·F
  2. periodic copy + Dirichlet/squirmer overwrite on u*
  3. lumped divergence → pressure solve, u = u* − Δt·∇p, BCs again
  4. second projection applied to interior nodes only
  5. metrics: max|div u*|, max|div u| final, max|u|
  6. optional transport: semi-Lagrangian dye + mixing index, or tracer
     advection + capture statistics

Dense regime: all matrices are assembled, factored and (with
``fused=True``) composed once on the host in float64; a fused step is then
one affine matvec ``u ← M u + b`` (kernel K1 under ``matvec_impl="pallas"``).

Scale regime: sparse operators only.  With ``cg_storage="grid"`` (ring-in-
grid pad_hole meshes, N = n_side²) each step is one whole viscous solve
(kernel K2) and two whole pressure solves (kernel K3), warm-started from the
previous step; with ``"csr"`` the same solves run as plain tensor CG.
div/grad are CSR operators either way.

:func:`run` is a Python loop on the device that keeps every per-step metric
in preallocated device tensors: on the dense and grid paths it never waits
for the device (the plain CSR CG with ``tol > 0`` reads its loop condition
on the host).
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
from tpufem_torch.solve.grid_cg import PressureGridCG, ViscousGridCG
from tpufem_torch.solve.matfree import PressureCG, ViscousCG
from tpufem_torch.solve.pressure import merged_pressure_apply_matrix


@dataclasses.dataclass
class StokesConfig:
    """Same fields and defaults as ``tpufem.workloads.stokes.StokesConfig``,
    so a configuration carries across unchanged.  The ``cg_*`` fields act
    under ``solver="cg"`` only; the TPU-only ones (``cg_stream_*``,
    ``cg_hbm_io``, ``cg_roll_cache``, ``cg_batch_cols``) are accepted and
    change nothing here."""

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
    solver: str = "lu"  # "lu" (parity) | "inverse" (one matvec) | "cg" (matrix-free)
    cg_iters_visc: int = 60
    cg_iters_pressure: int = 300
    cg_iters_dye: int = 40
    cg_storage: str = "auto"  # "grid" (K2/K3) | "csr" | "grid_interpret" (grid, plain
    # versions) | "auto" (grid on CUDA when f32 and grid-numbered, else csr)
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


_TRANSPORTS = ("none", "dye", "tracers", "eulerian_dye", "dye_griddata")
_STORAGES = ("auto", "grid", "grid_interpret", "csr", "stencil", "banded")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to tpufem_torch yet (ROADMAP Queue 1 item {item})")


def check_config(config: StokesConfig) -> None:
    """Raise for anything this port does not implement, before any work.

    As in tpufem, ``pressure_mode`` and the f32 penalty rule concern the
    dense solvers only (the cg path always uses the merged operator), and
    the ``cg_*`` fields concern ``solver="cg"`` only."""
    if config.transport not in _TRANSPORTS:
        raise ValueError(f"unknown transport {config.transport!r}; expected one of {_TRANSPORTS}")
    if config.transport in ("eulerian_dye", "dye_griddata"):
        raise _not_ported(f"transport={config.transport!r}", "10")
    if config.solver not in ("lu", "inverse", "cg"):
        raise ValueError(f"unknown solver method: {config.solver}")
    if config.variant == "report":
        raise _not_ported("variant='report'", "10")
    if config.variant != "color":
        raise ValueError(f"unknown variant {config.variant!r}")
    if config.locator == "topk":
        raise _not_ported("locator='topk' (TopKLocator)", "3")
    if config.locator != "grid":
        raise ValueError(f"unknown locator {config.locator!r}")
    if config.matvec_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown matvec_impl {config.matvec_impl!r}")
    if config.pressure_mode not in ("penalty", "merge"):
        raise ValueError(f"unknown pressure_mode {config.pressure_mode!r}")
    tconfig.dtype(config.precision)  # refuses bf16 and unknown names
    if config.solver == "cg":
        _check_cg(config)
        return
    if not config.dense_ops:
        raise _not_ported("dense_ops=False with a dense solver (sparse div/grad)", "5")
    if config.precision != "f64" and config.pressure_mode != "merge":
        raise ValueError(
            "the ±1e10 penalty pressure operator is numerically unusable below "
            "f64; use pressure_mode='merge' (exact periodic)"
        )
    if config.fused and (config.pressure_mode != "merge" or config.ramp_steps != 0):
        raise ValueError("fused step requires pressure_mode='merge' and no BC ramp")


def _check_cg(config: StokesConfig) -> None:
    if config.fused:
        raise ValueError("fused and cg are mutually exclusive")
    if config.cg_storage not in _STORAGES:
        raise ValueError(f"unknown cg_storage {config.cg_storage!r}; expected one of {_STORAGES}")
    if config.cg_storage in ("stencil", "banded"):
        raise _not_ported(f"cg_storage={config.cg_storage!r}", "5")
    if config.grid_steps_per_call >= 1:
        raise _not_ported("grid_steps_per_call >= 1 (the fused whole-step kernel K5)", "6")
    if config.cg_precond_bf16 == "on":
        raise _not_ported("cg_precond_bf16='on'", "6")
    if config.cg_precond not in ("jacobi", "chebyshev", "twolevel"):
        raise ValueError(f"unknown cg_precond {config.cg_precond!r}")
    if config.cg_coarse_dtype not in ("same", "bf16"):
        raise ValueError(f"unknown cg_coarse_dtype {config.cg_coarse_dtype!r}")


@dataclasses.dataclass(frozen=True)
class StokesProblem:
    """Everything a run needs: host geometry and index sets, and the
    device operators, index tensors and tables in the run's dtype."""

    mesh: Mesh
    boundary: bc.ChannelBoundary
    visc_solver: Any  # DenseLU | DenseInverse | ViscousGridCG | ViscousCG
    pressure_solver: Any  # DenseLU | DenseInverse | PressureGridCG | PressureCG
    inner_values: torch.Tensor  # (k,2) squirmer / rotation surface velocities
    m_lumped: torch.Tensor
    locator: transport.GridLocator | None
    tracer_init: np.ndarray | None
    config: StokesConfig
    bidx: dict[str, torch.Tensor]  # boundary index sets on the device
    outer_value: torch.Tensor  # (2,) wall velocity
    body_force: torch.Tensor  # (2,)
    div_x: torch.Tensor | None  # (N,N) dense div/grad operators (dense regime)
    div_y: torch.Tensor | None
    fused_M: torch.Tensor | None = None  # (2N,2N) whole-step matrix
    fused_b: torch.Tensor | None = None  # (2N,) whole-step offset
    fused_Dstar: torch.Tensor | None = None  # (N,2N) u → div(u*) map
    fused_dstar0: torch.Tensor | None = None  # (N,)
    visc_lift: torch.Tensor | None = None  # (N,2) −Δt·ν·K[:, D]·u_D lift
    mf_dx: Any = None  # CSR div/grad operators (scale regime)
    mf_dy: Any = None

    @property
    def dtype(self) -> torch.dtype:
        return self.m_lumped.dtype

    @property
    def device(self) -> torch.device:
        return self.m_lumped.device

    def div(self, u: torch.Tensor) -> torch.Tensor:
        if self.div_x is not None:
            return self.div_x @ u[:, 0] + self.div_y @ u[:, 1]
        return self.mf_dx.matvec(u[:, 0]) + self.mf_dy.matvec(u[:, 1])

    def grad(self, p: torch.Tensor) -> torch.Tensor:
        if self.div_x is not None:
            return torch.stack([self.div_x @ p, self.div_y @ p], dim=1)
        return torch.stack([self.mf_dx.matvec(p), self.mf_dy.matvec(p)], dim=1)

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
        if config.solver == "cg":
            return cls._build_matfree(mesh, config, boundary, m_lumped, dtype, dev)
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
    def _build_matfree(cls, mesh, config, boundary, m_lumped, dtype, dev) -> "StokesProblem":
        """The scale regime: sparse operators and CG solvers, no dense matrix."""
        visc, pressure, mf_dx, mf_dy = _build_matfree_problem_fields(
            mesh, config, boundary, m_lumped, dtype, dev)
        inner_values = _inner_values(mesh, boundary, config)
        visc_lift = None
        if config.dirichlet_lift:
            # the dense path's lift, through the materialized K operator
            ubc = _bc_field(mesh, boundary, inner_values, config)
            m = visc.interior_mask
            visc_lift = torch.stack([
                -config.dt * config.nu * m * visc.K.matvec(
                    torch.as_tensor(ubc[:, d], dtype=dtype, device=dev))
                for d in range(2)
            ], dim=1)
        locator = None if config.transport == "none" else _make_locator(mesh, config, dtype, dev)
        tracer_init = None
        if config.transport == "tracers":
            tracer_init = transport.init_tracer_grid(
                config.tracer_density, L=config.L, H=config.H,
                exclude_center=config.center, exclude_radius=0.25,
            )
        return cls.from_host(
            mesh, config, dev, boundary=boundary, visc_solver=visc, pressure_solver=pressure,
            inner_values=inner_values, m_lumped=m_lumped, div_xy=(None, None),
            visc_lift=visc_lift, locator=locator, tracer_init=tracer_init,
            mf_dxy=(mf_dx, mf_dy),
        )

    @classmethod
    def from_host(cls, mesh, config, device, *, boundary, visc_solver, pressure_solver,
                  inner_values, m_lumped, div_xy, fused=None, visc_lift=None,
                  locator=None, tracer_init=None, mf_dxy=(None, None)) -> "StokesProblem":
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
            mf_dx=mf_dxy[0],
            mf_dy=mf_dxy[1],
        )


def _build_matfree_problem_fields(mesh, config, boundary, m_lumped, dtype, dev):
    """(viscous solver, pressure solver, Dx, Dy) of the scale regime.

    Storage, as tpufem decides it (``tpufem/workloads/stokes.py:589-670``):
    ``"auto"`` takes the grid on CUDA when the run is f32, N = ns² and the
    operator covers ≥ 90 % of its entries with grid planes, else CSR (tpufem
    falls back to stencil or banded storage there, which are not ported).
    ``"grid"`` runs the kernels at f32 and f64; ``"grid_interpret"`` takes
    the grid storage with the kernels' plain versions on every device.  The
    plane split follows tpufem's ``stream`` decision, so both packages build
    the same operators at every size."""
    from tpufem_torch.mesh.gridify import ensure_grid_numbering
    from tpufem_torch.ops.gridop import GridDecompositionError, GridOperator
    from tpufem_torch.solve.pressure import owner_map

    storage = config.cg_storage
    if storage == "auto":
        storage = "auto_accel" if dev.type == "cuda" else "csr"
    n = mesh.n_nodes
    ke = assembly.element_stiffness(mesh)
    K_csr = assembly.assemble_csr(mesh, ke)
    interior_mask = np.ones(n)
    interior_mask[boundary.dirichlet] = 0.0
    owner = owner_map(n, boundary.masters, boundary.slaves)
    Km_csr = assembly.assemble_csr(dataclasses.replace(mesh, tris=owner[mesh.tris].astype(np.int32)),
                                   ke)
    # active: owns its dof and is carried by an element (pad_hole dummies are not)
    active_mask = ((owner == np.arange(n)) & (np.asarray(m_lumped) > 0)).astype(np.float64)
    coarse_dtype = torch.bfloat16 if config.cg_coarse_dtype == "bf16" else None
    dx_csr, dy_csr = calculus.divergence_csr_operators(mesh)
    mf = (dx_csr.astype(dtype, dev), dy_csr.astype(dtype, dev))

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    ns = int(round(np.sqrt(n)))
    explicit = storage in ("grid", "grid_interpret")
    if explicit:
        ensure_grid_numbering(mesh, L=config.L, H=config.H, tol=config.tol)
    if explicit or (storage == "auto_accel" and ns * ns == n and dtype == torch.float32):
        stream = config.cg_stream_diags == "on" or (config.cg_stream_diags == "auto" and n >= 360_000)
        hbm_io = config.cg_hbm_io == "on" or (config.cg_hbm_io == "auto" and n >= 700_000)
        stream = stream or hbm_io
        tpu_fields = dict(stream_diags=stream, stream_loop=config.cg_stream_loop in ("on", "auto"),
                          hbm_io=hbm_io, roll_cache=config.cg_roll_cache == "on",
                          stream_chunk=config.cg_stream_chunk)

        def build_gridop(csr):
            # tpufem's streamed regimes spend more planes to shrink the
            # remainder to ≤128 entries; mirror the split, not the streaming
            if stream:
                try:
                    return GridOperator.build(csr, ns, dtype=dtype, rest_target=128, device=dev)
                except GridDecompositionError:
                    pass
            return GridOperator.build(csr, ns, dtype=dtype, device=dev)

        try:
            Gv = build_gridop(K_csr)
            if Gv.coverage >= 0.9 or explicit:
                visc = ViscousGridCG(
                    K=Gv, interior_mask=t(interior_mask), dt_nu=config.dt * config.nu,
                    iters=config.cg_iters_visc, tol=config.cg_tol_visc,
                    plain=storage == "grid_interpret", **tpu_fields,
                )
                pressure = PressureGridCG.build(
                    Km_csr, build_gridop(Km_csr), np.asarray(m_lumped), boundary.masters,
                    boundary.slaves, active_mask, iters=config.cg_iters_pressure,
                    tol=config.cg_tol_pressure, target_coarse=config.cg_coarse_nodes,
                    use_coarse=config.cg_precond == "twolevel", coarse_dtype=coarse_dtype,
                    plain=storage == "grid_interpret", **tpu_fields,
                )
                return visc, pressure, *mf
        except GridDecompositionError:
            if explicit:
                raise  # asked for by name: say why it cannot be had

    visc = ViscousCG(K=K_csr.astype(dtype, dev), interior_mask=t(interior_mask),
                     dt_nu=config.dt * config.nu, iters=config.cg_iters_visc,
                     tol=config.cg_tol_visc)
    km = Km_csr.astype(dtype, dev)
    lmax, tl = 0.0, None
    if config.cg_precond in ("chebyshev", "twolevel"):
        from tpufem_torch.solve.cg import estimate_lmax

        diag = km.diag()
        inv_diag = torch.where(diag > 0, 1.0 / torch.where(diag > 0, diag, torch.ones_like(diag)),
                               torch.ones_like(diag))
        lmax = estimate_lmax(km.matvec, inv_diag, n)
        if config.cg_precond == "twolevel":
            from tpufem_torch.solve.twolevel import build_twolevel

            tl = build_twolevel(Km_csr, np.asarray(mesh.coords), km.matvec, inv_diag,
                                target_coarse=config.cg_coarse_nodes, dtype=dtype,
                                coarse_dtype=coarse_dtype, lmax=lmax)
    pressure = PressureCG(
        K_merged=km, m_lumped=t(m_lumped), masters=boundary.masters, slaves=boundary.slaves,
        active_mask=t(active_mask), iters=config.cg_iters_pressure, precond=config.cg_precond,
        cheby_degree=config.cg_cheby_degree, lmax=lmax, twolevel=tl, tol=config.cg_tol_pressure,
    )
    return visc, pressure, *mf


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
    if cfg.cg_warm_start and isinstance(problem.pressure_solver, (PressureCG, PressureGridCG)):
        # the CG pressure solves warm-start from the previous step's solutions
        state["p_warm"] = torch.zeros(n, dtype=dtype, device=dev)
        state["p2_warm"] = torch.zeros(n, dtype=dtype, device=dev)
        if cfg.cg_tol_visc > 0:
            # the viscous CG warm-starts from the previous step's u*
            state["ustar_warm"] = u
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


def projection_step(problem: StokesProblem, u: torch.Tensor, bc_scale=1.0, warm=None):
    """The double-projection Stokes update → (u, p, metrics, warm_out); ``p``
    is None on the fused path, whose pressure never materializes.

    ``warm`` holds the previous step's solutions (CG solvers only): ``"p"``
    and ``"p2"`` warm-start the two pressure solves, ``"u_star"`` the
    viscous one; ``warm_out`` is this step's, or None without ``warm``."""
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
        return u_new, None, metrics, None

    # 1. tentative velocity: one batched solve for both components
    rhs = u + dt * problem.body_force
    if problem.visc_lift is not None:
        rhs = rhs + bc_scale * problem.visc_lift
    if warm is not None and "u_star" in warm:
        u_star_raw = problem.visc_solver.solve(rhs, x0=warm["u_star"])
    else:
        u_star_raw = problem.visc_solver.solve(rhs)
    u_star = apply_field_bcs(problem, u_star_raw, bc_scale)

    # 2. pressure correction
    div_star = problem.div(u_star)
    if warm is not None:
        p = problem.pressure_solver.solve(-div_star / dt, x0=warm["p"])
    else:
        p = problem.pressure_solver.solve(-div_star / dt)

    # 3. velocity update
    u_new = apply_field_bcs(problem, u_star - dt * problem.grad(p), bc_scale)

    # 4. second projection, interior only
    p2 = None
    if cfg.double_projection:
        div_u = problem.div(u_new)
        if warm is not None:
            p2 = problem.pressure_solver.solve(-div_u / dt, x0=warm["p2"])
        else:
            p2 = problem.pressure_solver.solve(-div_u / dt)
        g2 = problem.grad(p2)
        imask = getattr(problem.visc_solver, "interior_mask", None)
        if imask is not None:
            # the CG solvers' interior mask is the 0/1 indicator of the
            # interior nodes: one fused multiply-add instead of a scatter
            u_new = u_new - dt * g2 * imask[:, None]
        else:
            interior = problem.bidx["interior"]
            u_new = u_new.index_add(0, interior, -dt * g2[interior])

    final_div = problem.div(u_new)
    metrics = {
        "div_star_max": torch.max(torch.abs(div_star)),
        "final_div_max": torch.max(torch.abs(final_div)),
        "max_u": torch.max(torch.abs(u_new)),
    }
    warm_out = None
    if warm is not None:
        warm_out = {"p": p, "p2": p2 if p2 is not None else p}
        if "u_star" in warm:
            warm_out["u_star"] = u_star_raw
    return u_new, p, metrics, warm_out


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
        warm = None
        if "p_warm" in state:
            warm = {"p": state["p_warm"], "p2": state["p2_warm"]}
            if "ustar_warm" in state:
                warm["u_star"] = state["ustar_warm"]
        u, _, metrics, warm_out = projection_step(problem, state["u"], bc_scale=ramp, warm=warm)
        new_state = {"u": u, "step": state["step"] + 1}
        if warm_out is not None:
            new_state["p_warm"] = warm_out["p"]
            new_state["p2_warm"] = warm_out["p2"]
            if "u_star" in warm_out:
                new_state["ustar_warm"] = warm_out["u_star"]
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
