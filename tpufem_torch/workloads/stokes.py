"""Operator-split Stokes solver with squirmer BCs and transport.

The PyTorch counterpart of ``tpufem.workloads.stokes`` in its two regimes:
the dense one (``solver="lu"`` or ``"inverse"``) and the matrix-free scale
regime (``solver="cg"``).  Per step (``variant="color"``):

  1. implicit viscous solve  (I + Δt·ν·K) u* = uⁿ + Δt·F
  2. periodic copy + Dirichlet/squirmer overwrite on u*
  3. lumped divergence → pressure solve, u = u* − Δt·∇p, BCs again
  4. second projection applied to interior nodes only
  5. metrics: max|div u*|, max|div u| final, max|u|
  6. optional transport: semi-Lagrangian dye, implicit Eulerian dye or
     departure-point ("griddata") dye, each with the mixing index; or
     tracer advection + capture statistics

``variant="report"`` writes the BC values into the viscous right-hand side,
pins and de-means the pressure, optionally smooths it with an (I + αK)
solve, and projects once (:func:`_report_projection_step`).

Dense regime: all matrices are assembled, factored and (with
``fused=True``) composed once on the host in float64; a fused step is then
one affine matvec ``u ← M u + b`` (kernel K1 under ``matvec_impl="pallas"``).

Scale regime: sparse operators only.  With ``cg_storage="grid"`` (ring-in-
grid pad_hole meshes, N = n_side², or any other mesh renumbered onto a
raster by ``mesh.gridify``) each step is one whole viscous solve (kernel K2)
and two whole pressure solves (kernel K3), warm-started from the previous
step, with div/grad on the stencil (``ops/stencil.py``) between them, as in
tpufem; ``grid_steps_per_call=K ≥ 1`` runs K whole steps in one launch of
kernel K5 instead (``solve/grid_step.py``).  With ``"csr"``, ``"stencil"``
or ``"banded"`` the same solves run as plain tensor CG on that storage.

:func:`run` is a Python loop on the device that keeps every per-step metric
in preallocated device tensors: on the dense and grid paths it never waits
for the device (the plain CSR CG with ``tol > 0`` reads its loop condition
on the host).  On the card, the unfused grid path with no transport
(:func:`graph_path`) replays one CUDA graph a step instead of launching the
step's ~100 kernels one by one from Python.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from tpufem_torch import bc, transport
from tpufem_torch import config as tconfig
from tpufem_torch.cuda_graph import capture_step
from tpufem_torch.mesh.core import Mesh
from tpufem_torch.metrics import span
from tpufem_torch.ops import assembly, calculus
from tpufem_torch.ops.banded import BandedOperator
from tpufem_torch.ops.fused_matvec import fused_step_matvec, fused_step_matvec_ref
from tpufem_torch.ops.stencil import StencilOperator, StencilPair, stencil_or_csr
from tpufem_torch.solve.dense import DenseInverse, make_dense_solver
from tpufem_torch.solve.grid_cg import PressureGridCG, ViscousGridCG
from tpufem_torch.solve.grid_step import GridStokesStep
from tpufem_torch.solve.matfree import PressureCG, ViscousCG
from tpufem_torch.solve.pressure import merge_map, merged_pressure_apply_matrix


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
    cg_storage: str = "auto"  # "grid" (K2/K3) | "csr" | "stencil" | "banded" |
    # "grid_interpret" (grid, plain versions) | "auto" (on CUDA the grid when f32
    # and grid-numbered, else the stencil at ≥ 90 % coverage, else CSR; CSR on
    # the CPU)
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
    variant: str = "color"  # | "report": pinned pressure, optional smoothing, one projection
    pressure_smoothing: float = 0.0  # α of the "report" variant's (I+αK) smoothing; 0 = off
    dirichlet_lift: bool = False  # lift eliminated Dirichlet columns into the RHS
    # transport
    transport: str = "none"  # "none" | "dye" | "tracers" | "eulerian_dye" | "dye_griddata"
    D: float = 1e-3  # dye diffusivity (Eulerian and griddata dye)
    dye_threshold: float = 0.5  # initial dye: c=1 where x < threshold
    tracer_density: int = 25
    capture_radius: float = 0.28
    tracer_method: str = "euler"
    locator: str = "grid"  # "grid" (O(P·C)) | "topk" (the reference's k nearest centroids, O(P·T))
    locator_k: int = 10
    locator_grid: int = 0  # 0 = auto (~2√T cells per side)


_TRANSPORTS = ("none", "dye", "tracers", "eulerian_dye", "dye_griddata")
_DYE_TRANSPORTS = ("dye", "eulerian_dye", "dye_griddata")  # half-domain dye, mixing index
_STORAGES = ("auto", "grid", "grid_interpret", "csr", "stencil", "banded")


def check_config(config: StokesConfig) -> None:
    """Raise for anything this port does not implement, before any work.

    As in tpufem, ``pressure_mode`` and the f32 penalty rule concern the
    dense solvers only (the cg path always uses the merged operator), and
    the ``cg_*`` fields concern ``solver="cg"`` only."""
    if config.transport not in _TRANSPORTS:
        raise ValueError(f"unknown transport {config.transport!r}; expected one of {_TRANSPORTS}")
    if config.solver not in ("lu", "inverse", "cg"):
        raise ValueError(f"unknown solver method: {config.solver}")
    if config.variant not in ("color", "report"):
        raise ValueError(f"unknown variant {config.variant!r}")
    if config.locator not in ("grid", "topk"):
        raise ValueError(f"unknown locator {config.locator!r}")
    if config.matvec_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown matvec_impl {config.matvec_impl!r}")
    if config.pressure_mode not in ("penalty", "merge"):
        raise ValueError(f"unknown pressure_mode {config.pressure_mode!r}")
    tconfig.dtype(config.precision)  # refuses unknown names
    if config.precision == "bf16":
        _check_bf16(config)
    if config.solver == "cg":
        _check_cg(config)
        return
    if config.precision != "f64" and config.pressure_mode != "merge":
        raise ValueError(
            "the ±1e10 penalty pressure operator is numerically unusable below "
            "f64; use pressure_mode='merge' (exact periodic)"
        )
    if config.variant == "report" and not (
            config.pressure_mode == "penalty" and config.precision == "f64" and not config.fused):
        raise ValueError("the 'report' variant implements the reference's pinned f64 path: "
                         "pressure_mode='penalty', precision='f64', fused=False")
    if config.fused and (config.pressure_mode != "merge" or config.ramp_steps != 0):
        raise ValueError("fused step requires pressure_mode='merge' and no BC ramp")
    if config.fused and not config.dense_ops:
        raise ValueError("fused step requires dense_ops=True (it composes the dense div/grad)")


def _check_bf16(config: StokesConfig) -> None:
    """bf16 runs where tpufem's bf16 run stays bounded: the fused dense step
    with the ``"xla"`` matvec (``torch.addmv``) and no transport."""
    if config.solver == "cg":
        raise ValueError(
            "precision='bf16' with solver='cg': tpufem's CSR CG blows up in bf16 (max|u| 2.56, "
            "27 and 508 after 1, 3 and 10 steps) and its grid storage raises a TypeError; "
            "bf16 runs the fused dense step only")
    if not config.fused:
        raise ValueError(
            "precision='bf16' unfused: tpufem's unfused bf16 step blows up (max|u| 130 after "
            "1 step, 8.5e19 after 10); bf16 runs the fused dense step only (fused=True)")
    if config.matvec_impl != "xla":
        raise ValueError(
            "precision='bf16' with matvec_impl='pallas': kernel K1 has no bf16 instance, nor "
            "has tpufem's Pallas matvec (with tracers it raises); use matvec_impl='xla'")
    if config.transport != "none":
        raise ValueError(
            f"precision='bf16' with transport={config.transport!r}: the locator tables carry "
            "triangle and node ids as floats, exact in bf16 only below 256; bf16 runs the "
            "flow alone (transport='none')")


def _check_cg(config: StokesConfig) -> None:
    if config.transport == "dye_griddata":
        raise ValueError("dye_griddata needs the dense regime (its explicit diffusion uses the "
                         "dense stiffness); use solver='lu'/'inverse'")
    if config.fused:
        raise ValueError("fused and cg are mutually exclusive")
    if config.cg_storage not in _STORAGES:
        raise ValueError(f"unknown cg_storage {config.cg_storage!r}; expected one of {_STORAGES}")
    if config.cg_precond_bf16 not in ("off", "on"):
        raise ValueError(f"unknown cg_precond_bf16 {config.cg_precond_bf16!r}")
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
    locator: transport.GridLocator | transport.TopKLocator | None
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
    mf_dx: Any = None  # div/grad operators (scale regime): CSR, stencil or banded
    mf_dy: Any = None
    grid_step: GridStokesStep | None = None  # K5, under grid_steps_per_call ≥ 1
    gridified: Any = None  # mesh.gridify.Gridified when the mesh was renumbered
    smooth_solver: Any = None  # (I+αK) pinned pressure smoothing ("report" variant)
    pressure_pin: int = -1  # pinned pressure node ("report" variant)
    eul_M: torch.Tensor | None = None  # (N,N) consistent mass (dense Eulerian dye)
    eul_K: torch.Tensor | None = None  # (N,N) stiffness (dense Eulerian and griddata dye)
    eul_Mg: torch.Tensor | None = None  # (N,N_act) periodic merge map (f32 Eulerian dye)
    _locator_cache: Any = dataclasses.field(default_factory=dict, repr=False, compare=False)
    # the captured steps of :func:`run`, by state layout; not an __init__
    # field, so a problem made by dataclasses.replace starts with none
    _graphs: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                      compare=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.m_lumped.dtype

    @property
    def device(self) -> torch.device:
        return self.m_lumped.device

    def get_locator(self):
        """The point locator, built on first use: a transport="none" problem
        builds none at set-up, and builds the one its configuration names
        (cached) when a consumer, e.g. the convergence prober, asks."""
        if self.locator is not None:
            return self.locator
        loc = self._locator_cache.get("loc")
        if loc is None:
            loc = _make_locator(self.mesh, self.config, self.dtype, self.device)
            self._locator_cache["loc"] = loc
        return loc

    @functools.cached_property
    def mf_pair(self) -> StencilPair | None:
        """Dx and Dy in one pass where both are stencils of one pattern."""
        return StencilPair.of(self.mf_dx, self.mf_dy)

    def div(self, u: torch.Tensor) -> torch.Tensor:
        with span("div"):
            if self.div_x is not None:
                return self.div_x @ u[:, 0] + self.div_y @ u[:, 1]
            if self.mf_pair is not None:
                return self.mf_pair.combine(u)
            if self.mf_dx is not None:
                return self.mf_dx.matvec(u[:, 0]) + self.mf_dy.matvec(u[:, 1])
            return calculus.divergence(self.mesh, u)  # dense solvers, dense_ops=False

    def grad(self, p: torch.Tensor) -> torch.Tensor:
        with span("grad"):
            if self.div_x is not None:
                return torch.stack([self.div_x @ p, self.div_y @ p], dim=1)
            if self.mf_pair is not None:
                return self.mf_pair.split(p)
            if self.mf_dx is not None:
                return torch.stack([self.mf_dx.matvec(p), self.mf_dy.matvec(p)], dim=1)
            return calculus.gradient(self.mesh, p)

    @classmethod
    def build(cls, mesh: Mesh, config: StokesConfig = StokesConfig(), device=None) -> "StokesProblem":
        """Assemble, factor and compose on the host in float64; move the
        finished operators to ``device`` (see :func:`tpufem_torch.config.device`).

        Explicit grid storage (``cg_storage="grid"`` or ``"grid_interpret"``)
        renumbers a mesh whose numbering does not fit it onto an ns×ns
        raster: the problem's mesh is then the renumbered, dummy-padded one
        (N = ns²), and ``problem.gridified.pull`` maps its fields back to the
        input's order.

        Its spans: ``StokesProblem.build``, and inside it ``gridify``,
        ``boundary``, ``assembly``, ``dense_split``, ``pressure_build``, ``locator``,
        ``from_host`` and ``grid_step`` where the path has them."""
        with span("StokesProblem.build"):
            return cls._build(mesh, config, device)

    @classmethod
    def _build(cls, mesh: Mesh, config: StokesConfig, device) -> "StokesProblem":
        from tpufem_torch.mesh.gridify import ensure_grid_numbering

        check_config(config)
        dtype = tconfig.dtype(config.precision)
        dev = tconfig.device(device)
        gridified = None
        if config.solver == "cg" and config.cg_storage in ("grid", "grid_interpret"):
            with span("gridify"):
                mesh, gridified = ensure_grid_numbering(mesh, L=config.L, H=config.H,
                                                        tol=config.tol)
        with span("boundary"):
            boundary = bc.ChannelBoundary.build(
                mesh, inner_marker=config.inner_marker, L=config.L, H=config.H,
                tol=config.tol, all_walls=config.all_walls,
            )
            m_lumped = assembly.lumped_mass(mesh).numpy()
        if config.solver == "cg":
            problem = cls._build_matfree(mesh, config, boundary, m_lumped, dtype, dev)
            return dataclasses.replace(problem, gridified=gridified)
        n = mesh.n_nodes
        K = assembly.assemble_dense(mesh, assembly.element_stiffness(mesh)).numpy()

        # viscous system: (I + Δt·ν·K), symmetric Dirichlet surgery
        A_visc = bc.dirichlet_rows_cols(np.eye(n) + config.dt * config.nu * K, boundary.dirichlet)

        # "report": the first interior node pins the pressure gauge
        pressure_pin = _pressure_pin(mesh, config)
        if config.pressure_mode == "merge":
            A_eff = merged_pressure_apply_matrix(mesh, m_lumped, boundary.masters, boundary.slaves)
            pressure_solver = DenseInverse(inv=torch.as_tensor(A_eff, dtype=dtype, device=dev))
        else:  # reference form: (K / M_L) p = b with the periodic penalty
            A_p = K / (m_lumped[:, None] + 1e-12)
            if len(boundary.masters):
                A_p = bc.periodic_penalty(A_p, boundary.masters, boundary.slaves)
            if pressure_pin >= 0:
                A_p = bc.dirichlet_rows_cols(A_p, [pressure_pin])
            pressure_solver = make_dense_solver(A_p, config.solver, dtype=dtype, device=dev)

        smooth_solver = None
        if config.pressure_smoothing > 0:
            S = np.eye(n) + config.pressure_smoothing * K
            if pressure_pin >= 0:
                S = bc.dirichlet_rows_cols(S, [pressure_pin])
            smooth_solver = make_dense_solver(S, config.solver, dtype=dtype, device=dev)

        eul = (None, None, None)  # (M, K, merge map) of the dense Eulerian/griddata dye
        if config.transport == "dye_griddata":
            eul = (None, K, None)
        elif config.transport == "eulerian_dye":
            M = assembly.assemble_dense(mesh, assembly.element_mass(mesh)).numpy()
            Mg = None
            if config.precision != "f64":
                Mg = merge_map(n, boundary.masters, boundary.slaves)
            eul = (M, K, Mg)

        if config.precision == "f64":
            visc_solver = make_dense_solver(A_visc, config.solver, dtype=dtype, device=dev)
        else:
            visc_solver = DenseInverse.factor(A_visc, dtype=dtype, device=dev)

        # dense_ops=False: div/grad by index_add_ each step (StokesProblem.div)
        dx, dy = calculus.divergence_matrices(mesh) if config.dense_ops else (None, None)
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
            locator=locator, tracer_init=tracer_init, smooth_solver=smooth_solver,
            pressure_pin=pressure_pin, eul=eul,
        )

    @classmethod
    def _build_matfree(cls, mesh, config, boundary, m_lumped, dtype, dev) -> "StokesProblem":
        """The scale regime: sparse operators and CG solvers, no dense matrix."""
        visc, pressure, mf_dx, mf_dy, smooth, pin = _build_matfree_problem_fields(
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
        with span("from_host"):
            problem = cls.from_host(
                mesh, config, dev, boundary=boundary, visc_solver=visc,
                pressure_solver=pressure, inner_values=inner_values, m_lumped=m_lumped,
                div_xy=(None, None), visc_lift=visc_lift, locator=locator,
                tracer_init=tracer_init, mf_dxy=(mf_dx, mf_dy), smooth_solver=smooth,
                pressure_pin=pin,
            )
        with span("grid_step"):
            return dataclasses.replace(problem, grid_step=GridStokesStep.build(problem))

    @classmethod
    def from_host(cls, mesh, config, device, *, boundary, visc_solver, pressure_solver,
                  inner_values, m_lumped, div_xy, fused=None, visc_lift=None,
                  locator=None, tracer_init=None, mf_dxy=(None, None), smooth_solver=None,
                  pressure_pin=-1, eul=(None, None, None)) -> "StokesProblem":
        """Assemble a problem from host arrays (moved to ``device``; arrays
        that are already tensors keep their dtype) and ready solvers;
        ``eul`` is (eul_M, eul_K, eul_Mg)."""
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
            smooth_solver=smooth_solver,
            pressure_pin=int(pressure_pin),
            eul_M=t(eul[0]),
            eul_K=t(eul[1]),
            eul_Mg=t(eul[2]),
        )


def _storage(config: StokesConfig, dev: torch.device) -> str:
    """The storage to try: ``"auto"`` becomes ``"auto_accel"`` (the grid
    where the operator fits it, else the stencil at ≥ 90 % coverage, else
    CSR) on CUDA and ``"csr"`` elsewhere."""
    if config.cg_storage == "auto":
        return "auto_accel" if dev.type == "cuda" else "csr"
    return config.cg_storage


def _pressure_pin(mesh, config: StokesConfig) -> int:
    """The "report" variant's pinned pressure node, the first interior
    node; -1 (no pin) for the "color" variant."""
    if config.variant != "report":
        return -1
    return int(np.nonzero(mesh.markers == 0)[0][0])


def _materializer(storage: str, dtype, dev):
    """tpufem's ``materialize`` (``tpufem/workloads/stokes.py:593-611``): the
    storage of a CSR operator off the grid kernels.  ``"stencil"`` and
    ``"banded"`` by name; the grid storages' operators outside the kernels
    (div/grad, and the "report" variant's solves) on the stencil at ≥ 90 %
    coverage, else CSR; ``"auto_accel"`` (``"auto"`` on CUDA) the stencil at
    ≥ 90 %, else CSR where tpufem takes banded: on the H100 the band's
    whole envelope made the 160,000-node Stokes step 3.1× slower than CSR
    (PERF.md §6); anything else CSR."""
    def materialize(csr):
        if storage == "banded":
            return BandedOperator.build(csr, dtype=dtype, device=dev)
        if storage == "stencil":
            return StencilOperator.build(csr, dtype=dtype, device=dev)
        if storage in ("grid", "grid_interpret", "auto_accel"):
            return stencil_or_csr(csr, dtype, dev)
        return csr.astype(dtype, dev)

    return materialize


def _build_matfree_problem_fields(mesh, config, boundary, m_lumped, dtype, dev):
    """(viscous solver, pressure solver, Dx, Dy, smoothing solver, pressure
    pin) of the scale regime.

    Storage, as tpufem decides it (``tpufem/workloads/stokes.py:589-670``):
    ``"auto"`` takes the grid on CUDA when the run is f32, N = ns² and the
    operator covers ≥ 90 % of its entries with grid planes, else the
    stencil at ≥ 90 % coverage, else CSR where tpufem takes banded
    (:func:`_materializer`); on the CPU it is CSR.  ``"stencil"``,
    ``"banded"`` and ``"csr"`` take their storage for every operator.
    ``"grid"`` runs the kernels at f32 and f64; ``"grid_interpret"`` takes the grid storage with the kernels' plain
    versions on every device (the mesh is grid-numbered by then:
    ``StokesProblem.build`` renumbers it).  The operators take the card
    kernels' split (:meth:`~tpufem_torch.ops.gridop.GridOperator.dense_split`)
    on every device, so the kernels and their plain versions apply one
    split; it is tpufem's wherever tpufem's TPU caps on the remainder do not
    bind.  The div/grad operators the step applies between the kernels take
    :func:`_materializer`'s rule: the stencil at ≥ 90 % coverage.

    The "report" variant pins the pressure, which the grid kernels do not
    implement: as in tpufem, it takes the matrix-free solvers under every
    storage (the mesh stays renumbered where ``"grid"`` asked for it), with
    a pinned :class:`PressureCG` and, for ``pressure_smoothing > 0``, the
    (I + αK) smoothing as a :class:`ViscousCG` masked at the pin (α for
    Δt·ν, the viscous iteration cap and the pressure tolerance)."""
    from tpufem_torch.ops.gridop import GridDecompositionError, GridOperator
    from tpufem_torch.solve.pressure import owner_map

    storage = _storage(config, dev)
    n = mesh.n_nodes
    with span("assembly"):
        ke = assembly.element_stiffness(mesh)
        K_csr = assembly.assemble_csr(mesh, ke)
        interior_mask = np.ones(n)
        interior_mask[boundary.dirichlet] = 0.0
        owner = owner_map(n, boundary.masters, boundary.slaves)
        Km_csr = assembly.assemble_csr(
            dataclasses.replace(mesh, tris=owner[mesh.tris].astype(np.int32)), ke)
        # active: owns its dof and is carried by an element (pad_hole dummies are not)
        active_mask = ((owner == np.arange(n)) & (np.asarray(m_lumped) > 0)).astype(np.float64)
        dx_csr, dy_csr = calculus.divergence_csr_operators(mesh)
    coarse_dtype = torch.bfloat16 if config.cg_coarse_dtype == "bf16" else None
    materialize = _materializer(storage, dtype, dev)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    ns = int(round(np.sqrt(n)))
    pin = _pressure_pin(mesh, config)
    explicit = storage in ("grid", "grid_interpret")
    if pin < 0 and (explicit or (storage == "auto_accel" and ns * ns == n
                                 and dtype == torch.float32)):
        stream = config.cg_stream_diags == "on" or (config.cg_stream_diags == "auto" and n >= 360_000)
        hbm_io = config.cg_hbm_io == "on" or (config.cg_hbm_io == "auto" and n >= 700_000)
        stream = stream or hbm_io
        tpu_fields = dict(stream_diags=stream, stream_loop=config.cg_stream_loop in ("on", "auto"),
                          hbm_io=hbm_io, roll_cache=config.cg_roll_cache == "on",
                          stream_chunk=config.cg_stream_chunk)

        def build_gridop(csr):
            with span("dense_split"):
                return GridOperator.dense_split(csr, ns, dtype=dtype, device=dev)

        try:
            Gv = build_gridop(K_csr)
            if Gv.coverage >= 0.9 or explicit:
                visc = ViscousGridCG(
                    K=Gv, interior_mask=t(interior_mask), dt_nu=config.dt * config.nu,
                    iters=config.cg_iters_visc, tol=config.cg_tol_visc,
                    plain=storage == "grid_interpret", **tpu_fields,
                )
                Gp = build_gridop(Km_csr)
                with span("pressure_build"):
                    pressure = PressureGridCG.build(
                        Km_csr, Gp, np.asarray(m_lumped), boundary.masters,
                        boundary.slaves, active_mask, iters=config.cg_iters_pressure,
                        tol=config.cg_tol_pressure, target_coarse=config.cg_coarse_nodes,
                        use_coarse=config.cg_precond == "twolevel", coarse_dtype=coarse_dtype,
                        plain=storage == "grid_interpret",
                        precond_bf16=config.cg_precond_bf16 == "on", **tpu_fields,
                    )
                return visc, pressure, materialize(dx_csr), materialize(dy_csr), None, -1
        except GridDecompositionError:
            if explicit:
                raise  # asked for by name: say why it cannot be had

    visc = ViscousCG(K=materialize(K_csr), interior_mask=t(interior_mask),
                     dt_nu=config.dt * config.nu, iters=config.cg_iters_visc,
                     tol=config.cg_tol_visc)
    km = materialize(Km_csr)
    lmax, tl = 0.0, None
    if config.cg_precond in ("chebyshev", "twolevel"):
        from tpufem_torch.solve.cg import estimate_lmax

        with span("pressure_build"):
            diag = km.diag()
            inv_diag = torch.where(diag > 0,
                                   1.0 / torch.where(diag > 0, diag, torch.ones_like(diag)),
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
        pin=pin,
    )
    smooth = None
    if pin >= 0 and config.pressure_smoothing > 0:
        pin_mask = np.ones(n)
        pin_mask[pin] = 0.0
        smooth = ViscousCG(K=visc.K, interior_mask=t(pin_mask), dt_nu=config.pressure_smoothing,
                           iters=config.cg_iters_visc, tol=config.cg_tol_pressure)
    return visc, pressure, materialize(dx_csr), materialize(dy_csr), smooth, pin


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


def _make_locator(mesh, config, dtype, device):
    """The k-nearest-centroid locator under ``locator="topk"``; else the grid
    locator, which with ``locator_grid=0`` probes a few grid resolutions
    around 2√T and keeps the narrowest candidate table (ties → the coarser
    grid), as tpufem does."""
    with span("locator"):
        return _build_locator(mesh, config, dtype, device)


def _build_locator(mesh, config, dtype, device):
    if config.locator == "topk":
        return transport.TopKLocator(mesh, config.locator_k, dtype=dtype, device=device)
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
    with span("bcs"):
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
    if cfg.transport in _DYE_TRANSPORTS:
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

    if cfg.variant == "report":
        return _report_projection_step(problem, u, bc_scale, warm)

    if problem.grid_step is not None:
        # K whole steps in one launch of K5; bc_scale is 1 (K5 refuses ramps)
        return problem.grid_step(u, warm)

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
    with span("viscous_solve"):
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
    with span("pressure_solve"):
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
        with span("pressure_solve"):
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
    with span("step_metrics"):
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


def _put_nodes(x: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """``x`` with the nodes ``idx`` of its node axis (dim −2 of a vector
    field (..., N, 2)) set to ``values``, out of place."""
    out = x.clone()
    out[..., idx, :] = values
    return out


def _report_projection_step(problem, u: torch.Tensor, bc_scale, warm=None):
    """The "report" step: BC values written into the viscous right-hand
    side, the periodic copy on u* only, the pinned pressure solve of the
    de-meaned right-hand side, the optional (I+αK) smoothing of the pinned
    pressure (then de-meaned), a single projection, and the BCs applied
    again in walls → periodic → inner order; ``final_div`` is measured
    before that.  ``warm`` (CG solvers) warm-starts the viscous
    (``"u_star"``), raw-pressure (``"p"``) and smoothed-pressure (``"p2"``)
    solves.

    ``u`` may carry a leading batch axis (B, N, 2): ``problem`` then holds
    (B, k, 2) inner values, its div/grad and solvers act on batches, and
    ``bc_scale`` broadcasts against the inner values; the means and the
    metrics are per batch entry (``parallel.spmd``'s report ensemble)."""
    cfg = problem.config
    b = problem.bidx
    periodic = len(problem.boundary.masters) > 0
    dt = cfg.dt
    pin = problem.pressure_pin
    vals = problem.inner_values * bc_scale

    rhs = u + dt * problem.body_force
    if problem.visc_lift is not None:
        rhs = rhs + bc_scale * problem.visc_lift
    rhs = _put_nodes(rhs, b["walls"], problem.outer_value)
    rhs = _put_nodes(rhs, b["inner"], vals)
    if warm is not None and "u_star" in warm:
        u_star_raw = problem.visc_solver.solve(rhs, x0=warm["u_star"])
    else:
        u_star_raw = problem.visc_solver.solve(rhs)
    u_star = u_star_raw
    if periodic:
        u_star = _put_nodes(u_star, b["slaves"], u_star[..., b["masters"], :])

    div_star = problem.div(u_star)
    b_p = -div_star / dt
    b_p = b_p - torch.mean(b_p, dim=-1, keepdim=True)
    b_p[..., pin].fill_(0.0)
    if warm is not None:
        p_raw = problem.pressure_solver.solve(b_p, x0=warm["p"])
    else:
        p_raw = problem.pressure_solver.solve(b_p)
    p = p_raw
    if problem.smooth_solver is not None:
        p = p_raw.clone()
        p[..., pin].fill_(0.0)
        if warm is not None:
            p = problem.smooth_solver.solve(p, x0=warm["p2"])
        else:
            p = problem.smooth_solver.solve(p)
        p = p - torch.mean(p, dim=-1, keepdim=True)

    u_new = u_star - dt * problem.grad(p)
    final_div = problem.div(u_new)  # measured before the BCs are applied again
    u_new = _put_nodes(u_new, b["walls"], problem.outer_value)
    if periodic:
        u_new = _put_nodes(u_new, b["slaves"], u_new[..., b["masters"], :])
    u_new = _put_nodes(u_new, b["inner"], vals)
    metrics = {
        "div_star_max": torch.amax(torch.abs(div_star), dim=-1),
        "final_div_max": torch.amax(torch.abs(final_div), dim=-1),
        "max_u": torch.amax(torch.abs(u_new), dim=(-2, -1)),
    }
    warm_out = None
    if warm is not None:
        warm_out = {"p": p_raw, "p2": p}
        if "u_star" in warm:
            warm_out["u_star"] = u_star_raw
    return u_new, p, metrics, warm_out


def eulerian_dye_step(problem: StokesProblem, c: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Implicit Eulerian advection–diffusion of the dye:

      A_c = M + Δt (C(u) + D K) + diag(Δt M_L (∇·u))   [slave entries copied]
      A_c c' = M c,  then clip to [0, 1] and copy master → slave.

    A_c depends on u, so it is assembled and solved on the device every step
    (dense LU, ``torch.linalg.solve``).  Periodicity: the ±1e10 penalty at
    f64, the exact DOF merge (``eul_Mg``) at f32.  The scale regime
    (``solver="cg"``) solves the same system matrix-free
    (:func:`_eulerian_dye_step_matfree`)."""
    if problem.eul_M is None:
        return _eulerian_dye_step_matfree(problem, c, u)
    cfg = problem.config
    b = problem.bidx
    periodic = len(problem.boundary.masters) > 0
    dt = cfg.dt
    C = assembly.assemble_dense(problem.mesh, assembly.element_convection(problem.mesh, u))
    g = dt * (problem.m_lumped * problem.div(u))
    if periodic:
        g = g.index_put((b["slaves"],), g[b["masters"]])
    A_c = problem.eul_M + dt * (C + cfg.D * problem.eul_K) + torch.diag(g)
    rhs = problem.eul_M @ c
    if problem.eul_Mg is None:
        if periodic:
            A_c = bc.periodic_penalty_device(A_c, b["masters"], b["slaves"])
        c_new = torch.linalg.solve(A_c, rhs)
    else:
        mg = problem.eul_Mg
        c_new = mg @ torch.linalg.solve(mg.T @ A_c @ mg, mg.T @ rhs)
    c_new = torch.clamp(c_new, 0.0, 1.0)
    if periodic:
        c_new = bc.apply_periodic_field(c_new, b["masters"], b["slaves"])
    return c_new


def _eulerian_dye_step_matfree(problem: StokesProblem, c: torch.Tensor,
                               u: torch.Tensor) -> torch.Tensor:
    """:func:`eulerian_dye_step` for the scale regime: the same system,
    solved by ``cg_iters_dye`` Jacobi-preconditioned BiCGStab iterations over
    matrix-free applies (consistent mass, convection and the viscous
    solver's stiffness operator, CSR or grid) in the merged-periodic space;
    no matrix is formed."""
    from tpufem_torch.solve.cg import bicgstab_fixed

    cfg = problem.config
    mesh = problem.mesh
    periodic = len(problem.boundary.masters) > 0
    m, s = problem.bidx["masters"], problem.bidx["slaves"]
    dt = cfg.dt
    active = problem.pressure_solver.active_mask.to(c.dtype)
    K = problem.visc_solver.K

    g = dt * (problem.m_lumped * problem.div(u))
    if periodic:
        g = g.index_put((s,), g[m])

    def spread(x):
        return x.index_put((s,), x[m]) if periodic else x

    def fold(z):
        if periodic:
            z = z.index_add(0, m, z[s]) * active
        return z

    def A(x):
        xf = spread(x)
        z = (calculus.mass_apply(mesh, xf)
             + dt * (calculus.convection_apply(mesh, u, xf) + cfg.D * K.matvec(xf))
             + g * xf)
        return fold(z)

    rhs = fold(calculus.mass_apply(mesh, c))
    md = problem.m_lumped
    if periodic:
        md = md.index_add(0, m, md[s])
    inv_diag = torch.where(active > 0, 1.0 / (md + g), torch.ones_like(md))
    x0 = c * active if periodic else c
    c_new, _ = bicgstab_fixed(A, rhs, x0=x0, iters=cfg.cg_iters_dye,
                              precond=lambda r: inv_diag * r)
    c_new = torch.clamp(spread(c_new), 0.0, 1.0)
    if periodic:
        c_new = bc.apply_periodic_field(c_new, m, s)
    return c_new


def griddata_dye_step(problem: StokesProblem, c: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Departure-point dye: linear interpolation of c at x − Δt·u on the
    mesh (0 outside it), then, for D > 0, explicit diffusion
    c + Δt·D·(K c) clipped to [0, 1] (with D = 0 the values stay
    unclipped)."""
    cfg = problem.config
    dep = problem.locator.coords - cfg.dt * u
    vals, _ = transport.interpolate(problem.mesh, c, dep, problem.locator)
    if cfg.D > 0:
        vals = torch.clamp(vals + cfg.dt * cfg.D * (problem.eul_K @ vals), 0.0, 1.0)
    return vals


def make_step(problem: StokesProblem, var0=None):
    """The step function: state → (state, metrics), all on the device."""
    cfg = problem.config
    mesh = problem.mesh
    interior_mask = _interior_mask(problem)

    def step(state):
        if cfg.ramp_steps > 0:
            # the "report" variant ramps by (step + 1)/ramp_steps, "color" by step/ramp_steps
            num = state["step"] + (1 if cfg.variant == "report" else 0)
            ramp = torch.clamp(num.to(problem.dtype) / cfg.ramp_steps, max=1.0)
        else:
            ramp = 1.0
        warm = None
        if "p_warm" in state:
            warm = {"p": state["p_warm"], "p2": state["p2_warm"]}
            if "ustar_warm" in state:
                warm["u_star"] = state["ustar_warm"]
        u, _, metrics, warm_out = projection_step(problem, state["u"], bc_scale=ramp, warm=warm)
        with span("step_metrics"):
            new_state = {"u": u, "step": state["step"] + steps_per_call(problem)}
            if warm_out is not None:
                new_state["p_warm"] = warm_out["p"]
                new_state["p2_warm"] = warm_out["p2"]
                if "u_star" in warm_out:
                    new_state["ustar_warm"] = warm_out["u_star"]
        if cfg.transport == "none":
            return new_state, metrics
        with span("transport"):
            if cfg.transport in _DYE_TRANSPORTS:
                if cfg.transport == "dye":
                    c = transport.advect_semilagrange(
                        mesh, problem.locator, state["c"], u, cfg.dt, L=cfg.L, H=cfg.H
                    )
                elif cfg.transport == "eulerian_dye":
                    c = eulerian_dye_step(problem, state["c"], u)
                else:
                    c = griddata_dye_step(problem, state["c"], u)
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
    if problem.config.transport in _DYE_TRANSPORTS:
        keys["mixing_var"] = problem.dtype
    elif problem.config.transport == "tracers":
        keys["eaten"] = torch.int64
    return keys


def steps_per_call(problem: StokesProblem) -> int:
    """The physics steps one call of the step function advances: K under
    K5, else 1."""
    return 1 if problem.grid_step is None else problem.grid_step.steps_per_call


def run(problem: StokesProblem, steps: int | None = None, state: dict | None = None):
    """Run ``steps`` steps (default ``config.steps``) → (state, metrics).

    A Python loop that only enqueues device work: each step's metrics go
    into preallocated (steps,) device tensors, and nothing here reads a
    value back to the host.  Under K5 with K steps a call, ``steps`` must
    be a multiple of K, and each call's (K,) series fills K entries.  Dye
    runs also report ``mixing_progress`` against the canonical initial
    state's variance.

    Where :func:`graph_path` holds, each step replays one CUDA graph of the
    step function instead (:func:`_captured_step`: captured at the
    problem's first such call with a state of that layout, reused after);
    the states and metrics are the eager loop's, and the returned tensors
    are the call's own.

    Its spans: ``stokes.run`` over the call; inside it ``run_setup`` (the
    start state where none is given, the metric series, the step
    function, and ``graph_capture`` where a graph is captured), each call
    of the step function, or each replay, as ``step`` (marked with its
    index), and the dye's ``dye_baseline``.  Under replay the step's inner
    spans are recorded once, at capture."""
    with span("stokes.run"):
        return _run(problem, steps, state)


# How run advanced its steps, over the process: graphs captured, steps
# replayed from one, and steps launched one kernel at a time.
graph_counts = {"captures": 0, "replays": 0, "eager_steps": 0}


def graph_path(problem: StokesProblem) -> bool:
    """True where :func:`run` replays a captured step: on the card, the
    unfused projection step on K2 and K3 (``ViscousGridCG`` and
    ``PressureGridCG`` kernels, not K5, not the fused or "report" step)
    with no transport, outside another capture.  Every other path reads
    the host or has not been shown capturable, and stays eager."""
    cfg = problem.config
    return (problem.device.type == "cuda"
            and isinstance(problem.visc_solver, ViscousGridCG) and not problem.visc_solver.plain
            and isinstance(problem.pressure_solver, PressureGridCG)
            and not problem.pressure_solver.plain
            and problem.grid_step is None and problem.fused_M is None
            and cfg.variant != "report" and cfg.transport == "none"
            and not torch.cuda.is_current_stream_capturing())


@dataclasses.dataclass(frozen=True)
class _Captured:
    static: dict  # the state the graph reads and writes back
    metric_keys: tuple
    metrics: torch.Tensor  # (len(metric_keys),) the graph writes each replay
    graph: Any


def _captured_step(problem: StokesProblem, state: dict) -> _Captured:
    """One step of :func:`make_step` captured by :func:`capture_step` on
    static buffers of ``state``'s layout (its keys, shapes, dtypes), cached
    on ``problem``, its metrics written into one vector.

    The warm-up step's iterations are taken off the solvers' counters again,
    so neither it nor the capture counts as a step; the kernel wrappers'
    launch counts keep the launches the host made for both, and a replay
    adds none."""
    layout = tuple((k, tuple(v.shape), v.dtype) for k, v in state.items())
    hit = problem._graphs.get(layout)
    if hit is not None:
        return hit
    with span("graph_capture"):
        step, metric_keys = make_step(problem), tuple(_metric_dtypes(problem))

        def stepped(s):
            new, metrics = step(s)
            return new, torch.stack([metrics[k] for k in metric_keys])

        counters = [c for c in (problem.visc_solver.iters_count,
                                problem.pressure_solver.iters_count) if c is not None]
        saved = [c.clone() for c in counters]
        static, vec, graph = capture_step(stepped, state, problem.device)
        for c, s in zip(counters, saved):
            c.copy_(s)
    hit = problem._graphs[layout] = _Captured(static, metric_keys, vec, graph)
    graph_counts["captures"] += 1
    return hit


def _replay(captured: _Captured, state: dict, n_steps: int):
    """``n_steps`` replays of ``captured`` from ``state`` → (state, metrics),
    as the eager loop's; the state is a copy of the static buffers."""
    for k, v in captured.static.items():
        v.copy_(state[k])
    vec = captured.metrics
    series = torch.empty((len(captured.metric_keys), n_steps), dtype=vec.dtype, device=vec.device)
    for i in range(n_steps):
        with span("step", step=i):
            captured.graph.replay()
            series[:, i].copy_(vec)
    graph_counts["replays"] += n_steps
    return ({k: v.clone() for k, v in captured.static.items()},
            dict(zip(captured.metric_keys, series)))


def _run(problem: StokesProblem, steps: int | None, state: dict | None):
    cfg = problem.config
    n_steps = steps if steps is not None else cfg.steps
    k = steps_per_call(problem)
    if n_steps % k:
        raise ValueError(f"run(steps={n_steps}) must be a multiple of grid_steps_per_call={k}")
    captured = None
    with span("run_setup"):
        if state is None:
            state = initial_state(problem)
        if n_steps and graph_path(problem):
            captured = _captured_step(problem, state)
        else:
            metrics = {
                key: torch.empty(n_steps, dtype=dt, device=problem.device)
                for key, dt in _metric_dtypes(problem).items()
            }
            step = make_step(problem)
    if captured is not None:
        return _replay(captured, state, n_steps)
    for i in range(n_steps // k):
        with span("step", step=i):
            state, m = step(state)
            with span("step_metrics"):
                for key, series in metrics.items():
                    series[i * k:(i + 1) * k] = m[key]
    graph_counts["eager_steps"] += n_steps
    if cfg.transport in _DYE_TRANSPORTS:
        with span("dye_baseline"):
            var0 = dye_baseline(problem, initial_state(problem))
            metrics["mixing_progress"] = 1.0 - metrics["mixing_var"] / (var0 + 1e-16)
    return state, metrics
