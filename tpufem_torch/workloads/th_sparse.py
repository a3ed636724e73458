"""Sparse (matrix-free) Taylor–Hood Stokes: the LBB-stable path at scale.

The counterpart of ``tpufem.workloads.th_sparse``.  The dense
:class:`~tpufem_torch.workloads.navier_stokes.TransientTHProblem` factors
the (2N₂+N₁)² saddle matrix on the host; this module solves the same
θ-scheme P2/P1 system with CSR operators and Uzawa-CG on the pressure
Schur complement, O(nnz) memory and work:

    [A   Bᵀ][u]   [r]        A = M₂/Δt + θ ν K₂   (per component, masked)
    [B   0 ][p] = [g]        B = −∫ ψ ∂φ, the P1×P2 divergence blocks

* outer: preconditioned CG on S p = B A⁻¹ r − g, S = B A⁻¹ Bᵀ, with the
  Cahouet–Chabard preconditioner S̃⁻¹ = ν M_p⁻¹ + Δt⁻¹ K_p⁻¹ (lumped P1
  pressure mass, a few Jacobi-PCG sweeps on the P1 pressure Laplacian);
* inner: Jacobi- (or two-level-) PCG on the SPD masked velocity operator;
* Dirichlet velocity BCs by lifting, u = ũ + u_bc with ũ ≡ 0 on the
  boundary;
* the constant pressure nullspace (enclosed flow) by deflation.

Two engines:

* the CSR engine (:class:`SparseTHProblem`, :func:`th_sparse_step`,
  :func:`run`, :func:`steady_solve`): plain PyTorch on any device;
* the grid engine (:class:`GridTHProblem`, :func:`th_grid_step`,
  :func:`run_grid`): both dof spaces renumbered onto rasters, every
  velocity solve one launch of kernel K2 (``ViscousGridCG`` on the identity
  split A − I of the velocity operator) and every Cahouet–Chabard sweep one
  launch of K3 (``PressureGridCG`` on K_p, two-level, constant-deflated on
  the active raster slots); the outer CG and the B/Bᵀ couplings stay CSR.
  ``interpret=True`` takes the kernels' plain versions on every device.

Differences from tpufem, deliberate:

* ``run`` and ``run_grid`` are Python loops of device steps (tpufem scans
  a compiled step and caches it); on CUDA ``run`` replays one CUDA graph of
  the CSR step, whose ~10⁵ small kernels the host cannot enqueue as fast
  as the card runs them; with ``host_loop=False`` ``run`` returns the
  stacked metrics and, as tpufem's scan, starts from rest;
* a CSR matvec takes an (N, k) block of columns directly (tpufem vmaps
  it), and the velocity solves apply their operator to both columns in
  one call; each column sums as its 1-D matvec;
* the grid engine tries the lattice width first and then tpufem's √N
  ladder, without tpufem's 128-aligned TPU rasters, and splits each
  operator with ``GridOperator.dense_split`` (the card's split);
* ``body_force`` may be an (N2, 2) nodal array on the grid engine too (it
  is pushed onto the raster); ``tol_outer > 0`` reads the outer stop test
  on the host each iteration, as the port's ``cg`` does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from tpufem_torch import config as tconfig
from tpufem_torch.mesh.core import Mesh, mesh_from_arrays
from tpufem_torch.ops import assembly, calculus
from tpufem_torch.ops.sparse import CSROperator, permute_csr
from tpufem_torch.solve.cg import cg, cg_fixed
from tpufem_torch.solve.matfree import _solve_columns
from tpufem_torch.solve.twolevel import build_twolevel, twolevel_preconditioner
from tpufem_torch.workloads.navier_stokes import _th_bc_dofs, _th_element_matrices

OPERATORS = ("K2", "M2", "Bx", "By", "BxT", "ByT", "Kp")


@dataclasses.dataclass
class SparseTHConfig:
    dt: float = 0.01
    steps: int = 200
    theta: float = 1.0  # 1 = backward Euler, 0.5 = Crank–Nicolson
    nu: float = 1.0
    B1: float = -2.0
    B2: float = 0.0
    # a constant volume force (fx, fy), or an (N2, 2) nodal array: the load
    # is its consistent-mass product M₂·f per component
    body_force: Any = (0.0, 0.0)
    center: tuple[float, float] = (0.5, 0.5)
    outer_marker: int = 1
    inner_marker: int = 2
    precision: str = "f64"
    iters_inner: int = 30  # velocity CG per Schur matvec
    iters_outer: int = 25  # Schur CG per step (warm-started)
    iters_plap: int = 8  # pressure-Laplacian sweeps per CC application
    precond_inner: str = "jacobi"  # | "twolevel": aggregation coarse-grid
    # correction on the velocity operator M₂/Δt + θνK₂
    coarse_nodes: int = 1024  # twolevel target coarse-space size


def _has_force(config: SparseTHConfig) -> bool:
    return bool(np.any(np.asarray(config.body_force)))


def _force(config: SparseTHConfig, shape, dtype, device) -> torch.Tensor:
    """The body force broadcast to the (N2, 2) velocity."""
    f = torch.as_tensor(np.asarray(config.body_force, dtype=np.float64), dtype=dtype,
                        device=device)
    return torch.broadcast_to(f, shape).contiguous()


def _metrics(u_new: torch.Tensor, div_w: torch.Tensor, div_nodal: torch.Tensor) -> dict:
    return {
        "max_u": torch.max(torch.abs(u_new)),
        "div_weak_max": torch.max(torch.abs(div_w)),
        "div_weak_l2": torch.sqrt(torch.sum(div_w * div_w)),
        "final_div_max": torch.max(torch.abs(div_nodal)),
    }


@dataclasses.dataclass(frozen=True)
class SparseTHProblem:
    mesh: Mesh  # P2 mesh (tris_p2 set)
    K2: CSROperator  # (N2, N2) P2 stiffness
    M2: CSROperator  # (N2, N2) P2 consistent mass
    Bx: CSROperator  # (N1, N2) pressure-velocity coupling (x)
    By: CSROperator
    BxT: CSROperator  # transposes (explicit CSR: column access is row access)
    ByT: CSROperator
    Kp: CSROperator  # (N1, N1) P1 pressure Laplacian (corner triangulation)
    mp_lumped: torch.Tensor  # (N1,) lumped P1 pressure mass
    vel_mask: torch.Tensor  # (N2,) 1.0 at interior velocity dofs
    u_bc: torch.Tensor  # (N2, 2) Dirichlet values (0 elsewhere)
    corners: np.ndarray  # (N1,) pressure dof → P2 node id
    pmesh: Mesh  # corner (P1) triangulation: pressure space and diagnostics
    config: SparseTHConfig
    tl_vel: Any = None  # solve.twolevel.TwoLevel on M₂/Δt + θνK₂ ("twolevel")

    @property
    def n2(self) -> int:
        return self.mesh.coords.shape[0]

    @property
    def n1(self) -> int:
        return len(self.corners)

    @property
    def device(self) -> torch.device:
        return self.mp_lumped.device

    @classmethod
    def build(cls, mesh: Mesh, config: SparseTHConfig = SparseTHConfig(),
              device=None) -> "SparseTHProblem":
        """Host-side assembly in NumPy float64 (tpufem's), then the operators
        on ``device`` (default CUDA) in the configuration's precision."""
        if mesh.tris_p2 is None:
            raise ValueError("sparse TH needs a P2 mesh (p2_refine)")
        ke, me, bex, bey, corners, p_of_node = _th_element_matrices(mesh)
        tris6 = np.asarray(mesh.tris_p2, dtype=np.int64)
        n2, n1 = mesh.coords.shape[0], len(corners)
        pconn = p_of_node[tris6[:, :3]]  # (T, 3) pressure dofs
        conn = assembly.assemble_csr_conn
        ops = {
            "K2": conn(tris6, tris6, ke, (n2, n2)),
            "M2": conn(tris6, tris6, me, (n2, n2)),
            "Bx": conn(pconn, tris6, bex, (n1, n2)),
            "By": conn(pconn, tris6, bey, (n1, n2)),
            "BxT": conn(tris6, pconn, np.swapaxes(bex, 1, 2), (n2, n1)),
            "ByT": conn(tris6, pconn, np.swapaxes(bey, 1, 2), (n2, n1)),
        }
        pmesh = corner_mesh(mesh, corners, p_of_node)
        ops["Kp"] = assembly.assemble_csr(pmesh, assembly.element_stiffness(pmesh))
        mp = assembly.lumped_mass(pmesh).numpy()
        dofs, values = _th_bc_dofs(mesh, config, n2)
        mask = np.ones(n2)
        ubc = np.zeros((n2, 2))
        mask[dofs % n2] = 0.0
        ubc[dofs % n2, dofs // n2] = values
        return cls.from_operators(mesh, config, ops, mp, mask, ubc, corners, device,
                                  pmesh=pmesh)

    @classmethod
    def from_operators(cls, mesh: Mesh, config: SparseTHConfig, ops: dict, mp_lumped,
                       vel_mask, u_bc, corners, device=None, pmesh: Mesh | None = None
                       ) -> "SparseTHProblem":
        """The problem holding the CSR operators ``ops`` (:data:`OPERATORS`)
        and the host arrays given, cast to the precision on ``device``;
        builds the two-level velocity preconditioner for
        ``precond_inner="twolevel"`` from the float64 values."""
        dev = tconfig.device(device)
        dtype = tconfig.dtype(config.precision, bf16=False)
        corners = np.asarray(corners, dtype=np.int64)
        if pmesh is None:
            p_of_node = -np.ones(mesh.coords.shape[0], dtype=np.int64)
            p_of_node[corners] = np.arange(len(corners))
            pmesh = corner_mesh(mesh, corners, p_of_node)
        mask = np.asarray(vel_mask, dtype=np.float64)

        def t(a):
            return torch.as_tensor(np.array(a, dtype=np.float64), dtype=dtype, device=dev)

        tl_vel = None
        if config.precond_inner == "twolevel":
            K2, M2 = ops["K2"], ops["M2"]
            # identical connectivity gives identical patterns, so the
            # velocity operator's CSR is a combination of the values
            if not np.array_equal(M2.indices, K2.indices):
                raise ValueError("M2/K2 pattern mismatch: cannot combine for twolevel")
            a_vel = K2.with_data(M2.data.double().to(dev) / config.dt
                                 + (config.theta * config.nu) * K2.data.double().to(dev))
            diag_v = a_vel.diag().cpu().numpy()
            inv_diag = t(np.where(mask > 0, 1.0 / diag_v, 1.0))
            mask_j = t(mask)

            def masked_mv(x):
                return mask_j * a_vel.matvec(mask_j * x) + (1.0 - mask_j) * x

            tl_vel = build_twolevel(a_vel, np.asarray(mesh.coords), masked_mv, inv_diag,
                                    target_coarse=config.coarse_nodes, dtype=dtype)
        cast = {k: ops[k].astype(dtype, dev) for k in OPERATORS}
        return cls(mesh=mesh, **cast, mp_lumped=t(mp_lumped), vel_mask=t(mask), u_bc=t(u_bc),
                   corners=corners, pmesh=pmesh, config=config, tl_vel=tl_vel)

    # -- operators ---------------------------------------------------------

    def vel_op(self, x: torch.Tensor) -> torch.Tensor:
        """A x = m∘((M₂/Δt + θνK₂)(m∘x)) + (1−m)∘x, for (N2,) or (N2, k)."""
        cfg = self.config
        m = self.vel_mask if x.ndim == 1 else self.vel_mask[:, None]
        xm = m * x
        ax = self.M2.matvec(xm) / cfg.dt + (cfg.theta * cfg.nu) * self.K2.matvec(xm)
        return m * ax + (1.0 - m) * x

    def vel_op_unmasked(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        return self.M2.matvec(x) / cfg.dt + (cfg.theta * cfg.nu) * self.K2.matvec(x)

    def b_apply(self, u: torch.Tensor) -> torch.Tensor:
        """(N2, 2) velocity → (N1,) weak divergence B u."""
        return self.Bx.matvec(u[:, 0]) + self.By.matvec(u[:, 1])

    def bt_apply(self, q: torch.Tensor) -> torch.Tensor:
        """(N1,) pressure → (N2, 2) gradient coupling Bᵀ q."""
        return torch.stack([self.BxT.matvec(q), self.ByT.matvec(q)], dim=1)

    @functools.cached_property
    def _vel_inv_diag(self) -> torch.Tensor:
        cfg = self.config
        diag = self.M2.diag() / cfg.dt + (cfg.theta * cfg.nu) * self.K2.diag()
        return torch.where(self.vel_mask > 0, 1.0 / diag, torch.ones_like(diag))

    @functools.cached_property
    def _kp_inv_diag(self) -> torch.Tensor:
        kdiag = self.Kp.diag()
        one = torch.ones_like(kdiag)
        return torch.where(kdiag > 0, 1.0 / torch.where(kdiag > 0, kdiag, one), one)

    def solve_vel(self, b: torch.Tensor, x0=None) -> torch.Tensor:
        """Inner PCG (Jacobi or two-level) on the masked velocity operator,
        (N2, k)."""
        inv = self._vel_inv_diag
        if self.tl_vel is not None:
            # column-broadcast shapes: the closure runs on (N2, k)
            precond = twolevel_preconditioner(self.vel_op, inv[:, None], self.tl_vel,
                                              active_mask=self.vel_mask[:, None])
        else:
            precond = lambda r: inv * r if r.ndim == 1 else inv[:, None] * r
        return _solve_columns(self.vel_op, b, x0=x0, iters=self.config.iters_inner,
                              precond=precond, block=True)

    def cc_precond(self, r: torch.Tensor) -> torch.Tensor:
        """Cahouet–Chabard: S̃⁻¹ r = ν M_p⁻¹ r + Δt⁻¹ K_p⁻¹ r (deflated)."""
        cfg = self.config
        kinv = self._kp_inv_diag
        z, _ = cg_fixed(self.Kp.matvec, r - torch.mean(r), iters=cfg.iters_plap,
                        precond=lambda q: kinv * q, deflate=True,
                        deflate_weights=torch.ones_like(r))
        return cfg.nu * (r / self.mp_lumped) + z / cfg.dt

    @functools.cached_property
    def corner_index(self) -> torch.Tensor:
        return torch.as_tensor(self.corners, device=self.device)

    @functools.cached_property
    def body_load(self) -> torch.Tensor | None:
        """M₂·f per component, or None without a body force."""
        if not _has_force(self.config):
            return None
        return self.M2.matvec(_force(self.config, self.u_bc.shape, self.u_bc.dtype, self.device))


def corner_mesh(mesh: Mesh, corners: np.ndarray, p_of_node: np.ndarray) -> Mesh:
    """The corner (P1) triangulation of a P2 mesh: the pressure space."""
    corner_tris = p_of_node[np.asarray(mesh.tris, dtype=np.int64)]
    return mesh_from_arrays(mesh.coords[corners], corner_tris.astype(np.int32),
                            np.asarray(mesh.markers)[corners])


def th_sparse_step(problem: SparseTHProblem, u: torch.Tensor, p0: torch.Tensor):
    """One θ-step → (u_new (N2, 2), p (N1,), metrics).

    ``u`` is the full velocity (BC values included); ``p0`` warm-starts the
    Schur CG."""
    cfg = problem.config
    m = problem.vel_mask[:, None]
    rhs_full = problem.M2.matvec(u) / cfg.dt - ((1.0 - cfg.theta) * cfg.nu) * problem.K2.matvec(u)
    if problem.body_load is not None:
        rhs_full = rhs_full + problem.body_load
    lift = problem.vel_op_unmasked(problem.u_bc)
    r_v = m * (rhs_full - lift)
    g = -problem.b_apply(problem.u_bc)
    solveA = problem.solve_vel

    # Schur CG:  S p = B A⁻¹ r_v − g
    rhs_p = problem.b_apply(solveA(r_v)) - g

    def s_apply(q):
        return problem.b_apply(solveA(m * problem.bt_apply(q)))

    p, _ = cg_fixed(s_apply, rhs_p, x0=p0, iters=cfg.iters_outer, precond=problem.cc_precond,
                    deflate=True, deflate_weights=torch.ones_like(rhs_p))
    u_new = solveA(r_v - m * problem.bt_apply(p)) + problem.u_bc
    # the weak divergence against the P1 tests, and the lumped nodal
    # divergence of the corner velocities (the P1/P1 path's final_div_max)
    div_nodal = calculus.divergence(problem.pmesh, u_new[problem.corner_index])
    return u_new, p, _metrics(u_new, problem.b_apply(u_new), div_nodal)


def _captured_step(problem: SparseTHProblem):
    """(u_in, p_in, outputs, graph): :func:`th_sparse_step` captured once
    as a CUDA graph on ``problem``'s card, with static inputs.  The step
    runs fixed iteration counts and reads nothing back to the host, so the
    graph replays exactly the kernels the eager step launches (~10⁵ small
    ones a step, which the host cannot enqueue as fast as the card runs
    them); tpufem compiles the step for the same reason."""
    hit = problem.__dict__.get("_captured")
    if hit is None:
        u_in = problem.u_bc.clone()
        p_in = torch.zeros(problem.n1, dtype=u_in.dtype, device=u_in.device)
        side = torch.cuda.Stream(u_in.device)
        side.wait_stream(torch.cuda.current_stream(u_in.device))
        with torch.cuda.stream(side):  # fills the caches the step reads
            th_sparse_step(problem, u_in, p_in)
        torch.cuda.current_stream(u_in.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = th_sparse_step(problem, u_in, p_in)
        hit = problem.__dict__["_captured"] = (u_in, p_in, out, graph)
    return hit


def _steps(problem: SparseTHProblem, u, p, n_steps: int, history: list | None = None):
    """``n_steps`` steps from (u, p) → (u, p, last metrics), appending each
    step's metrics to ``history``; on CUDA by replaying the captured step."""
    mets = None
    if problem.device.type != "cuda":
        for _ in range(n_steps):
            u, p, mets = th_sparse_step(problem, u, p)
            if history is not None:
                history.append(mets)
        return u, p, mets
    u_in, p_in, (u_out, p_out, m_out), graph = _captured_step(problem)
    for _ in range(n_steps):
        u_in.copy_(u)
        p_in.copy_(p)
        graph.replay()
        u, p = u_out, p_out
        if history is not None:
            history.append({k: v.clone() for k, v in m_out.items()})
    if n_steps:
        u, p, mets = u.clone(), p.clone(), {k: v.clone() for k, v in m_out.items()}
    return u, p, mets


def run(problem: SparseTHProblem, steps: int | None = None, host_loop: bool = False,
        state=None, return_state: bool = False):
    """Step from rest → (u (N2, 2), p (N1,), metrics), as tpufem's ``run``.

    ``host_loop=False``: the metrics of every step, stacked (tpufem's scan,
    which starts from rest and ignores ``state``).  ``host_loop=True``: the
    final step's metrics; ``state=(u, p)`` continues a run and
    ``return_state=True`` appends the ``(u, p)`` carry.  On CUDA each step
    replays one CUDA graph of :func:`th_sparse_step`, captured at the first
    call."""
    cfg = problem.config
    n_steps = steps if steps is not None else cfg.steps
    u0 = problem.u_bc
    p0 = torch.zeros(problem.n1, dtype=u0.dtype, device=u0.device)
    if host_loop:
        u, p, mets = _steps(problem, *(state if state is not None else (u0, p0)), n_steps)
        if return_state:
            return u, p, mets, (u, p)
        return u, p, mets
    history: list = []
    u, p, _ = _steps(problem, u0, p0, n_steps, history)
    return u, p, {k: torch.stack([h[k] for h in history]) for k in history[0]}


def steady_solve(problem: SparseTHProblem, iters_inner: int = 400, iters_outer: int = 80):
    """Steady Stokes Taylor–Hood by Uzawa-CG → (u (N2, 2), p (N1,)).

    Solves ν K₂ u + Bᵀ p = lift(u_bc), B u = −B u_bc matrix-free: two-level
    PCG on the masked ν K₂ inside, CG on S = B (νK₂)⁻¹ Bᵀ outside with the
    steady Cahouet–Chabard preconditioner ν M_p⁻¹, constant-deflated."""
    cfg = problem.config
    nu = cfg.nu
    mask = problem.vel_mask
    m = mask[:, None]
    K2 = problem.K2

    def a_mv(x):
        mm = mask if x.ndim == 1 else m
        return mm * (nu * K2.matvec(mm * x)) + (1.0 - mm) * x

    diag = nu * K2.diag()
    inv = torch.where(mask > 0, 1.0 / diag, torch.ones_like(diag))
    tl = build_twolevel(K2.with_data(nu * K2.data), np.asarray(problem.mesh.coords), a_mv, inv,
                        target_coarse=cfg.coarse_nodes)
    precond = twolevel_preconditioner(a_mv, inv[:, None], tl, active_mask=m)

    def solveA(b):
        return _solve_columns(a_mv, b, iters=iters_inner, precond=precond, block=True)

    r_v = -m * (nu * K2.matvec(problem.u_bc))
    g = -problem.b_apply(problem.u_bc)
    rhs_p = problem.b_apply(solveA(r_v)) - g

    def s_apply(q):
        return problem.b_apply(solveA(m * problem.bt_apply(q)))

    p, _ = cg_fixed(s_apply, rhs_p, iters=iters_outer,
                    precond=lambda r: nu * (r / problem.mp_lumped), deflate=True,
                    deflate_weights=torch.ones_like(rhs_p))
    u = solveA(r_v - m * problem.bt_apply(p)) + problem.u_bc
    return u, p


# ---------------------------------------------------------------------------
# The grid engine: every inner solve one launch of K2 or K3
# ---------------------------------------------------------------------------


def raster_candidates(coords: np.ndarray, hint: int | None = None) -> list[int]:
    """Raster widths to try, in order: the lattice width (the node count on
    the bottom edge y ≈ 0, which the hole leaves whole) where it fits, then
    tpufem's ladder over √N (its 128-aligned TPU widths left out)."""
    if hint is not None:
        return [hint]
    n = coords.shape[0]
    root = int(np.ceil(np.sqrt(n)))
    bottom = int((coords[:, 1] < 1e-9).sum())
    seen: list[int] = []
    for c in [bottom, root, int(1.1 * root), int(1.2 * root), int(1.35 * root)]:
        if c * c >= n and c not in seen:
            seen.append(c)
    return seen


def _grid_operator(csr_op: CSROperator, coords: np.ndarray, hint: int | None, dtype,
                   extra_diag: float = 0.0):
    """(perm, ns, split, raster CSR) for the first raster that takes the
    points: ``csr_op`` renumbered (float64, ``extra_diag`` added to its
    diagonal) and split the card's way (``GridOperator.dense_split``)."""
    from tpufem_torch.mesh.gridify import GridifyError, gridify_points
    from tpufem_torch.ops.gridop import GridDecompositionError, GridOperator

    data = csr_op.data.detach().cpu().to(torch.float64)
    if extra_diag:
        on_diag = torch.as_tensor(csr_op.row_ids == np.asarray(csr_op.indices),
                                  dtype=torch.float64)
        data = data + extra_diag * on_diag
    op = csr_op.with_data(data)
    err: Exception | None = None
    for cand in raster_candidates(coords, hint):
        try:
            perm, ns = gridify_points(coords, ns=cand)
            op_g = permute_csr(op, perm, perm, (ns * ns, ns * ns))
            split = GridOperator.dense_split(op_g, ns, dtype=dtype, device=csr_op.data.device)
            return perm, ns, split, op_g
        except (GridDecompositionError, GridifyError) as e:
            err = e
    raise err  # type: ignore[misc]


@dataclasses.dataclass(frozen=True)
class GridTHProblem:
    """The sparse Taylor–Hood stepper with every inner solve one kernel
    launch: both dof spaces on rasters (``gridify_points``), the velocity
    solves on K2 (:class:`~tpufem_torch.solve.grid_cg.ViscousGridCG` on the
    identity split A = I + (A − I) with the Dirichlet mask folded in, both
    columns in lockstep, tolerance exit), the Cahouet–Chabard sweeps on K3
    (:class:`~tpufem_torch.solve.grid_cg.PressureGridCG`, two-level, no
    periodic pairs, unit lumped mass, constant-deflated on the active
    slots).  The outer Schur CG and the B/Bᵀ couplings are CSR matvecs in
    the raster numbering."""

    base: SparseTHProblem
    ns2: int
    ns1: int
    perm2: np.ndarray  # (N2,) P2 dof → raster slot
    perm1: np.ndarray  # (N1,) pressure dof → raster slot
    vel_solver: Any  # ViscousGridCG on A − I (dt_nu=1)
    plap_solver: Any  # PressureGridCG on K_p
    M2g: CSROperator  # raster-numbered CSRs for the glue
    K2g: CSROperator
    Bxg: CSROperator
    Byg: CSROperator
    BxTg: CSROperator
    ByTg: CSROperator
    u_bc_g: torch.Tensor  # (ns2², 2)
    mask_g: torch.Tensor  # (ns2²,) interior-velocity indicator (0 at dummies)
    mp_g: torch.Tensor  # (ns1²,) lumped pressure mass (1 at dummies)
    act1: torch.Tensor  # (ns1²,) real-pressure-slot indicator
    corner_slots: torch.Tensor  # (N1,) pressure dof → P2 raster slot
    tol_outer: float = 0.0
    vel_restarts: int = 0  # iterative-refinement passes per velocity solve:
    # each computes the true residual r = m·(b − A·x) in CSR arithmetic and
    # solves only the correction in K2, which breaks the f32 stagnation of
    # the kernel's recurrence residual (tpufem's form: a restart of the
    # kernel from x0 converges to the kernel operator's own f32 fixed point)

    @classmethod
    def build(cls, base: SparseTHProblem, interpret: bool | None = None, ns2: int | None = None,
              ns1: int | None = None, tol_inner: float = 1e-6, tol_outer: float = 0.0,
              target_coarse: int = 1024, vel_restarts: int = 0) -> "GridTHProblem":
        """Rasters, splits and solvers from ``base`` (either build of it).
        ``interpret=True`` takes the kernels' plain versions on every device
        (the port's ``plain``); otherwise the wrappers launch K2 and K3 on
        CUDA and take the plain versions for CPU tensors."""
        from tpufem_torch.solve.grid_cg import PressureGridCG, ViscousGridCG

        cfg = base.config
        dtype, dev = base.mp_lumped.dtype, base.device
        plain = bool(interpret)
        if not np.array_equal(base.M2.indices, base.K2.indices):
            raise ValueError("M2/K2 pattern mismatch")
        a_op = base.K2.with_data(base.M2.data.double() / cfg.dt
                                 + (cfg.theta * cfg.nu) * base.K2.data.double())
        p2, ns2_, gopA, _ = _grid_operator(a_op, np.asarray(base.mesh.coords), ns2, dtype,
                                           extra_diag=-1.0)
        n2sq = ns2_ * ns2_
        mask_g = np.zeros(n2sq)
        mask_g[p2] = base.vel_mask.double().cpu().numpy()

        def t(a):
            return torch.as_tensor(np.array(a, dtype=np.float64), dtype=dtype, device=dev)

        vel_solver = ViscousGridCG(K=gopA, interior_mask=t(mask_g), dt_nu=1.0,
                                   iters=cfg.iters_inner, tol=tol_inner, plain=plain)
        p1, ns1_, gopP, kp_g = _grid_operator(base.Kp, np.asarray(base.pmesh.coords), ns1, dtype)
        n1sq = ns1_ * ns1_
        act1 = np.zeros(n1sq)
        act1[p1] = 1.0
        empty = np.zeros(0, dtype=np.int64)
        plap_solver = PressureGridCG.build(kp_g, gopP, m_lumped=np.ones(n1sq), masters=empty,
                                           slaves=empty, active_mask=act1, iters=cfg.iters_plap,
                                           tol=0.0, target_coarse=target_coarse, use_coarse=True,
                                           plain=plain)
        u_bc_g = np.zeros((n2sq, 2))
        u_bc_g[p2] = base.u_bc.double().cpu().numpy()
        mp_g = np.ones(n1sq)
        mp_g[p1] = base.mp_lumped.double().cpu().numpy()
        return cls(
            base=base, ns2=ns2_, ns1=ns1_, perm2=p2, perm1=p1,
            vel_solver=vel_solver, plap_solver=plap_solver,
            M2g=permute_csr(base.M2, p2, p2, (n2sq, n2sq)),
            K2g=permute_csr(base.K2, p2, p2, (n2sq, n2sq)),
            Bxg=permute_csr(base.Bx, p1, p2, (n1sq, n2sq)),
            Byg=permute_csr(base.By, p1, p2, (n1sq, n2sq)),
            BxTg=permute_csr(base.BxT, p2, p1, (n2sq, n1sq)),
            ByTg=permute_csr(base.ByT, p2, p1, (n2sq, n1sq)),
            u_bc_g=t(u_bc_g), mask_g=t(mask_g), mp_g=t(mp_g), act1=t(act1),
            corner_slots=torch.as_tensor(p2[base.corners], device=dev),
            tol_outer=tol_outer, vel_restarts=vel_restarts,
        )

    @property
    def device(self) -> torch.device:
        return self.mp_g.device

    # raster-layout helpers -------------------------------------------------

    def push2(self, field: np.ndarray) -> np.ndarray:
        out = np.zeros((self.ns2 * self.ns2,) + field.shape[1:], field.dtype)
        out[self.perm2] = field
        return out

    def pull2(self, field):
        """A raster field (array or tensor) in the original P2 numbering."""
        return field[self.perm2]

    def b_apply(self, w: torch.Tensor) -> torch.Tensor:
        return self.Bxg.matvec(w[:, 0]) + self.Byg.matvec(w[:, 1])

    def bt_apply(self, q: torch.Tensor) -> torch.Tensor:
        return torch.stack([self.BxTg.matvec(q), self.ByTg.matvec(q)], dim=1)

    def cc_precond(self, r: torch.Tensor) -> torch.Tensor:
        cfg = self.base.config
        z = self.plap_solver.solve(r)
        return cfg.nu * (r / self.mp_g) + z / cfg.dt

    def vel_op_unmasked(self, w: torch.Tensor) -> torch.Tensor:
        """(M₂/Δt + θνK₂) w in CSR arithmetic, raster numbering."""
        cfg = self.base.config
        return self.M2g.matvec(w) / cfg.dt + (cfg.theta * cfg.nu) * self.K2g.matvec(w)

    @functools.cached_property
    def body_load(self) -> torch.Tensor | None:
        """M₂·f per component on the raster, or None without a body force."""
        cfg = self.base.config
        if not _has_force(cfg):
            return None
        f = np.asarray(cfg.body_force, dtype=np.float64)
        f = self.push2(np.broadcast_to(f, (self.base.n2, 2)).copy())
        return self.M2g.matvec(torch.as_tensor(f, dtype=self.mp_g.dtype, device=self.mp_g.device))


def th_grid_step(gp: GridTHProblem, u: torch.Tensor, p0: torch.Tensor):
    """One θ-step in raster numbering → (u_new (ns2², 2), p (ns1²,),
    metrics).  Same algorithm as :func:`th_sparse_step`: each velocity
    solve is one launch of K2 (times ``1 + vel_restarts``), each
    Cahouet–Chabard application one launch of K3."""
    cfg = gp.base.config
    m = gp.mask_g[:, None]
    rhs_full = gp.M2g.matvec(u) / cfg.dt - ((1.0 - cfg.theta) * cfg.nu) * gp.K2g.matvec(u)
    if gp.body_load is not None:
        rhs_full = rhs_full + gp.body_load
    r_v = m * (rhs_full - gp.vel_op_unmasked(gp.u_bc_g))
    g = -gp.b_apply(gp.u_bc_g)

    solveA0 = gp.vel_solver.solve

    def solveA(b):
        x = solveA0(b)
        for _ in range(gp.vel_restarts):
            x = x + m * solveA0(m * (b - gp.vel_op_unmasked(x)))
        return x

    rhs_p = gp.b_apply(solveA(r_v)) - g

    def s_apply(q):
        return gp.b_apply(solveA(m * gp.bt_apply(q)))

    if gp.tol_outer > 0:
        p, _ = cg(s_apply, rhs_p, x0=p0, tol=gp.tol_outer, maxiter=cfg.iters_outer,
                  precond=gp.cc_precond, deflate=True, deflate_weights=gp.act1)
    else:
        p, _ = cg_fixed(s_apply, rhs_p, x0=p0, iters=cfg.iters_outer, precond=gp.cc_precond,
                        deflate=True, deflate_weights=gp.act1)
    u_new = solveA(r_v - m * gp.bt_apply(p)) + gp.u_bc_g
    div_nodal = calculus.divergence(gp.base.pmesh, u_new[gp.corner_slots])
    return u_new, p, _metrics(u_new, gp.b_apply(u_new), div_nodal)


def run_grid(gp: GridTHProblem, steps: int | None = None, state=None,
             return_state: bool = False):
    """Step the grid engine → (u (N2, 2) in the original numbering, p (N1,),
    the final step's metrics); ``state`` and the appended carry (with
    ``return_state``) are the raw raster-numbered ``(u, p)``.  A loop of
    device steps (tpufem's ``host_loop=True``, its default)."""
    cfg = gp.base.config
    n_steps = steps if steps is not None else cfg.steps
    p0 = torch.zeros(gp.ns1 * gp.ns1, dtype=gp.mp_g.dtype, device=gp.mp_g.device)
    u, p = state if state is not None else (gp.u_bc_g, p0)
    for _ in range(n_steps):
        u, p, mets = th_grid_step(gp, u, p)
    u_out = gp.pull2(u)
    p_out = p[gp.perm1]
    if return_state:
        return u_out, p_out, mets, (u, p)
    return u_out, p_out, mets
