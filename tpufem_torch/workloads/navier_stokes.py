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
* ``solver="cg"`` off the grid: K and the pressure operator on the
  stencil (``ops.stencil``) at ≥ 90 % coverage, C(u) refilled onto it once
  a step (``StencilRefill``), else CSR and C(u)·x applied matrix-free; a
  Jacobi-BiCGStab per velocity column, the node-0-pinned pressure PCG; the
  only path for ``mass_consistent=True``;
* ``solver="cg"`` on grid storage (ring-in-grid pad_hole meshes, N = ns²):
  C(u) refilled into offset planes (``GridRefill``), then one launch of K4
  for both velocity columns and one of K3 for the pressure.

Spans (:func:`tpufem_torch.metrics.span`): ``NSProblem.build`` (inside it
``assembly``, ``grid_refill``, ``dense_split``, ``pressure_build``);
``ns.run``, in it ``step`` (marked with its index), and in the step
``convection``, ``velocity_solve`` (K4's ``k4.launch`` inside),
``div``, ``pressure_solve`` (K3's ``k3.launch``), ``grad``, ``walls``
and ``step_metrics``.

``cg_storage``: ``"auto"`` takes the grid on CUDA at f32 when N = ns² and
``GridRefill`` decomposes, else tpufem's stencil rule, as ``"stencil"``
does; ``"grid"`` runs K4/K3 at f32 and f64; ``"grid_interpret"`` runs their
plain versions on any device; ``"csr"`` asks for CSR and the matrix-free
C(u), the port's own storage (tpufem has none of that name).

The dense P2/P1 Taylor–Hood solvers (:func:`solve_taylor_hood`, the
θ-scheme :class:`TransientTHProblem`) assemble and factor on the host in
float64 and apply on the device; their meshes come from
``mesh.p2.p2_refine``.  The sparse and grid Taylor–Hood engines are in
:mod:`tpufem_torch.workloads.th_sparse`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from tpufem_torch import config as tconfig
from tpufem_torch.mesh.core import Mesh
from tpufem_torch.metrics import span
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
# P2/P1 Taylor–Hood monolithic Stokes (LBB-stable), dense
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TaylorHoodConfig:
    nu: float = 1.0
    B1: float = -2.0  # squirmer gait, relative to the center
    B2: float = 0.0
    center: tuple[float, float] = (0.5, 0.5)
    outer_marker: int = 1
    inner_marker: int = 2


def _p2_quadrature():
    """The 3-midpoint rule, exact for degree-2 integrands on a triangle."""
    pts = np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]])
    w = np.full(3, 1.0 / 3.0)
    return pts, w


def _p2_quadrature_deg4():
    """Dunavant's 6-point rule, exact to degree 4 (the P2·P2 mass)."""
    a1, a2 = 0.445948490915965, 0.091576213509771
    w1, w2 = 0.223381589678011, 0.109951743655322
    pts = np.array(
        [
            [1 - 2 * a1, a1, a1], [a1, 1 - 2 * a1, a1], [a1, a1, 1 - 2 * a1],
            [1 - 2 * a2, a2, a2], [a2, 1 - 2 * a2, a2], [a2, a2, 1 - 2 * a2],
        ]
    )
    w = np.array([w1, w1, w1, w2, w2, w2])
    return pts, w


_P2_PAIRS = [(1, 2), (2, 0), (0, 1)]  # midpoint k is opposite corner k


def _p2_values_at(L: np.ndarray) -> np.ndarray:
    """P2 shape values at barycentric point L → (6,)."""
    v = np.empty(6)
    for i in range(3):
        v[i] = L[i] * (2.0 * L[i] - 1.0)
    for k, (a, b) in enumerate(_P2_PAIRS):
        v[3 + k] = 4.0 * L[a] * L[b]
    return v


def _p2_grads_at_batch(L: np.ndarray, gl: np.ndarray) -> np.ndarray:
    """∇φ_a at barycentric point L for every element: gl (T, 3, 2) → (T, 6, 2),
    in Triangle's P2 node order (corners, then the midpoints opposite them)."""
    g = np.empty((gl.shape[0], 6, 2))
    for i in range(3):
        g[:, i] = (4.0 * L[i] - 1.0) * gl[:, i]
    for k, (a, b) in enumerate(_P2_PAIRS):
        g[:, 3 + k] = 4.0 * (L[a] * gl[:, b] + L[b] * gl[:, a])
    return g


def _th_element_matrices(mesh: Mesh):
    """The Taylor–Hood element matrices of every element (host NumPy f64):

      ke (T,6,6)  ∫ ∇φᵢ·∇φⱼ   (3-midpoint rule, exact for degree 2)
      me (T,6,6)  ∫ φᵢ φⱼ      (Dunavant 6-point, exact for degree 4)
      bex/bey (T,3,6)  −∫ ψᵢ ∂φⱼ/∂x|y   (P1 test × P2 gradient)

    plus the pressure numbering (corners, p_of_node)."""
    if mesh.tris_p2 is None:
        raise ValueError("Taylor–Hood needs a 6-node (P2) mesh: see mesh.p2.p2_refine")
    tris6 = mesh.tris_p2
    n2 = mesh.coords.shape[0]
    corners = np.unique(tris6[:, :3])
    p_of_node = -np.ones(n2, dtype=np.int64)
    p_of_node[corners] = np.arange(len(corners))

    gl = mesh.grads  # (T, 3, 2) barycentric gradients
    area = mesh.area
    T = tris6.shape[0]
    ke = np.zeros((T, 6, 6))
    bex = np.zeros((T, 3, 6))
    bey = np.zeros((T, 3, 6))
    pts, wq = _p2_quadrature()
    for q in range(len(wq)):
        g6 = _p2_grads_at_batch(pts[q], gl)  # (T, 6, 2)
        wa = (wq[q] * area)[:, None, None]
        ke += wa * np.einsum("tid,tjd->tij", g6, g6)
        psi = pts[q]  # (3,) P1 values at the quadrature point
        bex -= wa * psi[None, :, None] * g6[:, None, :, 0]
        bey -= wa * psi[None, :, None] * g6[:, None, :, 1]
    me = np.zeros((T, 6, 6))
    pts4, wq4 = _p2_quadrature_deg4()
    for q in range(len(wq4)):
        phi = _p2_values_at(pts4[q])  # (6,)
        me += (wq4[q] * area)[:, None, None] * np.outer(phi, phi)[None]
    return ke, me, bex, bey, corners, p_of_node


def _scatter_block(A, rows, cols, elem):
    """A[rows_i, cols_j] += elem[t, i, j] for all t (dense scatter-add)."""
    ri = np.repeat(rows, cols.shape[1], axis=1).reshape(-1)
    ci = np.tile(cols, (1, rows.shape[1])).reshape(-1)
    np.add.at(A, (ri, ci), elem.reshape(-1))


def _th_bc_dofs(mesh: Mesh, config, n2: int):
    """(Dirichlet velocity dofs, their values) of the squirmer TH system:
    no-slip outer walls, the squirmer velocity on the inner boundary."""
    from tpufem_torch import bc as bc_mod

    outer = np.nonzero(mesh.markers == config.outer_marker)[0]
    inner = np.nonzero(mesh.markers == config.inner_marker)[0]
    vals = np.zeros((len(inner), 2))
    if len(inner):
        vals = bc_mod.squirmer_values(mesh.coords, inner, config.center, config.B1, config.B2)
    dofs = np.concatenate([outer, outer + n2, inner, inner + n2])
    values = np.concatenate([np.zeros(2 * len(outer)), vals[:, 0], vals[:, 1]])
    return dofs.astype(np.int64), values


def _th_blocks(mesh: Mesh, corners: np.ndarray, p_of_node: np.ndarray):
    """The dof blocks of every element: (uₓ (T, 6), u_y (T, 6), p (T, 3))
    in the layout [uₓ (N2); u_y (N2); p (N1 corner nodes)]."""
    n2 = mesh.coords.shape[0]
    ux = mesh.tris_p2.astype(np.int64)
    return ux, ux + n2, 2 * n2 + p_of_node[mesh.tris_p2[:, :3]]


def _scatter_saddle(A, blocks, velocity_elem, bex, bey):
    """The velocity blocks (``velocity_elem`` on both components) and the
    divergence coupling B and Bᵀ of the saddle system, into A."""
    ux, uy, pd = blocks
    _scatter_block(A, ux, ux, velocity_elem)
    _scatter_block(A, uy, uy, velocity_elem)
    _scatter_block(A, pd, ux, bex)
    _scatter_block(A, pd, uy, bey)
    _scatter_block(A, ux, pd, np.swapaxes(bex, 1, 2))
    _scatter_block(A, uy, pd, np.swapaxes(bey, 1, 2))


def assemble_taylor_hood(mesh: Mesh, config: TaylorHoodConfig = TaylorHoodConfig()):
    """(A, b, corners) of the P2-velocity / P1-pressure saddle system, host
    NumPy f64: LBB-stable, uniquely solvable once one pressure dof is
    pinned.  DOF layout [uₓ (N2); u_y (N2); p (N1 corner nodes)]."""
    ke, _, bex, bey, corners, p_of_node = _th_element_matrices(mesh)
    n2 = mesh.coords.shape[0]
    total = 2 * n2 + len(corners)
    A = np.zeros((total, total))
    _scatter_saddle(A, _th_blocks(mesh, corners, p_of_node), config.nu * ke, bex, bey)
    b = np.zeros(total)
    dofs, values = _th_bc_dofs(mesh, config, n2)
    A[dofs, :] = 0.0
    A[dofs, dofs] = 1.0
    b[dofs] = values
    pin = 2 * n2
    A[pin, :] = 0.0
    A[pin, pin] = 1.0
    b[pin] = 0.0
    return A, b, corners


def solve_taylor_hood(mesh: Mesh, config: TaylorHoodConfig = TaylorHoodConfig(), device=None):
    """(u (N2, 2), p (N1,), residual ‖A·sol − b‖) on ``device``: one dense
    LU solve, factored on the host in float64."""
    A, b, _ = assemble_taylor_hood(mesh, config)
    dev = tconfig.device(device)
    A_t = torch.as_tensor(A, device=dev)
    b_t = torch.as_tensor(b, device=dev)
    sol = make_dense_solver(A, "lu", device=dev).solve(b_t)
    n2 = mesh.coords.shape[0]
    u = torch.stack([sol[:n2], sol[n2:2 * n2]], dim=1)
    return u, sol[2 * n2:], torch.linalg.norm(A_t @ sol - b_t)


# ---------------------------------------------------------------------------
# Transient Taylor–Hood (θ-scheme)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TransientTHConfig(TaylorHoodConfig):
    dt: float = 0.01
    steps: int = 200
    theta: float = 1.0  # 1 = backward Euler, 0.5 = Crank–Nicolson
    precision: str = "f64"


@dataclasses.dataclass(frozen=True)
class TransientTHProblem:
    """θ-scheme stepper on the coupled P2/P1 saddle system:

        [M/Δt + θνK   Bᵀ] [uⁿ⁺¹]   [M/Δt uⁿ − (1−θ)νK uⁿ]
        [B            0 ] [pⁿ⁺¹] = [0]

    with Dirichlet rows on the velocity and the pressure pinned.  The
    system is constant: it is inverted once on the host (float64), and a
    step is the right-hand-side matvec and one (2N₂+N₁)² matvec on the
    device."""

    mesh: Mesh
    e_inv: torch.Tensor  # (total, total) inverse of the θ-system
    r_op: torch.Tensor  # (2N2, 2N2) right-hand-side operator M/Δt − (1−θ)νK
    bc_dofs: np.ndarray
    bc_values: torch.Tensor
    corners: np.ndarray
    config: TransientTHConfig
    bc_index: torch.Tensor  # bc_dofs as int64 on the device

    @classmethod
    def build(cls, mesh: Mesh, config: TransientTHConfig = TransientTHConfig(), device=None):
        ke, me, bex, bey, corners, p_of_node = _th_element_matrices(mesh)
        n2 = mesh.coords.shape[0]
        total = 2 * n2 + len(corners)
        dt, th, nu = config.dt, config.theta, config.nu
        blocks = _th_blocks(mesh, corners, p_of_node)
        E = np.zeros((total, total))
        R = np.zeros((2 * n2, 2 * n2))
        _scatter_saddle(E, blocks, me / dt + th * nu * ke, bex, bey)
        rhs_e = me / dt - (1.0 - th) * nu * ke
        _scatter_block(R, blocks[0], blocks[0], rhs_e)
        _scatter_block(R, blocks[1], blocks[1], rhs_e)

        dofs, values = _th_bc_dofs(mesh, config, n2)
        E[dofs, :] = 0.0
        E[dofs, dofs] = 1.0
        R[dofs, :] = 0.0  # BC rows carry the BC value directly
        pin = 2 * n2
        E[pin, :] = 0.0
        E[pin, pin] = 1.0
        return cls.from_host(mesh, config, np.linalg.inv(E), R, dofs, values, corners, device)

    @classmethod
    def from_host(cls, mesh: Mesh, config: TransientTHConfig, e_inv, r_op, bc_dofs, bc_values,
                  corners, device=None) -> "TransientTHProblem":
        """The problem from its host arrays, moved to ``device`` in the
        configuration's precision."""
        dev = tconfig.device(device)
        dtype = tconfig.dtype(config.precision, bf16=False)
        bc_dofs = np.asarray(bc_dofs, dtype=np.int64)
        return cls(
            mesh=mesh,
            e_inv=torch.as_tensor(np.asarray(e_inv), dtype=dtype, device=dev),
            r_op=torch.as_tensor(np.asarray(r_op), dtype=dtype, device=dev),
            bc_dofs=bc_dofs,
            bc_values=torch.as_tensor(np.asarray(bc_values), dtype=dtype, device=dev),
            corners=np.asarray(corners),
            config=config,
            bc_index=torch.as_tensor(bc_dofs, device=dev),
        )


def th_step(problem: TransientTHProblem, u_flat: torch.Tensor):
    """One θ-step: u_flat (2N2,) → (u_flat', p (N1,), metrics)."""
    n2 = problem.mesh.coords.shape[0]
    rhs_v = (problem.r_op @ u_flat).index_put((problem.bc_index,), problem.bc_values)
    rhs = torch.cat([rhs_v, u_flat.new_zeros(len(problem.corners))])
    sol = problem.e_inv @ rhs
    u_new = sol[:2 * n2]
    div = calculus.divergence(problem.mesh, torch.stack([u_new[:n2], u_new[n2:]], dim=1))
    metrics = {"max_u": torch.max(torch.abs(u_new)), "div_max": torch.max(torch.abs(div))}
    return u_new, sol[2 * n2:], metrics


def run_transient_th(problem: TransientTHProblem, steps: int | None = None):
    """``steps`` θ-steps from rest: (u (N2, 2), p (N1,), metrics per step)."""
    n_steps = steps if steps is not None else problem.config.steps
    n2 = problem.mesh.coords.shape[0]
    u = torch.zeros(2 * n2, dtype=problem.e_inv.dtype, device=problem.e_inv.device)
    p = u.new_zeros(len(problem.corners))
    history = []
    for _ in range(n_steps):
        u, p, m = th_step(problem, u)
        history.append(m)
    metrics = {k: torch.stack([m[k] for m in history]) for k in ("max_u", "div_max")} \
        if history else {}
    return torch.stack([u[:n2], u[n2:]], dim=1), p, metrics


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
    tconfig.dtype(config.precision, bf16=False)
    if config.solver != "cg":
        return
    if config.cg_storage not in _NS_STORAGES:
        raise ValueError(f"unknown cg_storage {config.cg_storage!r}; expected one of {_NS_STORAGES}")
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
    K_csr: Any = None  # signed-det stiffness: CSROperator, or StencilOperator by tpufem's rule
    conv_refill: Any = None  # stencil.StencilRefill of C(u), or None: C(u)·x matrix-free
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
        return tconfig.dtype(self.config.precision, bf16=False)

    @property
    def device(self) -> torch.device:
        return self.wall.device

    @classmethod
    def build(cls, mesh: Mesh, config: NSConfig = NSConfig(), device=None) -> "NSProblem":
        """Assemble on the host in float64, move to ``device`` (see
        :func:`tpufem_torch.config.device`), inside the span ``NSProblem.build``."""
        check_config(config)
        with span("NSProblem.build"):
            return cls._build(mesh, config, device)

    @classmethod
    def _build(cls, mesh: Mesh, config: NSConfig, device) -> "NSProblem":
        dtype = tconfig.dtype(config.precision, bf16=False)
        dev = tconfig.device(device)
        x, y = mesh.coords[:, 0], mesh.coords[:, 1]
        on_outer = ((np.abs(x) < config.tol) | (np.abs(x - config.L) < config.tol)
                    | (np.abs(y) < config.tol) | (np.abs(y - config.H) < config.tol))
        wall_mask = on_outer | (mesh.markers == config.inner_marker)
        force = torch.as_tensor(np.asarray(config.body_force), dtype=dtype, device=dev)
        if config.solver == "cg":
            return cls._build_matfree(mesh, config, wall_mask, force, dtype, dev)
        with span("assembly"):
            k = assembly.assemble_dense(mesh, assembly.element_stiffness(mesh, signed=True)).numpy()
        with span("pressure_build"):
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
        dummies, no valid triangle) are held at u = 0.  Off the grid every
        storage but ``"csr"`` takes tpufem's stencil rule (``_mat``,
        ``ops.stencil.stencil_or_csr``) for K, the pressure operator and
        C(u)."""
        from tpufem_torch.ops.gridop import GridDecompositionError, GridRefill

        n = mesh.n_nodes
        with span("assembly"):
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
                with span("grid_refill"):
                    refill = GridRefill.build(mesh, ns, dtype=dtype, device=dev)
            except GridDecompositionError:
                if explicit:
                    raise  # asked for by name: say why it cannot be had
                refill = None
            if refill is not None:
                return cls(**common, **_grid_fields(mesh, config, refill, K_p, m_l, deg, dtype, dev))

        # every storage but the port's own "csr" takes tpufem's stencil rule
        # (its matrix-free path has no other): K and the pressure operator
        # on the stencil at ≥ 90 % coverage, C(u) refilled onto it likewise
        stencil = storage != "csr"
        conv_refill = None
        if stencil:
            from tpufem_torch.ops.stencil import COVERAGE, StencilRefill, stencil_or_csr

            _mat = lambda csr: stencil_or_csr(csr, dtype, dev)
            conv_refill = StencilRefill.build(mesh, dtype=dtype, device=dev)
            if conv_refill.template.coverage < COVERAGE:
                conv_refill = None
        else:
            _mat = lambda csr: csr.astype(dtype, dev)
        with span("pressure_build"):
            K_p_op = _mat(K_p)
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
                K_merged=K_p_op, m_lumped=torch.as_tensor(m_l, dtype=dtype, device=dev),
                masters=empty, slaves=empty, active_mask=torch.ones(n, dtype=dtype, device=dev),
                iters=config.cg_iters_pressure, precond=config.cg_precond, lmax=lmax, twolevel=tl,
                tol=config.cg_tol, pin=0,
            )
        return cls(**common, pressure_solver=pressure, K_csr=_mat(K_signed),
                   conv_refill=conv_refill)


def _grid_fields(mesh, config, refill, K_p, m_l, deg, dtype, dev) -> dict:
    """The grid path's operators and solvers: νΔt·K on the refill's planes,
    K4 for the velocity, K3 for the pressure (constant deflation on the
    deg > 0 nodes instead of the CSR path's node-0 pin: u is the same, p
    differs by a constant)."""
    from tpufem_torch.ops.gridop import GridOperator
    from tpufem_torch.solve.grid_cg import NSGridBiCGStab, PressureGridCG

    plain = config.cg_storage == "grid_interpret"
    with span("grid_refill"):
        Kg = refill.refill(assembly.element_stiffness(mesh, signed=True).to(dtype=dtype, device=dev))
    nudt = float(config.nu * config.dt)
    kp = K_p.astype(dtype)  # the coarse operator from the run-precision values, as tpufem
    with span("dense_split"):
        kp_grid = GridOperator.dense_split(kp, refill.template.ns, dtype=dtype, device=dev)
    empty = np.zeros(0, dtype=np.int64)
    with span("pressure_build"):
        pressure = PressureGridCG.build(
            kp, kp_grid, m_l, empty, empty, (deg > 0).astype(np.float64),
            iters=config.cg_iters_pressure, tol=config.cg_tol,
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
    solve: → (u, p, div u*), the metrics' inputs."""
    cfg, mesh = problem.config, problem.mesh
    dt = cfg.dt
    with span("div"):
        div = calculus.divergence(mesh, u_star)
    with span("pressure_solve"):
        p = problem.pressure_solver.solve(-(cfg.rho / dt) * div, x0=p0)
    with span("grad"):
        u_new = u_star - dt * calculus.gradient(mesh, p)
    if cfg.double_projection:
        with span("div"):
            div2 = calculus.divergence(mesh, u_new)
        with span("pressure_solve"):
            p2 = problem.pressure_solver.solve(-(cfg.rho / dt) * div2, x0=p)
        with span("grad"):
            u_new = u_new - dt * calculus.gradient(mesh, p2)
    with span("walls"):
        u_new = torch.where(problem.wall[:, None], torch.zeros((), dtype=u_new.dtype,
                                                               device=u_new.device), u_new)
    return u_new, p, div


def _metrics(u, p, div) -> dict:
    return {"max_u": torch.max(torch.abs(u)), "max_p": torch.max(torch.abs(p)),
            "div_star_max": torch.max(torch.abs(div))}


def _ns_step_grid(problem: NSProblem, u: torch.Tensor, p0: torch.Tensor):
    """One step on the grid path: C(u) refilled into the planes, one K4
    launch for both velocity columns (warm start uⁿ), the K3 pressure."""
    cfg = problem.config
    dt = cfg.dt
    with span("convection"):
        Cg = problem.grid_refill.refill_flat(
            assembly.element_convection_flat(problem.mesh, u, "opsplit"))
        Ag = dataclasses.replace(Cg, diags=dt * Cg.diags + problem.Kg_diags,
                                 rest_vals=dt * Cg.rest_vals + problem.Kg_rest)
    with span("velocity_solve"):
        u_star = problem.vel_solver_grid.solve(Ag, problem.ones_mask, problem.inv_diag_visc,
                                               u + dt * problem.body_force, u)
    return _project(problem, u_star, p0)


def _ns_step_matfree(problem: NSProblem, u: torch.Tensor, p0: torch.Tensor):
    """One step off the grid: a Jacobi-BiCGStab of fixed length per
    velocity column (warm start uⁿ), C(u) refilled onto the stencil once a
    step where the problem holds a refill, else applied matrix-free, the
    pinned pressure PCG warm-started from the previous pressure."""
    cfg = problem.config
    dt = cfg.dt

    if problem.conv_refill is not None:
        with span("convection"):
            conv = problem.conv_refill.refill_flat(
                assembly.element_convection_flat(problem.mesh, u, "opsplit")).matvec
    else:
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
    with span("velocity_solve"):
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
    unchanged (its pressure solve takes no warm start).  Its spans:
    ``ns.run`` over the call, ``step`` (marked with its index) in it."""
    with span("ns.run"):
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
            with span("step", step=i):
                if problem.config.solver != "cg":
                    u, m = ns_step(problem, u)
                else:
                    step = _ns_step_grid if problem.grid_refill is not None else _ns_step_matfree
                    u, p, div = step(problem, u, p)
                with span("step_metrics"):
                    if problem.config.solver == "cg":
                        m = _metrics(u, p, div)
                    for k, series in metrics.items():
                        series[i] = m[k]
    if return_state:
        return u, metrics, (u, p)
    return u, metrics
