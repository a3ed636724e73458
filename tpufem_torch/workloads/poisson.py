"""Steady FEM Poisson solve, the counterpart of ``tpufem.workloads.poisson``.

Pipeline: the signed-determinant stiffness K and the load −∫gφ; periodic
x-pairs with the wall pairs filtered; master/slave elimination; Dirichlet
rows (walls y≈0, H at the outer value, inner-marker nodes at the inner
value, inner winning where a node is both); one linear solve.

Set-up runs on the host in float64.  The dense paths (``solver="lu"`` or
``"inverse"``) factor there and solve on the device.  ``solver="cg"``
builds the same row-surgery operator as CSR (``bc.bc_surgery_csr``) and
runs a Jacobi or two-level right-preconditioned BiCGStab on the device,
with the tolerance exit read on the host each iteration; as in tpufem,
the operator is applied on the stencil (``ops.stencil``) where that covers
≥ 90 % of its entries.

A callable ``g_source`` is called with the centroid coordinates as torch
tensors (tpufem passes NumPy arrays to its ``jnp`` sources).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from tpufem_torch import bc
from tpufem_torch import config as tconfig
from tpufem_torch.mesh.core import Mesh
from tpufem_torch.ops import assembly
from tpufem_torch.ops.stencil import stencil_or_csr
from tpufem_torch.solve.cg import bicgstab_fixed
from tpufem_torch.solve.dense import make_dense_solver


def default_source(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """g(x, y) = 50 sin(3y)."""
    return 50.0 * torch.sin(3.0 * y)


@dataclasses.dataclass
class PoissonConfig:
    g_source: Callable | float = default_source
    inner_marker: int = 2
    outer_value: float = 1.0  # top/bottom walls
    inner_value: float = 0.0  # inner circle
    L: float = 1.0
    H: float = 1.0
    tol: float = 1e-6
    signed_det: bool = True  # divide by the signed determinant, as the reference
    periodic: bool = True
    solver: str = "lu"  # "lu" | "inverse" (dense) | "cg" (BiCGStab on the CSR surgery operator)
    cg_iters: int = 2000
    cg_tol: float = 1e-10
    cg_precond: str = "twolevel"  # | "jacobi"
    cg_coarse_nodes: int = 2048
    precision: str = "f64"  # "f32" casts the CG operator and rhs; the dense paths stay f64


def dirichlet_values(boundary: bc.ChannelBoundary, outer_value: float,
                     inner_value: float) -> np.ndarray:
    """The value of each ``boundary.dirichlet`` node: the inner value on
    inner-marker nodes (also where they are walls), else the outer value."""
    inner = np.isin(boundary.dirichlet, boundary.inner)
    return np.where(inner, inner_value, outer_value).astype(np.float64)


def _boundary(mesh: Mesh, config: PoissonConfig) -> bc.ChannelBoundary:
    return bc.ChannelBoundary.build(mesh, inner_marker=config.inner_marker, L=config.L,
                                    H=config.H, tol=config.tol)


def _load(mesh: Mesh, config: PoissonConfig) -> torch.Tensor:
    return assembly.load_vector(mesh, config.g_source, signed_area=config.signed_det,
                                negate=True)


def build_system(mesh: Mesh, config: PoissonConfig = PoissonConfig()):
    """The BC-applied dense system on the host: (A (N, N), b (N,), boundary),
    float64 NumPy."""
    ke = assembly.element_stiffness(mesh, signed=config.signed_det)
    A = assembly.assemble_dense(mesh, ke).numpy()
    b = _load(mesh, config).numpy()
    boundary = _boundary(mesh, config)
    if config.periodic and len(boundary.masters):
        A, b = bc.periodic_elimination(A, b, boundary.masters, boundary.slaves)
    A = bc.dirichlet_rows(A, boundary.dirichlet)
    b = b.copy()
    b[boundary.dirichlet] = dirichlet_values(boundary, config.outer_value, config.inner_value)
    return A, b, boundary


def solve(mesh: Mesh, config: PoissonConfig = PoissonConfig(), device=None):
    """Solve on ``device``: (f (N,), residual norm), float64 on the dense
    paths, the configuration's precision under ``solver="cg"``."""
    if config.solver == "cg":
        return solve_cg(mesh, config, device)
    dev = tconfig.device(device)
    A, b, _ = build_system(mesh, config)
    A_t = torch.as_tensor(A, device=dev)
    b_t = torch.as_tensor(b, device=dev)
    f = make_dense_solver(A, config.solver, device=dev).solve(b_t)
    return f, torch.linalg.norm(A_t @ f - b_t)


def build_system_csr(mesh: Mesh, config: PoissonConfig = PoissonConfig(), device=None):
    """The matrix-free twin of :func:`build_system`: (op, K_mod, b,
    boundary) with the row-surgery operator ``K_mod`` as CSR, float64 on
    ``device``, ``op`` the same operator on the stencil where that covers
    ≥ 90 % of its entries (else ``K_mod``), and the BC-applied load, O(nnz)
    host work."""
    dev = tconfig.device(device)
    K = assembly.assemble_csr(mesh, assembly.element_stiffness(mesh, signed=config.signed_det))
    boundary = _boundary(mesh, config)
    none = np.zeros(0, np.int64)
    masters = boundary.masters if config.periodic else none
    slaves = boundary.slaves if config.periodic else none
    K_mod, b = bc.bc_surgery_csr(K, masters, slaves, boundary.dirichlet, b=_load(mesh, config))
    b[torch.as_tensor(boundary.dirichlet, dtype=torch.int64)] = torch.as_tensor(
        dirichlet_values(boundary, config.outer_value, config.inner_value))
    K_mod = K_mod.astype(torch.float64, device=dev)
    return stencil_or_csr(K_mod, torch.float64, dev), K_mod, b.to(dev), boundary


def make_cg_solver(mesh: Mesh, config: PoissonConfig = PoissonConfig(), device=None):
    """(run, op, b, boundary) of the matrix-free path: ``run(b)`` is the
    BiCGStab solve on the row-surgery operator, returning (f, ‖r‖), split
    from :func:`solve_cg` so a benchmark can time the build and the solve
    apart.  After a call, ``run.iterations`` holds its iteration count."""
    op, K_csr, b, boundary = build_system_csr(mesh, config, device)
    if config.precision == "f32":
        op = op.astype(torch.float32)
        b = b.to(torch.float32)
    return cg_solver_on(op, K_csr, mesh, config), op, b, boundary


def cg_solver_on(op, K_csr, mesh: Mesh, config: PoissonConfig):
    """:func:`make_cg_solver`'s ``run`` on any storage of the operator
    (``op.matvec``, ``op.diag()``): the Jacobi or two-level preconditioner,
    the latter built from the f64 ``K_csr`` with ``op.matvec``."""
    from tpufem_torch.solve.twolevel import build_twolevel, twolevel_preconditioner

    diag = op.diag()
    one = torch.ones((), dtype=diag.dtype, device=diag.device)
    inv_diag = torch.where(diag != 0, 1.0 / torch.where(diag != 0, diag, one), one)
    if config.cg_precond == "twolevel":
        tl = build_twolevel(K_csr, np.asarray(mesh.coords), op.matvec, inv_diag,
                            target_coarse=config.cg_coarse_nodes, dtype=diag.dtype)
        precond = twolevel_preconditioner(op.matvec, inv_diag, tl)
    else:
        def precond(r):
            return inv_diag * r

    applications = [0]

    def counted(r):
        applications[0] += 1
        return precond(r)

    def run(b):
        applications[0] = 0
        out = bicgstab_fixed(op.matvec, b, iters=config.cg_iters, precond=counted,
                             tol=config.cg_tol)
        run.iterations = applications[0] // 2  # BiCGStab applies M twice an iteration
        return out

    run.iterations = 0
    return run


def solve_cg(mesh: Mesh, config: PoissonConfig = PoissonConfig(), device=None):
    """Matrix-free Poisson: Jacobi or two-level right-preconditioned
    BiCGStab on the row-surgery operator (nonsymmetric at the constraint
    and Dirichlet rows).  Matches the dense path to solver tolerance."""
    run, _, b, _ = make_cg_solver(mesh, config, device)
    return run(b)
