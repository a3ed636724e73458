"""Implicit-Euler heat equation, the counterpart of ``tpufem.workloads.heat``.

The reference's quirks are kept: the BC surgery (periodic elimination and
Dirichlet rows) is applied to the *stiffness* first, and only then
A = I + dt·K_mod, so Dirichlet diagonals become 1 + dt and periodic slave
rows (1 + dt, −dt); the per-step field re-application (u[slave] = u[master],
walls 1, inner 0) is what enforces the BCs.  The source is zeroed: the
right-hand side is uⁿ itself.

The system is factored once on the host (dense LU, or at f32 the inverse
applied as one matvec), or solved each step by a BiCGStab on
I + dt·K_mod with K_mod on the stencil at ≥ 90 % coverage, else as CSR
(``solver="cg"``, Poisson's ``build_system_csr``), warm-started from the
right-hand side.  ``run`` is a Python loop of device steps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from tpufem_torch import bc
from tpufem_torch import config as tconfig
from tpufem_torch.mesh.core import Mesh
from tpufem_torch.solve.cg import bicgstab_fixed
from tpufem_torch.solve.dense import DenseInverse, make_dense_solver
from tpufem_torch.workloads.poisson import (PoissonConfig, build_system, build_system_csr,
                                            default_source, dirichlet_values)


@dataclasses.dataclass
class HeatConfig:
    dt: float = 0.02
    steps: int = 600
    g_source: Callable | float = default_source
    inner_marker: int = 2
    outer_value: float = 1.0
    inner_value: float = 0.0
    L: float = 1.0
    H: float = 1.0
    tol: float = 1e-6
    solver: str = "lu"  # "lu" | "inverse" (dense) | "cg" (BiCGStab on I + dt·K_mod)
    precision: str = "f64"  # "f32": the host inverse applied in float32 (dense), or f32 CG
    cg_iters: int = 100
    cg_tol: float = 1e-10


@dataclasses.dataclass(frozen=True)
class _MatfreeHeatSolver:
    """Per-step BiCGStab on (I + dt·K_mod) x = b with the Jacobi
    preconditioner, warm-started from b (uⁿ⁺¹ ≈ uⁿ: at dt·λ ≪ 1 the
    system is close to the identity).  ``applications[0]`` counts the
    preconditioner's applications, two an iteration."""

    op: object  # K_mod: StencilOperator or CSROperator
    inv_diag: torch.Tensor
    dt: float
    iters: int
    tol: float
    applications: list = dataclasses.field(default_factory=lambda: [0])

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        inv_diag = self.inv_diag.to(b.dtype)

        def pre(r):
            self.applications[0] += 1
            return inv_diag * r

        x, _ = bicgstab_fixed(lambda v: v + self.dt * self.op.matvec(v), b, x0=b,
                              iters=self.iters, precond=pre, tol=self.tol)
        return x


@dataclasses.dataclass(frozen=True)
class HeatProblem:
    solver: object
    boundary: bc.ChannelBoundary
    dirichlet_values: torch.Tensor
    config: HeatConfig
    index: dict  # the boundary's index sets as int64 tensors on the device

    @classmethod
    def build(cls, mesh: Mesh, config: HeatConfig = HeatConfig(), device=None) -> "HeatProblem":
        dev = tconfig.device(device)
        pcfg = PoissonConfig(g_source=config.g_source, inner_marker=config.inner_marker,
                             outer_value=config.outer_value, inner_value=config.inner_value,
                             L=config.L, H=config.H, tol=config.tol)
        dtype = tconfig.dtype(config.precision, bf16=False)
        if config.solver == "cg":
            op, _, _, boundary = build_system_csr(mesh, pcfg, dev)
            op = op.astype(dtype)
            diag_a = 1.0 + config.dt * op.diag()
            inv_diag = torch.where(diag_a != 0, 1.0 / diag_a, torch.ones_like(diag_a))
            solver = _MatfreeHeatSolver(op=op, inv_diag=inv_diag, dt=config.dt,
                                        iters=config.cg_iters, tol=config.cg_tol)
        else:
            K, _, boundary = build_system(mesh, pcfg)  # the BC-applied stiffness
            A = np.eye(K.shape[0]) + config.dt * K
            if config.precision == "f32":
                solver = DenseInverse(inv=torch.as_tensor(np.linalg.inv(A), dtype=dtype,
                                                          device=dev))
            else:
                solver = make_dense_solver(A, config.solver, device=dev)
        values = dirichlet_values(boundary, config.outer_value, config.inner_value)
        return cls(solver=solver, boundary=boundary,
                   dirichlet_values=torch.as_tensor(values, dtype=dtype, device=dev),
                   config=config, index=boundary.index_tensors(dev))


def apply_field_bcs(problem: HeatProblem, u: torch.Tensor) -> torch.Tensor:
    """The periodic copy, then the Dirichlet overwrite (the reference's order)."""
    idx = problem.index
    if len(problem.boundary.masters):
        u = bc.apply_periodic_field(u, idx["masters"], idx["slaves"])
    return bc.apply_dirichlet_field(u, idx["dirichlet"], problem.dirichlet_values.to(u.dtype))


def initial_state(problem: HeatProblem, n: int) -> torch.Tensor:
    u = torch.zeros(n, dtype=tconfig.dtype(problem.config.precision, bf16=False),
                    device=problem.dirichlet_values.device)
    return apply_field_bcs(problem, u)


def make_step(problem: HeatProblem):
    """``step(u) → (u', max|u'|)``: one implicit solve (rhs = uⁿ), then the
    field BCs."""
    def step(u):
        u = apply_field_bcs(problem, problem.solver.solve(u))
        return u, torch.max(torch.abs(u))

    return step


def run_problem(problem: HeatProblem, u0: torch.Tensor, steps: int):
    """``steps`` steps from ``u0``: (u, max|u| per step)."""
    step = make_step(problem)
    u, maxu = u0, []
    for _ in range(steps):
        u, m = step(u)
        maxu.append(m)
    return u, torch.stack(maxu) if maxu else u.new_zeros(0)


def run(mesh: Mesh, config: HeatConfig = HeatConfig(), steps: int | None = None, device=None):
    """The full heat simulation: (u_final, max|u| per step)."""
    problem = HeatProblem.build(mesh, config, device)
    n_steps = steps if steps is not None else config.steps
    return run_problem(problem, initial_state(problem, mesh.n_nodes), n_steps)
