"""Advection–diffusion with point-source injection, the counterpart of
``tpufem.workloads.advection_diffusion``.

Implicit step of ∂f/∂t + c·∇f = ν∇²f at a constant velocity c:

    (M + Δt(νK + C)) f' = M f,   f = 0 on every marked node,

with hard injections f = value at the nodes nearest given points every
step, and initial blobs.  The BC-applied matrix is built and factored once
on the host (f64 LU, or at f32 the inverse); a step is the mass product
and one solve on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from tpufem_torch import config as tconfig
from tpufem_torch.mesh.core import Mesh
from tpufem_torch.ops import assembly
from tpufem_torch.solve.dense import DenseInverse, make_dense_solver


@dataclasses.dataclass
class ADConfig:
    dt: float = 1e-3
    steps: int = 1000  # T_final = 1.0
    nu: float = 0.01
    velocity: tuple[float, float] = (5.0, 5.0)
    boundary_value: float = 0.0
    # hard sources re-injected every step: (point, value)
    injections: Sequence[tuple[tuple[float, float], float]] = (
        ((0.0, 0.20), 10.0),
        ((0.20, 0.0), 10.0),
    )
    # one-time initial blobs: (point, value)
    init_blobs: Sequence[tuple[tuple[float, float], float]] = (
        ((0.80, 0.50), 10.0),
        ((0.75, 0.75), 10.0),
    )
    solver: str = "lu"
    precision: str = "f64"


def nearest_node(mesh: Mesh, point) -> int:
    """The node nearest ``point`` (the first on a tie)."""
    return int(np.argmin(np.linalg.norm(mesh.coords - np.asarray(point), axis=1)))


@dataclasses.dataclass(frozen=True)
class ADProblem:
    mesh: Mesh
    solver: Any
    mass: torch.Tensor  # consistent M, in the run's dtype on the device
    dirichlet: np.ndarray
    inject_idx: np.ndarray
    inject_vals: np.ndarray
    config: ADConfig

    @classmethod
    def build(cls, mesh: Mesh, config: ADConfig = ADConfig(), device=None) -> "ADProblem":
        dev = tconfig.device(device)
        dtype = tconfig.dtype(config.precision, bf16=False)
        K = assembly.assemble_dense(mesh, assembly.element_stiffness(mesh, signed=True)).numpy()
        M = assembly.assemble_dense(mesh, assembly.element_mass(mesh)).numpy()
        u_const = torch.tensor(config.velocity, dtype=torch.float64).repeat(mesh.n_nodes, 1)
        C = assembly.assemble_dense(
            mesh, assembly.element_convection(mesh, u_const, variant="opsplit")).numpy()
        A = M + config.dt * (config.nu * K + C)
        dirichlet = np.nonzero(mesh.markers != 0)[0]
        A[dirichlet, :] = 0.0
        A[dirichlet, dirichlet] = 1.0
        if config.precision == "f32":
            solver = DenseInverse(inv=torch.as_tensor(np.linalg.inv(A), dtype=dtype, device=dev))
        else:
            solver = make_dense_solver(A, config.solver, device=dev)
        return cls(
            mesh=mesh, solver=solver, mass=torch.as_tensor(M, dtype=dtype, device=dev),
            dirichlet=dirichlet,
            inject_idx=np.asarray([nearest_node(mesh, p) for p, _ in config.injections], np.int32),
            inject_vals=np.asarray([v for _, v in config.injections], dtype=np.float64),
            config=config,
        )


def initial_state(problem: ADProblem) -> torch.Tensor:
    f = np.zeros(problem.mesh.n_nodes)
    for pt, val in problem.config.init_blobs:
        f[nearest_node(problem.mesh, pt)] = val
    return torch.as_tensor(f, dtype=problem.mass.dtype, device=problem.mass.device)


def make_step(problem: ADProblem):
    """``step(f) → (f', max f')``: inject, M·f, Dirichlet rows, one solve."""
    dtype, dev = problem.mass.dtype, problem.mass.device
    idx = torch.as_tensor(problem.inject_idx, dtype=torch.int64, device=dev)
    vals = torch.as_tensor(problem.inject_vals, dtype=dtype, device=dev)
    dirichlet = torch.as_tensor(problem.dirichlet, dtype=torch.int64, device=dev)
    bval = torch.tensor(problem.config.boundary_value, dtype=dtype, device=dev)

    def step(f):
        f = f.index_put((idx,), vals)  # the per-step hard sources
        b = (problem.mass @ f).index_put((dirichlet,), bval)
        f = problem.solver.solve(b)
        return f, torch.max(f)

    return step


def run(problem: ADProblem, steps: int | None = None):
    """``steps`` steps from the initial blobs: (f, max f per step)."""
    n_steps = steps if steps is not None else problem.config.steps
    step = make_step(problem)
    f, maxf = initial_state(problem), []
    for _ in range(n_steps):
        f, m = step(f)
        maxf.append(m)
    return f, torch.stack(maxf) if maxf else f.new_zeros(0)
