"""Shared helpers for the parity tests of ``tpufem_torch`` against ``tpufem``.

Both packages get the same generated mesh, configuration and seeded NumPy
inputs; results cross between them only as NumPy arrays.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

import tpufem.mesh as jmesh
import tpufem_torch.mesh as tmesh


@functools.lru_cache(maxsize=None)
def meshes(n_side: int, n_circle: int, pad_hole: bool = False):
    """(tpufem mesh, tpufem_torch mesh) of ``generate_annulus_mesh``."""
    kw = dict(n_side=n_side, n_circle=n_circle, pad_hole=pad_hole)
    return jmesh.generate_annulus_mesh(**kw), tmesh.generate_annulus_mesh(**kw)


def rel(a, b) -> float:
    """Relative L2 distance of ``a`` from the reference ``b``."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jittered(points: np.ndarray, seed: int = 42, sigma: float = 1e-3) -> np.ndarray:
    """Lattice points moved off the mesh edges, where containment is a tie."""
    rng = np.random.default_rng(seed)
    return points + sigma * rng.standard_normal(points.shape)


def jax_problem_arrays(problem) -> dict[str, np.ndarray]:
    """A tpufem ``StokesProblem`` as the arrays ``interop.problem_from_numpy``
    takes: its device operators plus boundary sets and locator tables."""
    from tpufem.workloads import stokes as jstokes

    arrays = {k: np.asarray(v) for k, v in jstokes._extract_arrays(problem).items()}
    for f in dataclasses.fields(problem.boundary):
        arrays[f"boundary.{f.name}"] = np.asarray(getattr(problem.boundary, f.name))
    arrays["inner_values"] = np.asarray(problem.inner_values)
    arrays["pressure_pin"] = np.asarray(problem.pressure_pin)
    loc = problem.locator
    if loc is not None:
        arrays.update({
            "locator.cells": loc.cells, "locator.rows": loc.rows,
            "locator.origin": np.asarray(loc.origin), "locator.extent": np.asarray(loc.extent),
            "locator.g": np.asarray(loc.g),
        })
    if problem.tracer_init is not None:
        arrays["tracer_init"] = np.asarray(problem.tracer_init)
    if hasattr(problem.visc_solver, "K") and hasattr(problem.visc_solver.K, "offsets"):
        arrays.update(_grid_extras(problem))
    return arrays


NS_MESH = (20, 24)  # pad_hole: N = 400 on a 20×20 grid
# the NS grid path at f64, short enough for tpufem's interpreted kernels
NS_GRID = dict(dt=1e-4, nu=1.0, solver="cg", precision="f64", cg_iters_visc=40,
               cg_iters_pressure=80, cg_tol=1e-10, cg_storage="grid_interpret")


@functools.lru_cache(maxsize=None)
def ns_grid_pair():
    """One NS grid-path problem in both packages on
    ``generate_annulus_mesh(20, 24, pad_hole=True)``, and the seeded velocity
    the refill and K4 tests use: (tpufem problem, port problem, u (N, 2))."""
    from tpufem.workloads import navier_stokes as jns

    jm, _ = meshes(*NS_MESH, pad_hole=True)
    jp = jns.NSProblem.build(jm, jns.NSConfig(**NS_GRID))
    return (jp,) + _ns_port_problem()


@functools.lru_cache(maxsize=None)
def ns_refill_pair():
    """What the refill and K4 tests need of :func:`ns_grid_pair` without
    tpufem's whole problem, whose build (JAX compiles, the pressure
    solver's λmax estimate) takes most of a test file's time: (tpufem mesh,
    tpufem ``GridRefill`` at f64, port problem, u (N, 2))."""
    import jax.numpy as jnp

    from tpufem.ops.gridop import GridRefill

    jm, _ = meshes(*NS_MESH, pad_hole=True)
    tp, u = _ns_port_problem()
    return jm, GridRefill.build(jm, tp.grid_refill.template.ns, dtype=jnp.float64), tp, u


@functools.lru_cache(maxsize=None)
def _ns_port_problem():
    import torch

    from tpufem_torch.workloads import navier_stokes as tns

    _, tm = meshes(*NS_MESH, pad_hole=True)
    tp = tns.NSProblem.build(tm, tns.NSConfig(**NS_GRID), device=torch.device("cpu"))
    u = 0.1 * np.random.default_rng(1).standard_normal((tm.n_nodes, 2))
    return tp, u


def ns_problem_arrays(problem) -> dict[str, np.ndarray]:
    """A tpufem grid-path ``NSProblem`` as the arrays
    ``interop.ns_problem_from_numpy`` takes."""
    from tpufem.workloads import stokes as jstokes

    arrays = {k: np.asarray(v) for k, v in jstokes._extract_arrays(problem).items()}
    arrays["wall_mask"] = np.asarray(problem.wall_mask)
    arrays["grid_refill.order_k"] = np.asarray(problem.grid_refill.order_k)
    arrays["grid_refill.order"] = np.asarray(problem.grid_refill.order)
    for prefix, op in (("grid_refill.template", problem.grid_refill.template),
                       ("pressure_solver.K", problem.pressure_solver.K)):
        arrays[f"{prefix}.offsets"] = np.asarray(op.offsets)
        arrays[f"{prefix}.n_rest"] = np.asarray(op.n_rest)
        arrays[f"{prefix}.coverage"] = np.asarray(op.coverage)
    arrays["pressure_solver.omega"] = np.asarray(problem.pressure_solver.omega)
    arrays["pressure_solver.pair_axis"] = np.asarray(problem.pressure_solver.pair_axis)
    return arrays


def _grid_extras(problem) -> dict[str, np.ndarray]:
    """What ``_extract_arrays`` leaves out of a grid-storage problem: the
    operators' static fields, ω, the pairing axis and CSR div/grad."""
    from tpufem.ops import calculus

    out = {}
    ops = [("visc_solver.K", problem.visc_solver.K),
           ("pressure_solver.K", problem.pressure_solver.K)]
    if problem.grid_step is not None:
        ops += [("grid_step.Gdx", problem.grid_step.Gdx), ("grid_step.Gdy", problem.grid_step.Gdy)]
    if problem.gridified is not None:
        out["gridified.perm"] = np.asarray(problem.gridified.perm)
    for prefix, op in ops:
        out[f"{prefix}.offsets"] = np.asarray(op.offsets)
        out[f"{prefix}.n_rest"] = np.asarray(op.n_rest)
        out[f"{prefix}.coverage"] = np.asarray(op.coverage)
    out["pressure_solver.omega"] = np.asarray(problem.pressure_solver.omega)
    out["pressure_solver.pair_axis"] = np.asarray(problem.pressure_solver.pair_axis)
    for key, op in zip(("mf_dx", "mf_dy"), calculus.divergence_csr_operators(problem.mesh)):
        out[f"{key}.indptr"] = np.asarray(op.indptr)
        out[f"{key}.indices"] = np.asarray(op.indices)
        out[f"{key}.data"] = np.asarray(op.data)
    return out


def sparse_th_arrays(problem) -> dict[str, np.ndarray]:
    """A tpufem ``SparseTHProblem`` as the arrays
    ``interop.sparse_th_problem_from_numpy`` takes: its CSR operators'
    patterns and values and its host arrays."""
    arrays = {}
    for name in ("K2", "M2", "Bx", "By", "BxT", "ByT", "Kp"):
        op = getattr(problem, name)
        arrays.update({f"{name}.indptr": np.asarray(op.indptr),
                       f"{name}.indices": np.asarray(op.indices),
                       f"{name}.data": np.asarray(op.data)})
    for name in ("mp_lumped", "vel_mask", "u_bc", "corners"):
        arrays[name] = np.asarray(getattr(problem, name))
    return arrays
