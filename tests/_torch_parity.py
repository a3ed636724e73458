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
    loc = problem.locator
    if loc is not None:
        arrays.update({
            "locator.cells": loc.cells, "locator.rows": loc.rows,
            "locator.origin": np.asarray(loc.origin), "locator.extent": np.asarray(loc.extent),
            "locator.g": np.asarray(loc.g),
        })
    if problem.tracer_init is not None:
        arrays["tracer_init"] = np.asarray(problem.tracer_init)
    return arrays
