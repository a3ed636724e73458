"""Grid renumbering (``tpufem_torch.mesh.gridify``) against tpufem's: the
same raster numbering of generated meshes, the renumbered Stokes grid path
against tpufem's, and the cases that must not renumber."""

import functools

import numpy as np
import pytest
import torch

import tpufem_torch
from tpufem.mesh import gridify as jgridify
from tpufem.mesh.core import mesh_from_arrays as jmesh_from_arrays
from tpufem.workloads import stokes as jstokes
from tpufem_torch import bench_large
from tpufem_torch.mesh import gridify as tgridify
from tpufem_torch.mesh import io as tio
from tpufem_torch.mesh.core import mesh_from_arrays as tmesh_from_arrays
from tpufem_torch.solve.grid_cg import ViscousGridCG
from tpufem_torch.workloads import stokes as tstokes

from tests._torch_parity import meshes, rel

torch.set_num_threads(2)

MESH = (20, 24)
CONFIG = dict(dt=0.01, nu=1.0, solver="cg", cg_precond="twolevel", cg_iters_visc=30,
              cg_iters_pressure=60, cg_warm_start=True, cg_tol_visc=1e-7, cg_tol_pressure=1e-7,
              precision="f64")


@functools.lru_cache(maxsize=None)
def scrambled():
    """The pad_hole mesh with its node ids permuted (N stays square): (tpufem
    mesh, port mesh)."""
    jm, _ = meshes(*MESH, pad_hole=True)
    perm = np.random.default_rng(3).permutation(jm.n_nodes)
    coords = np.empty_like(jm.coords)
    markers = np.empty_like(jm.markers)
    coords[perm] = jm.coords
    markers[perm] = jm.markers
    tris = perm[jm.tris].astype(np.int32)
    return jmesh_from_arrays(coords, tris, markers), tmesh_from_arrays(coords, tris, markers)


def _pair(kind):
    return meshes(*MESH, pad_hole=False) if kind == "annulus" else scrambled()


@pytest.mark.parametrize("kind", ["annulus", "scrambled pad_hole"])
def test_gridify_mesh_matches_tpufem(kind):
    jm, tm = _pair(kind)
    j, t = jgridify.gridify_mesh(jm), tgridify.gridify_mesh(tm)
    assert t.ns == j.ns and t.mesh.n_nodes == t.ns ** 2
    np.testing.assert_array_equal(t.perm, j.perm)
    for name in ("coords", "markers", "tris", "area"):
        np.testing.assert_array_equal(getattr(t.mesh, name), np.asarray(getattr(j.mesh, name)))
    assert tgridify.grid_numbering_ok(t.mesh)


def test_push_pull_round_trip():
    _, tm = meshes(*MESH, pad_hole=False)
    g = tpufem_torch.gridify_mesh(tm)
    field = np.random.default_rng(0).standard_normal((tm.n_nodes, 2))
    pushed = g.push(field)
    assert pushed.shape == (g.ns ** 2, 2)
    np.testing.assert_array_equal(g.pull(pushed), field)
    dummies = np.setdiff1d(np.arange(g.ns ** 2), g.perm)
    assert (pushed[dummies] == 0).all() and (g.mesh.markers[dummies] == -1).all()


def test_grid_numbered_mesh_passes_through():
    _, tm = meshes(*MESH, pad_hole=True)
    mesh, g = tgridify.ensure_grid_numbering(tm)
    assert mesh is tm and g is None


@functools.lru_cache(maxsize=None)
def jax_renumbered_run(steps: int = 3):
    jm, _ = meshes(*MESH, pad_hole=False)
    jp = jstokes.StokesProblem.build(jm, jstokes.StokesConfig(cg_storage="grid_interpret",
                                                              **CONFIG))
    state, metrics = jstokes.run(jp, steps=steps)
    return jp, np.asarray(jp.gridified.pull(np.asarray(state["u"]))), np.asarray(
        metrics["final_div_max"])


def test_renumbered_grid_path_matches_tpufem():
    jp, u_want, fd_want = jax_renumbered_run()
    _, tm = meshes(*MESH, pad_hole=False)
    tp = tstokes.StokesProblem.build(tm, tstokes.StokesConfig(cg_storage="grid", **CONFIG),
                                     device="cpu")
    assert isinstance(tp.visc_solver, ViscousGridCG)
    assert tp.gridified is not None and tp.mesh.n_nodes == tp.gridified.ns ** 2 > tm.n_nodes
    np.testing.assert_array_equal(tp.gridified.perm, jp.gridified.perm)
    state, metrics = tstokes.run(tp, steps=3)
    u = tp.gridified.pull(state["u"].numpy())
    assert u.shape == (tm.n_nodes, 2)
    assert rel(u, u_want) <= 1e-10
    np.testing.assert_allclose(metrics["final_div_max"].numpy(), fd_want, rtol=1e-8)


def test_auto_storage_falls_back_on_scrambled_square_mesh(monkeypatch):
    """``"auto"`` on CUDA tries the grid on any square N and must fall back
    to CSR on a numbering that is not grid-structured, without renumbering;
    the CUDA-side decision is forced here on the CPU."""
    _, tm = scrambled()
    monkeypatch.setattr(tstokes, "_storage", lambda config, dev: "auto_accel")
    tp = tstokes.StokesProblem.build(
        tm, tstokes.StokesConfig(solver="cg", cg_storage="auto", precision="f32"), device="cpu")
    assert not isinstance(tp.visc_solver, ViscousGridCG)
    assert tp.mesh is tm and tp.gridified is None and tp.grid_step is None


def test_imported_mesh_loads_and_renumbers(tmp_path):
    """run_imported's loader on a generated mesh written as Triangle files."""
    _, tm = meshes(*MESH, pad_hole=False)
    stem = str(tmp_path / "annulus.1")
    tio.write_node(stem + ".node", tm.coords, tm.markers)
    tio.write_ele(stem + ".ele", tm.tris)
    mesh = bench_large.imported_mesh(stem)
    np.testing.assert_array_equal(mesh.tris, tm.tris)
    np.testing.assert_array_equal(mesh.markers, tm.markers)
    np.testing.assert_allclose(mesh.coords, tm.coords, rtol=0, atol=1e-12)
    config = bench_large.bench_config(n_nodes=mesh.n_nodes, storage="grid", precision="f64")
    tp = tstokes.StokesProblem.build(mesh, config, device="cpu")
    assert tp.gridified is not None and isinstance(tp.visc_solver, ViscousGridCG)
