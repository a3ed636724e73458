"""The public names that closed the port's surface, each held against
tpufem by value: ``solve``'s exports, ``CSROperator.todense``,
``TopKLocator(mesh, k)`` and ``.centroids()``, ``StokesProblem.get_locator``,
``FusedStepMatvec``/``benchmark_matvec``, the grid solvers' ``matvec``,
``BatchedGridLocator.tables(dtype)`` and ``bench_large``'s sizes, labels and
``run_imported(stem)``."""

import dataclasses
import functools
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem
import tpufem.solve as jsolve
import tpufem_torch
import tpufem_torch.solve as tsolve
from tpufem import bench_large as jbl
from tpufem import transport as jtr
from tpufem.ops import pallas_kernels as jpk
from tpufem.ops import sparse as jsparse
from tpufem.workloads import stokes as jstokes
from tpufem_torch import bench_large as tbl
from tpufem_torch import transport as ttr
from tpufem_torch.ops import fused_matvec as fm
from tpufem_torch.ops import sparse as tsparse
from tpufem_torch.workloads import stokes as tstokes

from tests._torch_parity import jittered, meshes, rel

torch.set_num_threads(2)

SOLVE_EXPORTS = ("cg", "cg_fixed", "jacobi_pcg", "bicgstab_fixed", "ViscousCG", "PressureCG")


@pytest.mark.parametrize("name", SOLVE_EXPORTS)
def test_solve_exports(name):
    """The six names of ``tpufem.solve``'s ``__init__``, the objects of
    their submodules (``cg`` shadows the ``solve.cg`` submodule in both)."""
    assert name in tsolve.__all__ and name in jsolve.__all__
    home = "cg" if name in SOLVE_EXPORTS[:4] else "matfree"
    assert getattr(tsolve, name) is getattr(
        importlib.import_module(f"tpufem_torch.solve.{home}"), name)
    assert inspect.isfunction(tsolve.cg) and inspect.isfunction(jsolve.cg)


def test_solve_cg_export_matches_tpufem():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((12, 12))
    A = a @ a.T + 12 * np.eye(12)
    b = rng.standard_normal(12)
    xj, _ = jsolve.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), jnp.zeros(12), tol=1e-12,
                      maxiter=50)
    xt, _ = tsolve.cg(lambda v: torch.as_tensor(A) @ v, torch.as_tensor(b), torch.zeros(12,
                      dtype=torch.float64), tol=1e-12, maxiter=50)
    assert rel(xt.numpy(), np.asarray(xj)) <= 1e-13


def test_todense_is_tpufems_bit_for_bit():
    """Duplicates add, in the data's dtype."""
    rng = np.random.default_rng(1)
    n, nnz = 9, 40
    rows = np.sort(rng.integers(0, n, nnz))
    cols = rng.integers(0, 7, nnz).astype(np.int32)
    indptr = np.searchsorted(rows, np.arange(n + 1)).astype(np.int32)
    data = rng.standard_normal(nnz)
    want = np.asarray(jsparse.CSROperator(indptr, cols, jnp.asarray(data), (n, 7)).todense())
    got = tsparse.CSROperator(indptr, cols, torch.as_tensor(data), (n, 7)).todense()
    assert got.dtype == torch.float64 and got.shape == (n, 7)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.diff(rows) == 0).any()  # the pattern holds duplicates
    f32 = tsparse.CSROperator(indptr, cols, torch.as_tensor(data, dtype=torch.float32), (n, 7))
    assert f32.todense().dtype == torch.float32


def tie_points(jm) -> np.ndarray:
    """Mesh nodes and centroids: equidistant from several centroids."""
    return np.concatenate([jm.coords, jm.centroids()])


@pytest.mark.parametrize("k", [10, 3])
def test_topk_locator_constructs_as_tpufems(k):
    jm, tm = meshes(12, 16)
    jl, tl = jtr.TopKLocator(jm, k), ttr.TopKLocator(tm, k, device="cpu")
    assert tl.k == jl.k == k
    np.testing.assert_array_equal(tl.centroids(), jl.centroids())
    pts = tie_points(jm)
    tri_j, found_j = jl.find(jnp.asarray(pts))
    tri_t, found_t = tl.find(torch.as_tensor(pts))
    np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_j))
    np.testing.assert_array_equal(tri_t.numpy()[found_t.numpy()],
                                  np.asarray(tri_j)[np.asarray(found_j)])
    built = ttr.TopKLocator.build(tm, k, device="cpu")
    np.testing.assert_array_equal(built.find(torch.as_tensor(pts))[0].numpy(), tri_t.numpy())
    assert ttr.TopKLocator(tm).k == jtr.TopKLocator(jm).k == 10


@pytest.mark.parametrize("locator", ["grid", "topk"])
def test_get_locator_builds_once_as_tpufems(locator):
    jm, tm = meshes(12, 16)
    cfg = dict(transport="none", locator=locator)
    jp = jstokes.StokesProblem.build(jm, jstokes.StokesConfig(**cfg))
    tp = tstokes.StokesProblem.build(tm, tstokes.StokesConfig(**cfg), device="cpu")
    assert tp.locator is None and jp.locator is None
    loc = tp.get_locator()
    assert loc is tp.get_locator()  # built on first use, then cached
    assert type(loc).__name__ == type(jp.get_locator()).__name__
    pts = jittered(np.concatenate([jm.coords, jm.centroids()]), seed=3)
    tri_j, found_j = jp.get_locator().find(jnp.asarray(pts))
    tri_t, found_t = loc.find(torch.as_tensor(pts))
    np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_j))
    np.testing.assert_array_equal(tri_t.numpy(), np.asarray(tri_j))
    dye = tstokes.StokesProblem.build(tm, tstokes.StokesConfig(transport="dye"), device="cpu")
    assert dye.get_locator() is dye.locator


def test_fused_step_matvec_class_matches_tpufems():
    rng = np.random.default_rng(2)
    n = 50
    M, b, x = rng.standard_normal((n, n)), rng.standard_normal(n), rng.standard_normal(n)
    want = np.asarray(jpk.FusedStepMatvec(M, b, dtype=jnp.float64, use_pallas=False)(
        jnp.asarray(x)))
    mv = fm.FusedStepMatvec(M, b, dtype=torch.float64, device="cpu")
    assert mv.use_pallas is False and mv.n == n
    before = fm.fused_step_matvec.launches
    got = mv(torch.as_tensor(x)).numpy()
    assert fm.fused_step_matvec.launches == before
    assert rel(got, want) <= 1e-14
    # the default: K1 on a CUDA device at either dtype, the plain version on the CPU
    assert fm.FusedStepMatvec(M, b, device="cpu").use_pallas is False
    with pytest.raises(ValueError, match="CUDA device"):
        fm.FusedStepMatvec(M, b, use_pallas=True, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        fm.benchmark_matvec(M, b, iters=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fm.FusedStepMatvec(M, b)


GRID = dict(dt=0.01, nu=1.0, solver="cg", cg_iters_visc=30, cg_iters_pressure=60,
            cg_precond="twolevel", cg_warm_start=True, cg_tol_pressure=1e-5, cg_tol_visc=1e-5,
            precision="f64", cg_storage="grid_interpret")


@functools.lru_cache(maxsize=None)
def grid_pair():
    jm, tm = meshes(20, 24, pad_hole=True)
    return (jstokes.StokesProblem.build(jm, jstokes.StokesConfig(**GRID)),
            tstokes.StokesProblem.build(tm, tstokes.StokesConfig(**GRID), device="cpu"))


@pytest.mark.parametrize("solver", ["visc_solver", "pressure_solver"])
def test_grid_solver_matvec_matches_tpufems(solver):
    jp, tp = grid_pair()
    x = np.random.default_rng(4).standard_normal(tp.mesh.n_nodes)
    want = np.asarray(getattr(jp, solver).matvec(jnp.asarray(x)))
    got = getattr(tp, solver).matvec(torch.as_tensor(x)).numpy()
    assert rel(got, want) <= 1e-14


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batched_tables_take_a_dtype(dtype):
    kw = dict(n_side=14, n_circle=16, pad_hole=True, jitter=0.15)
    jl = jtr.BatchedGridLocator.build([tpufem.generate_annulus_mesh(seed=s, **kw)
                                       for s in range(2)])
    tl = ttr.BatchedGridLocator.build([tpufem_torch.generate_annulus_mesh(seed=s, **kw)
                                       for s in range(2)], device="cpu")
    jt, tt = jl.tables(getattr(jnp, dtype)), tl.tables(getattr(torch, dtype))
    for a, b in zip(tt, jt):
        assert a.dtype == getattr(torch, dtype) and b.dtype == getattr(jnp, dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert all(a is b for a, b in zip(tl.tables(), (tl.rows, tl.origins, tl.extents,
                                                    tl.coords)))


def record_calls(module, monkeypatch):
    """Patch ``module``'s runners to record (runner, size, steps) and run
    nothing; returns the record."""
    calls = []

    def fake(kind):
        def run(*args, **kw):
            calls.append((kind,) + tuple(a for a in args if not isinstance(a, str)))
            return {"n_nodes": 1, "steps_per_sec": 1.0, "cg_iters_per_sec": 1.0,
                    "div_rel": 0.01, "storage": "csr", "compile_s": 0.0,
                    "cold_steps_per_sec": 1.0, "warm_steps_per_sec": 1.0, "build_s": 0.0}
        return run

    for kind in ("run_one", "run_imported", "run_th_sparse", "run_ns", "run_poisson_large",
                 "run_heat_large"):
        monkeypatch.setattr(module, kind, fake(kind))
    return calls


@pytest.mark.parametrize("argv", [
    [], ["--sizes", "2k,1.05M"], ["--sizes", "6k"], ["--steps", "7"], ["--ns"],
    ["--ns", "--sizes", "2k"], ["--poisson"], ["--heat"], ["--heat", "--sizes", "2k,6k"],
    ["--poisson", "--precision", "f64"], ["--mesh", "mesh_fine.1"],
    ["--th", "--n-side", "8"],
], ids=lambda a: " ".join(a) or "defaults")
def test_bench_large_sizes_and_labels_match_tpufems(argv, monkeypatch, capsys):
    want_calls = record_calls(jbl, monkeypatch)
    got_calls = record_calls(tbl, monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    want = [r["label"] for r in jbl.main(argv)]
    got = [r["label"] for r in tbl.main(argv)]
    assert got == want and got
    assert got_calls == want_calls
    out = capsys.readouterr().out
    stokes_sweep = not any(a in argv for a in ("--th", "--ns", "--poisson", "--heat"))
    assert ("| nodes |" in out) == stokes_sweep


def test_bench_large_opt_in_and_run_imported_as_tpufems():
    assert tbl.LARGE_OPT_IN == jbl.LARGE_OPT_IN
    assert [s[0] for s in tbl.SIZES] == [s[0] for s in jbl.SIZES]
    assert list(inspect.signature(tbl.run_imported).parameters)[:2] == ["stem", "steps"]
    for n in (2_000, 20_000):
        assert dataclasses.asdict(tbl.bench_config(n_nodes=n)) == dataclasses.asdict(
            jbl.bench_config(n_nodes=n))
