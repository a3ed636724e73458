"""The Navier–Stokes workload of the port (``tpufem_torch.workloads.
navier_stokes``) against tpufem's on generated meshes: the element and
matrix-free convection, BiCGStab, the pinned pressure PCG, the monolithic
solve, and the dense, CSR and grid step paths at f64 (the grid path through
the kernels' plain versions on both sides, from the port's own build and
from tpufem's operators carried across by ``interop``), and f32 against f64."""

import dataclasses
import functools
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.ops import assembly as jassembly
from tpufem.solve.cg import bicgstab_fixed as jbicgstab
from tpufem.workloads import navier_stokes as jns
from tpufem_torch import interop
from tpufem_torch.ops import assembly as tassembly
from tpufem_torch.solve.cg import bicgstab_fixed as tbicgstab
from tpufem_torch.solve import grid_cg
from tpufem_torch.workloads import navier_stokes as tns

from tests._torch_parity import NS_GRID, meshes, ns_grid_pair, ns_problem_arrays, rel

torch.set_num_threads(2)

MESH = (12, 16)
CPU = torch.device("cpu")
CSR = dict(dt=1e-4, nu=1.0, solver="cg", precision="f64", cg_iters_visc=40, cg_iters_pressure=200,
           cg_tol=1e-12)


@functools.lru_cache(maxsize=None)
def jax_run(kind: str, steps: int, **kw):
    """tpufem's (problem, u after ``steps`` steps): the grid pair's problem,
    or a (12, 16) problem of the configuration ``kw``."""
    if kind == "grid":
        problem = ns_grid_pair()[0]
    else:
        problem = jns.NSProblem.build(meshes(*MESH)[0], jns.NSConfig(**kw))
    u, _ = jns.run(problem, steps=steps, host_loop=True)
    return problem, np.asarray(u)


@pytest.mark.parametrize("variant", ["opsplit", "stokescolor"])
def test_element_convection_matches_tpufem(variant):
    """Array-equal at f64: the (T, 3, 3) form takes tpufem's mean (sum·⅓)
    and fused ū·∇φ, the flat form its sum/3 and unfused products."""
    jm, tm = meshes(*MESH)
    u = np.random.default_rng(4).standard_normal((jm.n_nodes, 2))
    np.testing.assert_array_equal(
        tassembly.element_convection(tm, torch.as_tensor(u), variant).numpy(),
        np.asarray(jassembly.element_convection(jm, jnp.asarray(u), variant=variant)))
    np.testing.assert_array_equal(
        tassembly.element_convection_flat(tm, torch.as_tensor(u), variant).numpy(),
        np.asarray(jassembly.element_convection_flat(jm, jnp.asarray(u), variant=variant)))


@pytest.mark.parametrize("tol", [0.0, 1e-10])
def test_bicgstab_fixed_matches_tpufem(tol):
    """A seeded nonsymmetric, diagonally dominant 500×500 system, Jacobi
    right preconditioning, 60 iterations or the tolerance."""
    rng = np.random.default_rng(5)
    n = 500
    A = 30.0 * np.eye(n) + rng.standard_normal((n, n))
    b, x0 = rng.standard_normal(n), rng.standard_normal(n)
    inv_d = 1.0 / np.diag(A)
    jA, tA = jnp.asarray(A), torch.as_tensor(A)
    want, _ = jbicgstab(lambda v: jA @ v, jnp.asarray(b), jnp.asarray(x0), iters=60,
                        precond=lambda r: jnp.asarray(inv_d) * r, tol=tol)
    got, res = tbicgstab(lambda v: tA @ v, torch.as_tensor(b), torch.as_tensor(x0),
                         iters=60, precond=lambda r: torch.as_tensor(inv_d) * r, tol=tol)
    assert rel(got.numpy(), np.asarray(want)) <= 1e-12
    assert float(res) <= 1e-8 * np.linalg.norm(b)


def test_pinned_pressure_cg_matches_tpufem():
    """The CSR path's pressure solver: ``PressureCG(pin=0)``, two-level,
    against tpufem's (which may take its stencil storage) on one rhs."""
    jp, _ = jax_run("csr", 10, mass_consistent=False, **CSR)
    tp = tns.NSProblem.build(meshes(*MESH)[1], tns.NSConfig(**CSR), device=CPU)
    assert tp.pressure_solver.pin == 0
    n = tp.mesh.n_nodes
    rng = np.random.default_rng(6)
    b, x0 = rng.standard_normal(n), rng.standard_normal(n)
    want = np.asarray(jp.pressure_solver.solve(jnp.asarray(b), x0=jnp.asarray(x0)))
    got = tp.pressure_solver.solve(torch.as_tensor(b), x0=torch.as_tensor(x0)).numpy()
    assert rel(got, want) <= 1e-10


def test_monolithic_matches_tpufem():
    jm, tm = meshes(*MESH)
    A, b = tns.assemble_monolithic(tm)
    jA, jb = jns.assemble_monolithic(jm)
    np.testing.assert_array_equal(A, jA)
    np.testing.assert_array_equal(b, jb)
    u, p, res = tns.solve_monolithic(tm, device=CPU)
    ju, jp, jres = jns.solve_monolithic(jm)
    assert rel(u.numpy(), np.asarray(ju)) <= 1e-10
    assert float(res) < 1e-6


def test_dense_path_matches_tpufem():
    _, want = jax_run("dense", 20, dt=1e-4)
    _, tm = meshes(*MESH)
    u, metrics = tns.run(tns.NSProblem.build(tm, tns.NSConfig(dt=1e-4), device=CPU), steps=20)
    assert rel(u.numpy(), want) <= 1e-10
    assert metrics["max_u"].shape == (20,) and bool(torch.isfinite(metrics["max_p"]).all())


@pytest.mark.parametrize("mass_consistent", [False, True])
def test_csr_path_matches_tpufem(mass_consistent):
    """tpufem may take its stencil storage here (K and the C(u) refill),
    which sums in another order than the port's CSR K and matrix-free C(u)."""
    _, want = jax_run("csr", 10, mass_consistent=mass_consistent, **CSR)
    _, tm = meshes(*MESH)
    tp = tns.NSProblem.build(tm, tns.NSConfig(mass_consistent=mass_consistent, **CSR), device=CPU)
    assert tp.grid_refill is None and tp.K_csr is not None
    u, _ = tns.run(tp, steps=10)
    assert rel(u.numpy(), want) <= 1e-9


@pytest.mark.parametrize("kind,changes,limit", [
    ("dense", dict(double_projection=True), 1e-12),
    ("dense", dict(mass_consistent=True), 1e-12),
    ("dense", dict(rho=2.0), 1e-12),
    ("csr", dict(double_projection=True), 1e-10),
    ("csr", dict(cg_precond="jacobi"), 1e-10),
    ("csr", dict(cg_tol=0.0), 1e-10),
], ids=["dense-double_projection", "dense-mass_consistent", "dense-rho2", "csr-double_projection",
        "csr-jacobi", "csr-tol0"])
def test_configuration_branches_match_tpufem(kind, changes, limit):
    """f64, 10 steps from rest on (12, 16): the configuration branches the
    two tests above leave out (on the dense path the first two are no-ops
    in both packages), within 1e-12 relative in u on the dense path and
    1e-10 on CSR (the CSR pressure solves stop on a tolerance; the
    re-anchor probe read ≤ 1.4e-12 on all six)."""
    kw = {**(dict(dt=1e-4) if kind == "dense" else CSR), **changes}
    _, want = jax_run(kind, 10, **kw)
    tp = tns.NSProblem.build(meshes(*MESH)[1], tns.NSConfig(**kw), device=CPU)
    u, _ = tns.run(tp, steps=10)
    assert rel(u.numpy(), want) <= limit


@pytest.mark.parametrize("source", ["build", "interop"])
def test_grid_path_matches_tpufem_grid_interpret(source):
    jp, want = jax_run("grid", 3)
    _, tp, _ = ns_grid_pair()
    if source == "interop":
        tp = interop.ns_problem_from_numpy(ns_problem_arrays(jp), tp.mesh,
                                           tns.NSConfig(**NS_GRID), device=CPU)
    assert tp.grid_refill.template.offsets == jp.grid_refill.template.offsets
    before = (grid_cg.ns_bicgstab.launches, grid_cg.pressure_cg.launches)
    u, metrics, (u2, p) = tns.run(tp, steps=3, return_state=True)
    assert (grid_cg.ns_bicgstab.launches, grid_cg.pressure_cg.launches) == before
    assert rel(u.numpy(), want) <= 1e-10
    assert u2 is u and p.shape == (tp.mesh.n_nodes,)


def test_f32_grid_path_tracks_tpufem_f64():
    _, want = jax_run("grid", 3)
    _, tp, _ = ns_grid_pair()
    cfg = tns.NSConfig(**{**NS_GRID, "precision": "f32", "cg_tol": 1e-5})
    u, _ = tns.run(tns.NSProblem.build(tp.mesh, cfg, device=CPU), steps=3)
    assert u.dtype == torch.float32
    assert rel(u.numpy(), want) <= 5e-3


def test_auto_storage_is_csr_on_the_cpu_and_continues():
    _, tp, _ = ns_grid_pair()
    cfg = tns.NSConfig(**{**NS_GRID, "cg_storage": "auto", "precision": "f32"})
    problem = tns.NSProblem.build(tp.mesh, cfg, device=CPU)
    assert problem.grid_refill is None
    u1, _, state = tns.run(problem, steps=2, return_state=True)
    u2, _ = tns.run(problem, steps=1, state=state)
    assert bool(torch.isfinite(u2).all()) and not torch.equal(u1, u2)


@pytest.mark.parametrize("call,item", [
    (lambda m: tns.NSProblem.build(m, tns.NSConfig(solver="cg", cg_storage="stencil"),
                                   device=CPU), "item 5"),
])
def test_unported_parts_refused(call, item):
    _, tm = meshes(*MESH)
    with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
        call(tm)


def test_port_imports_no_jax():
    code = ("import sys, tpufem_torch.workloads.navier_stokes, tpufem_torch.interop, "
            "tpufem_torch.workloads.th_sparse, tpufem_torch.bench_large; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tpufem')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
