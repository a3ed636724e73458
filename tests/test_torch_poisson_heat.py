"""Poisson and heat of the port (``tpufem_torch.workloads.poisson``/``heat``),
its BC surgery and load vectors against tpufem's on generated meshes: the
same host inputs through both packages, f64 on the CPU, and the NumPy
oracle where it applies.  Each tolerance has the value measured on the CPU
beside it."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baselines import numpy_ref
from tpufem import bc as jbc
from tpufem.ops import assembly as jassembly
from tpufem.workloads import heat as jheat
from tpufem.workloads import poisson as jpoisson
from tpufem_torch import bc as tbc
from tpufem_torch import bench_large, interop
from tpufem_torch.ops import assembly as tassembly
from tpufem_torch.ops.sparse import csr_from_coo
from tpufem_torch.workloads import heat as theat
from tpufem_torch.workloads import poisson as tpoisson

from tests._torch_parity import meshes, rel

torch.set_num_threads(2)

CPU = torch.device("cpu")
MESH = (12, 16)
HEAT_STEPS = 50


def surgery_inputs():
    """tpufem's assembled Poisson stiffness (dense and CSR) and load on
    ``MESH``, and its channel boundary."""
    jm, _ = meshes(*MESH)
    ke = jassembly.element_stiffness(jm, signed=True)
    b = jassembly.load_vector(jm, jpoisson.default_source, signed_area=True, negate=True)
    boundary = jbc.ChannelBoundary.build(jm)
    return (np.asarray(jassembly.assemble_dense(jm, ke)), jassembly.assemble_csr(jm, ke),
            np.asarray(b), boundary)


def duplicated_pairs(boundary):
    """The generated mesh's injective pairs with a duplicate made by hand:
    the second master shares the first one's slave, as on mesh2.1."""
    masters, slaves = boundary.masters.copy(), boundary.slaves.copy()
    slaves[1] = slaves[0]
    return masters, slaves


def port_csr(K):
    """tpufem's CSR operator as the port's (f64 on the CPU)."""
    return csr_from_coo(np.asarray(K.row_ids), np.asarray(K.indices), np.asarray(K.data),
                        K.shape)


def test_dirichlet_rows_matches_tpufem():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((40, 40))
    idx = np.array([0, 7, 7, 31, 39])
    np.testing.assert_array_equal(tbc.dirichlet_rows(A, idx),
                                  np.asarray(jbc.dirichlet_rows(jnp.asarray(A), idx)))


@pytest.mark.parametrize("duplicated", [False, True])
def test_periodic_elimination_matches_tpufem(duplicated):
    """Array-equal, with the generated mesh's injective pairs and with a
    duplicated pair, whose later pair sees the slave row the earlier one
    rewrote."""
    A, _, b, boundary = surgery_inputs()
    masters, slaves = (duplicated_pairs(boundary) if duplicated
                       else (boundary.masters, boundary.slaves))
    want_A, want_b = jbc.periodic_elimination(jnp.asarray(A), jnp.asarray(b), masters, slaves)
    got_A, got_b = tbc.periodic_elimination(A, b, masters, slaves)
    np.testing.assert_array_equal(got_A, np.asarray(want_A))
    np.testing.assert_array_equal(got_b, np.asarray(want_b))


def test_bc_surgery_csr_matches_tpufem():
    """The CSR arrays and the treated load array-equal, and equal to the
    dense surgery entry for entry."""
    A, K, b, boundary = surgery_inputs()
    want, want_b = jbc.bc_surgery_csr(K, boundary.masters, boundary.slaves, boundary.dirichlet,
                                      b=jnp.asarray(b))
    got, got_b = tbc.bc_surgery_csr(port_csr(K), boundary.masters, boundary.slaves,
                                    boundary.dirichlet, b=torch.as_tensor(np.array(b)))
    np.testing.assert_array_equal(got.indptr, np.asarray(want.indptr))
    np.testing.assert_array_equal(got.indices, np.asarray(want.indices))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    dense, _ = tbc.periodic_elimination(A, b, boundary.masters, boundary.slaves)
    dense = tbc.dirichlet_rows(dense, boundary.dirichlet)
    rows = np.repeat(np.arange(got.shape[0]), np.diff(got.indptr))
    csr_dense = np.zeros_like(dense)
    csr_dense[rows, got.indices] = got.data.numpy()
    np.testing.assert_array_equal(csr_dense, dense)


def test_bc_surgery_csr_refuses_duplicated_pairs():
    """Both packages refuse a duplicated pair (the dense path's sequential
    semantics), with an AssertionError that names injectivity."""
    _, K, _, boundary = surgery_inputs()
    masters, slaves = duplicated_pairs(boundary)
    with pytest.raises(AssertionError, match="injective"):
        jbc.bc_surgery_csr(K, masters, slaves, boundary.dirichlet)
    with pytest.raises(AssertionError, match="injective"):
        tbc.bc_surgery_csr(port_csr(K), masters, slaves, boundary.dirichlet)


def test_periodic_relabel_tris_matches_tpufem():
    jm, _ = meshes(*MESH)
    boundary = jbc.ChannelBoundary.build(jm)
    np.testing.assert_array_equal(
        tbc.periodic_relabel_tris(jm.tris, boundary.masters, boundary.slaves),
        jbc.periodic_relabel_tris(jm.tris, boundary.masters, boundary.slaves))


@pytest.mark.parametrize("source", ["default", "constant"])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("negate", [False, True])
def test_load_vector_matches_tpufem(source, signed, negate):
    """1e-14 relative (measured 0 in all eight cases)."""
    jm, tm = meshes(*MESH)
    g_j, g_t = ((jpoisson.default_source, tpoisson.default_source) if source == "default"
                else (2.5, 2.5))
    want = jassembly.load_vector(jm, g_j, signed_area=signed, negate=negate)
    got = tassembly.load_vector(tm, g_t, signed_area=signed, negate=negate)
    assert rel(got.numpy(), np.asarray(want)) <= 1e-14


def test_load_vector_nodal_matches_tpufem():
    """1e-14 relative (measured 0)."""
    jm, tm = meshes(*MESH)
    g = np.random.default_rng(2).standard_normal(jm.n_nodes)
    want = jassembly.load_vector_nodal(jm, jnp.asarray(g))
    got = tassembly.load_vector_nodal(tm, torch.as_tensor(g))
    assert rel(got.numpy(), np.asarray(want)) <= 1e-14


def test_poisson_build_system_matches_tpufem():
    jm, tm = meshes(*MESH)
    A, b, boundary = jpoisson.build_system(jm)
    got_A, got_b, got_boundary = tpoisson.build_system(tm)
    np.testing.assert_array_equal(got_A, np.asarray(A))
    np.testing.assert_array_equal(got_b, np.asarray(b))
    np.testing.assert_array_equal(got_boundary.dirichlet, boundary.dirichlet)


@functools.lru_cache(maxsize=None)
def jax_poisson(**kw):
    f, res = jpoisson.solve(meshes(*MESH)[0], jpoisson.PoissonConfig(**kw))
    return np.asarray(f), float(res)


@functools.lru_cache(maxsize=None)
def port_poisson(**kw):
    f, res = tpoisson.solve(meshes(*MESH)[1], tpoisson.PoissonConfig(**kw), device=CPU)
    return f.numpy(), float(res)


@pytest.mark.parametrize("solver", ["lu", "inverse"])
def test_poisson_dense_matches_tpufem_and_oracle(solver):
    """1e-12 of tpufem (measured 2.8e-16 lu, 1.1e-16 inverse) and 1e-10
    of the NumPy oracle (3.2e-16, 2.8e-16; tpufem's own bound is 1e-8);
    residual < 1e-8."""
    jm, _ = meshes(*MESH)
    f, res = port_poisson(solver=solver)
    assert rel(f, jax_poisson(solver=solver)[0]) <= 1e-12
    f_ref, _, _ = numpy_ref.poisson_solve(jm.coords, jm.tris, jm.markers)
    assert rel(f, f_ref) <= 1e-10
    assert res < 1e-8


@pytest.mark.parametrize("precond", ["jacobi", "twolevel"])
def test_poisson_cg_matches_dense_and_tpufem(precond):
    """BiCGStab at tol 1e-10 within 1e-10 of the dense LU (measured 6.1e-12
    jacobi, 4.3e-12 two-level) and of tpufem's solve_cg (5.4e-11 jacobi:
    tpufem's stencil storage sums in another order and stops at another
    iteration; 2.5e-16 two-level)."""
    f, res = port_poisson(solver="cg", cg_precond=precond)
    assert rel(f, port_poisson(solver="lu")[0]) <= 1e-10
    assert rel(f, jax_poisson(solver="cg", cg_precond=precond)[0]) <= 1e-10
    assert res < 1e-8


def test_poisson_cg_on_a_pad_hole_mesh_matches_tpufem():
    """The runners' ring-in-grid mesh: its dummy nodes (marker −1) have
    zero rows and no load, and the two-level coarse correction writes its
    aggregate's value into them in both packages (|f| up to 0.23): 1e-12
    relative over every node (measured 4.3e-16)."""
    jm, tm = meshes(24, 24, pad_hole=True)
    cfg = dict(solver="cg", cg_tol=1e-10)
    want, _ = jpoisson.solve(jm, jpoisson.PoissonConfig(**cfg))
    got, res = tpoisson.solve(tm, tpoisson.PoissonConfig(**cfg), device=CPU)
    assert rel(got.numpy(), np.asarray(want)) <= 1e-12
    assert float(res) < 1e-8


def test_poisson_f32_tracks_f64():
    """The f32 CG (tol 1e-6) within 1e-4 of the f64 dense solve, tpufem's
    f32 tolerance for heat (measured 4.3e-7)."""
    f32, _ = port_poisson(solver="cg", precision="f32", cg_tol=1e-6)
    assert f32.dtype == np.float32
    assert rel(f32, port_poisson(solver="lu")[0]) <= 1e-4


@functools.lru_cache(maxsize=None)
def jax_heat(**kw):
    u, maxu = jheat.run(meshes(*MESH)[0], jheat.HeatConfig(steps=HEAT_STEPS, **kw))
    return np.asarray(u), np.asarray(maxu)


@functools.lru_cache(maxsize=None)
def port_heat(**kw):
    u, maxu = theat.run(meshes(*MESH)[1], theat.HeatConfig(steps=HEAT_STEPS, **kw), device=CPU)
    return u.numpy(), maxu.numpy()


@pytest.mark.parametrize("solver", ["lu", "inverse"])
def test_heat_dense_matches_tpufem_and_oracle(solver):
    """50 steps: 1e-12 of tpufem (measured 4.8e-16 lu, 3.1e-16 inverse),
    max|u| per step equal, 1e-10 of the NumPy oracle (3.2e-16, 8.7e-16)."""
    jm, _ = meshes(*MESH)
    u, maxu = port_heat(solver=solver)
    want_u, want_max = jax_heat(solver=solver)
    assert rel(u, want_u) <= 1e-12
    np.testing.assert_allclose(maxu, want_max, rtol=1e-12)
    assert maxu.shape == (HEAT_STEPS,)
    u_ref = numpy_ref.heat_run(jm.coords, jm.tris, jm.markers, steps=HEAT_STEPS)
    assert rel(u, u_ref) <= 1e-10


def test_heat_cg_matches_dense_and_tpufem():
    """BiCGStab on I + dt·K_mod, warm-started, tol 1e-10: within 3e-10 of
    the dense LU trajectory over 50 steps (measured 2.5e-10, as tpufem's
    own CG reads) and 1e-12 of tpufem's CG (5.5e-17)."""
    u, maxu = port_heat(solver="cg")
    assert rel(u, port_heat(solver="lu")[0]) <= 3e-10
    assert rel(u, jax_heat(solver="cg")[0]) <= 1e-12
    assert abs(float(maxu[-1]) - 1.0) < 1e-6


@pytest.mark.parametrize("solver", ["lu", "cg"])
def test_heat_f32_tracks_f64(solver):
    """f32 within 1e-4 of f64 over 50 steps, tpufem's bound (measured
    7.8e-8 dense inverse, 5.0e-8 CG)."""
    u32, _ = port_heat(solver=solver, precision="f32")
    assert u32.dtype == np.float32
    assert rel(u32, port_heat(solver="lu")[0]) <= 1e-4


@pytest.mark.parametrize("solver", ["lu", "inverse"])
def test_heat_from_tpufem_arrays(solver):
    """The port stepping tpufem's own factored system (``interop``): 1e-12
    of tpufem's run (measured 4.8e-16 lu, 3.1e-16 inverse)."""
    jm, tm = meshes(*MESH)
    jp = jheat.HeatProblem.build(jm, jheat.HeatConfig(solver=solver))
    arrays = {f"boundary.{k}": getattr(jp.boundary, k) for k in
              ("walls", "inner", "dirichlet", "interior", "masters", "slaves")}
    arrays["dirichlet_values"] = np.asarray(jp.dirichlet_values)
    if solver == "lu":
        arrays.update({"solver.lu": np.asarray(jp.solver.lu),
                       "solver.piv": np.asarray(jp.solver.piv)})
    else:
        arrays["solver.inv"] = np.asarray(jp.solver.inv)
    problem = interop.heat_problem_from_numpy(arrays, theat.HeatConfig(solver=solver), CPU)
    u, _ = theat.run_problem(problem, theat.initial_state(problem, tm.n_nodes), HEAT_STEPS)
    assert rel(u.numpy(), jax_heat(solver=solver)[0]) <= 1e-12


@pytest.mark.parametrize("workload", ["poisson", "heat"])
def test_bench_large_runners_meet_their_gates(workload):
    """The runners at n_side=24 on the CPU under tpufem's gates (they raise
    on a failed gate), on the stencil, as tpufem's take it on pad_hole
    meshes."""
    if workload == "poisson":
        row = bench_large.run_poisson_large(24, 24, device=CPU)
        assert row["res_rel"] < 1e-4 and row["bc_err_max"] < 1e-3
        assert row["iterations"] > 0 and row["storage"] == "StencilOperator"
    else:
        row = bench_large.run_heat_large(24, 24, steps=10, device=CPU)
        assert -1e-2 <= row["u_range"][0] and row["u_range"][1] <= 1.0 + 1e-2
        assert row["iterations_per_step"]["warm"] > 0 and row["storage"] == "StencilOperator"
    assert row["n_nodes"] == 24 * 24
