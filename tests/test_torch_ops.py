"""tpufem_torch operators against tpufem at float64: element matrices,
dense assembly, lumped mass, div/grad (segment-sum and dense), the merged
pressure matrix, BC matrix surgery, boundary values and dense solvers.
Relative tolerance 1e-12: the same arithmetic, summed in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem import bc as jbc
from tpufem.ops import assembly as jasm
from tpufem.ops import calculus as jcalc
from tpufem.solve import dense as jdense
from tpufem.solve import pressure as jpressure
from tpufem_torch import bc as tbc
from tpufem_torch.ops import assembly as tasm
from tpufem_torch.ops import calculus as tcalc
from tpufem_torch.solve import dense as tdense
from tpufem_torch.solve import pressure as tpressure

from tests._torch_parity import meshes, rel

torch.set_num_threads(2)

TOL = 1e-12
MESHES = [(12, 16), (20, 24)]


@pytest.mark.parametrize("n_side,n_circle", MESHES)
@pytest.mark.parametrize("which", ["stiffness", "stiffness_signed", "mass"])
def test_element_matrices_and_dense_assembly(n_side, n_circle, which):
    jm, tm = meshes(n_side, n_circle)
    if which == "mass":
        je, te = jasm.element_mass(jm), tasm.element_mass(tm)
    else:
        signed = which == "stiffness_signed"
        je = jasm.element_stiffness(jm, signed=signed)
        te = tasm.element_stiffness(tm, signed=signed)
    assert te.dtype == torch.float64
    assert rel(te.numpy(), je) < TOL
    assert rel(tasm.assemble_dense(tm, te).numpy(), jasm.assemble_dense(jm, je)) < TOL


@pytest.mark.parametrize("n_side,n_circle", MESHES)
def test_lumped_mass(n_side, n_circle):
    jm, tm = meshes(n_side, n_circle)
    assert rel(tasm.lumped_mass(tm).numpy(), jasm.lumped_mass(jm)) < TOL


@pytest.mark.parametrize("n_side,n_circle", MESHES)
def test_divergence_and_gradient(n_side, n_circle):
    jm, tm = meshes(n_side, n_circle)
    rng = np.random.default_rng(n_side)
    u = rng.standard_normal((jm.n_nodes, 2))
    p = rng.standard_normal(jm.n_nodes)
    d_t = tcalc.divergence(tm, torch.as_tensor(u)).numpy()
    g_t = tcalc.gradient(tm, torch.as_tensor(p)).numpy()
    assert rel(d_t, jcalc.divergence(jm, jnp.asarray(u))) < TOL
    assert rel(g_t, jcalc.gradient(jm, jnp.asarray(p))) < TOL
    dx, dy = tcalc.divergence_matrices(tm)
    jdx, jdy = jcalc.divergence_matrices(jm)
    assert rel(dx, jdx) < TOL and rel(dy, jdy) < TOL
    # the dense form equals the segment-sum form (tests/test_stokes_fast.py gate)
    np.testing.assert_allclose(dx @ u[:, 0] + dy @ u[:, 1], d_t, atol=1e-11)
    np.testing.assert_allclose(np.stack([dx @ p, dy @ p], axis=1), g_t, atol=1e-11)


@pytest.mark.parametrize("n_side,n_circle", MESHES)
def test_vorticity_and_gradient_matrices(n_side, n_circle):
    """The lumped vorticity, and ``gradient_matrices``: the dense gradient
    operators, equal to the segment-sum gradient."""
    jm, tm = meshes(n_side, n_circle)
    rng = np.random.default_rng(n_side + 1)
    u = rng.standard_normal((jm.n_nodes, 2))
    p = rng.standard_normal(jm.n_nodes)
    w_t = tcalc.vorticity(tm, torch.as_tensor(u))
    assert w_t.dtype == torch.float64
    assert rel(w_t.numpy(), jcalc.vorticity(jm, jnp.asarray(u))) < 1e-13
    gx, gy = tcalc.gradient_matrices(tm)
    jgx, jgy = jcalc.gradient_matrices(jm)
    assert rel(gx, jgx) < 1e-13 and rel(gy, jgy) < 1e-13
    g_t = tcalc.gradient(tm, torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(np.stack([gx @ p, gy @ p], axis=1), g_t, atol=1e-11)


def test_ops_namespace_exports_tpufems_names():
    """``tpufem_torch.ops`` exports every name of tpufem's ``ops``."""
    import tpufem.ops as jops
    import tpufem_torch.ops as tops

    assert set(jops.__all__) - set(tops.__all__) == set()
    assert all(callable(getattr(tops, name)) for name in tops.__all__)


@pytest.mark.parametrize("n_side,n_circle", MESHES)
def test_merged_pressure_matrix(n_side, n_circle):
    jm, tm = meshes(n_side, n_circle)
    b = jbc.ChannelBoundary.build(jm)
    ml = np.asarray(jasm.lumped_mass(jm))
    a_t = tpressure.merged_pressure_apply_matrix(tm, ml, b.masters, b.slaves)
    a_j = jpressure.merged_pressure_apply_matrix(jm, ml, b.masters, b.slaves)
    assert rel(a_t, a_j) < TOL


def test_bc_matrix_surgery_and_values():
    jm, tm = meshes(12, 16)
    b = jbc.ChannelBoundary.build(jm)
    K = np.asarray(jasm.assemble_dense(jm, jasm.element_stiffness(jm)))
    np.testing.assert_array_equal(
        tbc.dirichlet_rows_cols(K, b.dirichlet), jbc.dirichlet_rows_cols(jnp.asarray(K), b.dirichlet)
    )
    np.testing.assert_array_equal(
        tbc.periodic_penalty(K, b.masters, b.slaves),
        jbc.periodic_penalty(jnp.asarray(K), b.masters, b.slaves),
    )
    np.testing.assert_array_equal(
        tbc.periodic_penalty_device(torch.tensor(K), torch.as_tensor(b.masters, dtype=torch.int64),
                                    torch.as_tensor(b.slaves, dtype=torch.int64)).numpy(),
        jbc.periodic_penalty(jnp.asarray(K), b.masters, b.slaves),
    )
    np.testing.assert_array_equal(
        tbc.squirmer_values(tm.coords, b.inner, B1=-2.0, B2=3.0),
        jbc.squirmer_values(jm.coords, b.inner, B1=-2.0, B2=3.0),
    )
    np.testing.assert_array_equal(
        tbc.rotating_cylinder_values(tm.coords, b.inner, omega=4.0),
        jbc.rotating_cylinder_values(jm.coords, b.inner, omega=4.0),
    )
    rng = np.random.default_rng(3)
    u = rng.standard_normal((jm.n_nodes, 2))
    idx = {k: torch.as_tensor(v, dtype=torch.int64) for k, v in
           (("m", b.masters), ("s", b.slaves), ("w", b.walls))}
    np.testing.assert_array_equal(
        tbc.apply_periodic_field(torch.as_tensor(u), idx["m"], idx["s"]).numpy(),
        jbc.apply_periodic_field(jnp.asarray(u), b.masters, b.slaves),
    )
    np.testing.assert_array_equal(
        tbc.apply_dirichlet_field(torch.as_tensor(u), idx["w"], [0.5, -1.0]).numpy(),
        jbc.apply_dirichlet_field(jnp.asarray(u), b.walls, jnp.asarray([0.5, -1.0])),
    )


@pytest.mark.parametrize("method", ["lu", "inverse"])
def test_dense_solvers(method):
    jm, _ = meshes(12, 16)
    b = jbc.ChannelBoundary.build(jm)
    K = np.asarray(jasm.assemble_dense(jm, jasm.element_stiffness(jm)))
    A = np.asarray(jbc.dirichlet_rows_cols(jnp.asarray(np.eye(jm.n_nodes) + 0.01 * K), b.dirichlet))
    rng = np.random.default_rng(7)
    rhs = rng.standard_normal((jm.n_nodes, 2))
    ts = tdense.make_dense_solver(A, method)
    js = jdense.make_dense_solver(A, method)
    want = np.asarray(js.solve(jnp.asarray(rhs)))
    assert rel(ts.solve(torch.as_tensor(rhs)).numpy(), want) < TOL
    assert rel(ts.solve(torch.as_tensor(rhs[:, 0])).numpy(), want[:, 0]) < TOL
    if method == "lu":  # LAPACK's 1-based pivots on the torch side
        np.testing.assert_array_equal(ts.piv.numpy(), np.asarray(js.piv) + 1)
