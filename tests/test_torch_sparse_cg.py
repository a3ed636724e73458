"""The scale regime's sparse pieces against tpufem's: CSR assembly, the CSR
div/grad operators, the two CG loops, the two-level set-up and the CSR-storage
solvers, on a generated pad_hole mesh with seeded inputs, at f64."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem import bc as jbc
from tpufem.ops import assembly as jassembly
from tpufem.ops import calculus as jcalculus
from tpufem.solve import matfree as jmatfree
from tpufem.solve import twolevel as jtwolevel
from tpufem.solve.pressure import owner_map
from tpufem_torch import bc as tbc
from tpufem_torch.ops import assembly as tassembly
from tpufem_torch.ops import calculus as tcalculus
from tpufem_torch.solve import cg as tcg
from tpufem_torch.solve import matfree as tmatfree
from tpufem_torch.solve import twolevel as ttwolevel

from tests._torch_parity import meshes, rel

torch.set_num_threads(2)

jcg = importlib.import_module("tpufem.solve.cg")  # tpufem.solve re-exports a function `cg`
MESH = (20, 24)


def _csr_pair(merged: bool = False):
    jm, tm = meshes(*MESH, pad_hole=True)
    if merged:
        b = jbc.ChannelBoundary.build(jm)
        owner = owner_map(jm.n_nodes, b.masters, b.slaves)
        jm = dataclasses.replace(jm, tris=owner[jm.tris].astype(np.int32))
        tm = dataclasses.replace(tm, tris=owner[tm.tris].astype(np.int32))
    ke_j = jassembly.element_stiffness(meshes(*MESH, pad_hole=True)[0])
    ke_t = tassembly.element_stiffness(meshes(*MESH, pad_hole=True)[1])
    return jassembly.assemble_csr(jm, ke_j), tassembly.assemble_csr(tm, ke_t)


def _assert_same_csr(j, t):
    np.testing.assert_array_equal(t.indptr, np.asarray(j.indptr))
    np.testing.assert_array_equal(t.indices, np.asarray(j.indices))
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    assert t.shape == tuple(j.shape)


@pytest.mark.parametrize("merged", [False, True])
def test_assemble_csr_matches_tpufem(merged):
    j, t = _csr_pair(merged)
    _assert_same_csr(j, t)
    x = np.random.default_rng(0).standard_normal(t.shape[0])
    np.testing.assert_allclose(t.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(j.matvec(jnp.asarray(x))), rtol=0, atol=1e-13)
    np.testing.assert_allclose(t.diag().numpy(), np.asarray(j.diag()), rtol=0, atol=1e-15)


def test_divergence_csr_operators_match_tpufem():
    jm, tm = meshes(*MESH, pad_hole=True)
    for j, t in zip(jcalculus.divergence_csr_operators(jm),
                    tcalculus.divergence_csr_operators(tm)):
        _assert_same_csr(j, t)
    # and they apply the dense lumped operators
    x = np.random.default_rng(1).standard_normal(tm.n_nodes)
    for d, t in zip(tcalculus.divergence_matrices(tm), tcalculus.divergence_csr_operators(tm)):
        np.testing.assert_allclose(t.matvec(torch.as_tensor(x)).numpy(), d @ x, rtol=0, atol=1e-12)


def _spd_system():
    """The merged pressure operator on the active dofs, its Jacobi inverse
    diagonal and a seeded right-hand side orthogonal to the nullspace."""
    j, t = _csr_pair(merged=True)
    jm, _ = meshes(*MESH, pad_hole=True)
    b = jbc.ChannelBoundary.build(jm)
    owner = owner_map(jm.n_nodes, b.masters, b.slaves)
    ml = np.asarray(jassembly.lumped_mass(jm))
    act = ((owner == np.arange(jm.n_nodes)) & (ml > 0)).astype(np.float64)
    rhs = np.random.default_rng(3).standard_normal(jm.n_nodes) * act
    rhs -= (rhs @ act) / (act @ act) * act
    return j, t, act, rhs


@pytest.mark.parametrize("loop", ["cg", "cg_fixed"])
def test_cg_loops_match_tpufem(loop):
    j, t, act, rhs = _spd_system()
    x0 = 0.1 * np.random.default_rng(4).standard_normal(rhs.shape[0])
    dj, dt = np.asarray(j.diag()), t.diag()
    inv_j = jnp.where(dj > 0, 1.0 / jnp.where(dj > 0, dj, 1.0), 1.0)
    inv_t = torch.where(dt > 0, 1.0 / torch.where(dt > 0, dt, torch.ones_like(dt)),
                        torch.ones_like(dt))
    kw = dict(deflate=True)
    if loop == "cg":
        xj, (kj, _) = jcg.cg(j.matvec, jnp.asarray(rhs), jnp.asarray(x0), tol=1e-8, maxiter=80,
                             precond=lambda r: inv_j * r, deflate_weights=jnp.asarray(act), **kw)
        xt, (kt, _) = tcg.cg(t.matvec, torch.as_tensor(rhs), torch.as_tensor(x0), tol=1e-8,
                             maxiter=80, precond=lambda r: inv_t * r,
                             deflate_weights=torch.as_tensor(act), **kw)
        assert int(kj) == kt
    else:
        xj, _ = jcg.cg_fixed(j.matvec, jnp.asarray(rhs), jnp.asarray(x0), iters=40,
                             precond=lambda r: inv_j * r, deflate_weights=jnp.asarray(act), **kw)
        xt, _ = tcg.cg_fixed(t.matvec, torch.as_tensor(rhs), torch.as_tensor(x0), iters=40,
                             precond=lambda r: inv_t * r, deflate_weights=torch.as_tensor(act),
                             **kw)
    assert rel(xt.numpy(), np.asarray(xj)) <= 1e-12


def test_estimate_lmax_and_twolevel_match_tpufem():
    j, t, _, _ = _spd_system()
    jm, _ = meshes(*MESH, pad_hole=True)
    dj, dt = np.asarray(j.diag()), t.diag()
    inv_j = jnp.where(dj > 0, 1.0 / jnp.where(dj > 0, dj, 1.0), 1.0)
    inv_t = torch.where(dt > 0, 1.0 / torch.where(dt > 0, dt, torch.ones_like(dt)),
                        torch.ones_like(dt))
    lj = jcg.estimate_lmax(j.matvec, inv_j, jm.n_nodes)
    lt = tcg.estimate_lmax(t.matvec, inv_t, jm.n_nodes)
    assert abs(lt - lj) <= 1e-12 * lj
    tj = jtwolevel.build_twolevel(j, np.asarray(jm.coords), j.matvec, inv_j, target_coarse=64)
    tt = ttwolevel.build_twolevel(t, np.asarray(jm.coords), t.matvec, inv_t, target_coarse=64)
    np.testing.assert_array_equal(tt.agg.numpy(), np.asarray(tj.agg))
    np.testing.assert_array_equal(tt.order.numpy(), np.asarray(tj.order))
    assert rel(tt.ac_inv.numpy(), np.asarray(tj.ac_inv)) <= 1e-12
    assert abs(tt.omega - tj.omega) <= 1e-12 * tj.omega
    r = np.random.default_rng(5).standard_normal(jm.n_nodes)
    Mj = jtwolevel.twolevel_preconditioner(j.matvec, inv_j, tj)
    Mt = ttwolevel.twolevel_preconditioner(t.matvec, inv_t, tt)
    assert rel(Mt(torch.as_tensor(r)).numpy(), np.asarray(Mj(jnp.asarray(r)))) <= 1e-12


def _matfree_solvers(precond: str, tol: float):
    """tpufem's and the port's ViscousCG and PressureCG on the same operators."""
    jm, tm = meshes(*MESH, pad_hole=True)
    bj, bt = jbc.ChannelBoundary.build(jm), tbc.ChannelBoundary.build(tm)
    kj, kt = _csr_pair()
    kmj, kmt, act, _ = _spd_system()
    ml = np.array(jassembly.lumped_mass(jm))
    mask = np.ones(jm.n_nodes)
    mask[bj.dirichlet] = 0.0
    jv = jmatfree.ViscousCG(K=kj, interior_mask=jnp.asarray(mask), dt_nu=0.01, iters=30, tol=tol)
    tv = tmatfree.ViscousCG(K=kt, interior_mask=torch.as_tensor(mask), dt_nu=0.01, iters=30,
                            tol=tol)
    tl_j = tl_t = None
    lmax = 0.0
    if precond == "twolevel":
        dj, dt = np.asarray(kmj.diag()), kmt.diag()
        inv_j = jnp.where(dj > 0, 1.0 / jnp.where(dj > 0, dj, 1.0), 1.0)
        inv_t = torch.where(dt > 0, 1.0 / torch.where(dt > 0, dt, torch.ones_like(dt)),
                            torch.ones_like(dt))
        lmax = jcg.estimate_lmax(kmj.matvec, inv_j, jm.n_nodes)
        tl_j = jtwolevel.build_twolevel(kmj, np.asarray(jm.coords), kmj.matvec, inv_j,
                                        target_coarse=64, lmax=lmax)
        tl_t = ttwolevel.build_twolevel(kmt, np.asarray(jm.coords), kmt.matvec, inv_t,
                                        target_coarse=64, lmax=lmax)
    common = dict(masters=bj.masters, slaves=bj.slaves, iters=60, precond=precond, lmax=lmax,
                  tol=tol)
    jp = jmatfree.PressureCG(K_merged=kmj, m_lumped=jnp.asarray(ml),
                             active_mask=jnp.asarray(act), twolevel=tl_j, **common)
    tp = tmatfree.PressureCG(K_merged=kmt, m_lumped=torch.as_tensor(ml),
                             active_mask=torch.as_tensor(act), twolevel=tl_t, **common)
    assert np.array_equal(bt.masters, bj.masters)
    return jv, tv, jp, tp


@pytest.mark.parametrize("tol", [0.0, 1e-5])
@pytest.mark.parametrize("precond", ["jacobi", "twolevel"])
def test_matfree_solvers_match_tpufem(precond, tol):
    jv, tv, jp, tp = _matfree_solvers(precond, tol)
    rng = np.random.default_rng(6)
    n = tv.interior_mask.shape[0]
    b2, x2 = rng.standard_normal((n, 2)), 0.1 * rng.standard_normal((n, 2))
    got = tv.solve(torch.as_tensor(b2), torch.as_tensor(x2)).numpy()
    assert rel(got, np.asarray(jv.solve(jnp.asarray(b2), jnp.asarray(x2)))) <= 1e-11
    b1, x1 = rng.standard_normal(n), 0.1 * rng.standard_normal(n)
    got = tp.solve(torch.as_tensor(b1), torch.as_tensor(x1)).numpy()
    assert rel(got, np.asarray(jp.solve(jnp.asarray(b1), jnp.asarray(x1)))) <= 1e-11


def test_pressure_pin_refused():
    _, _, _, tp = _matfree_solvers("jacobi", 0.0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        dataclasses.replace(tp, pin=3)
