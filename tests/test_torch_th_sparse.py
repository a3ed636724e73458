"""The sparse and grid Taylor–Hood engines of the port
(``tpufem_torch.workloads.th_sparse``) against tpufem's, f64 on the CPU
unless said: the CSR assembly of element blocks, ``permute_csr``, the
consistent divergence, the operators of ``SparseTHProblem.build``, the CSR
engine's steps and runs (from the port's own build and from tpufem's
operators carried across by ``interop``, Jacobi and two-level inner
preconditioners), the steady Uzawa solve against the dense Taylor–Hood
solve, the grid engine (the kernels' plain versions) against tpufem's CSR
engine, ``vel_restarts`` at f32 and ``bench_large.run_th_sparse``.  Each
tolerance has the value measured on the CPU beside it."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from tpufem.mesh.p2 import p2_refine as jp2_refine
from tpufem.ops import assembly as jassembly
from tpufem.ops import calculus as jcalculus
from tpufem.ops import sparse as jsparse
from tpufem.workloads import th_sparse as jth
from tpufem_torch import bench_large, interop
from tpufem_torch.mesh.p2 import p2_refine as tp2_refine
from tpufem_torch.ops import assembly as tassembly
from tpufem_torch.ops import calculus as tcalculus
from tpufem_torch.ops import sparse as tsparse
from tpufem_torch.workloads import navier_stokes as tns
from tpufem_torch.workloads import th_sparse as tth

from tests._torch_parity import meshes, rel, sparse_th_arrays

torch.set_num_threads(2)

CPU = torch.device("cpu")
SNAP = dict(snap_center=(0.5, 0.5), snap_radius=0.25)
MESH = (12, 12)  # P2-refined: 440 velocity nodes, 124 pressure dofs, 1,004 dofs
STEPS = 5
# tpufem's grid-engine test configuration (tests/test_th_sparse.py)
GRID_CFG = dict(dt=0.01, nu=1.0, iters_inner=60, iters_outer=40, iters_plap=20)


@functools.lru_cache(maxsize=None)
def p2_pair(n_side: int = MESH[0], n_circle: int = MESH[1]):
    """(tpufem's, the port's) snapped P2 refinement of a generated annulus."""
    jm, tm = meshes(n_side, n_circle)
    return jp2_refine(jm, **SNAP), tp2_refine(tm, **SNAP)


@functools.lru_cache(maxsize=None)
def jax_problem(precond: str = "jacobi", **kw):
    return jth.SparseTHProblem.build(p2_pair()[0],
                                     jth.SparseTHConfig(precond_inner=precond, **kw))


@functools.lru_cache(maxsize=None)
def jax_run(precond: str = "jacobi", steps: int = STEPS, **kw):
    u, p, metrics = jth.run(jax_problem(precond, **kw), steps=steps)
    return np.asarray(u), np.asarray(p), {k: np.asarray(v) for k, v in metrics.items()}


def port_problem(source: str, precond: str = "jacobi", **kw):
    cfg = tth.SparseTHConfig(precond_inner=precond, **kw)
    tm = p2_pair()[1]
    if source == "interop":
        return interop.sparse_th_problem_from_numpy(
            sparse_th_arrays(jax_problem(precond, **kw)), tm, cfg, CPU)
    return tth.SparseTHProblem.build(tm, cfg, device=CPU)


@pytest.mark.parametrize("block", ["K2", "Bx", "BxT"])
def test_assemble_csr_conn_matches_tpufem(block):
    """Pattern array-equal, values within 1e-15 relative (measured 0)."""
    jm, tm = p2_pair()
    ke, _, bex, _, corners, p_of_node = tns._th_element_matrices(tm)
    tris6 = tm.tris_p2.astype(np.int64)
    pconn = p_of_node[tris6[:, :3]]
    n2, n1 = tm.n_nodes, len(corners)
    rows, cols, elem, shape = {
        "K2": (tris6, tris6, ke, (n2, n2)),
        "Bx": (pconn, tris6, bex, (n1, n2)),
        "BxT": (tris6, pconn, np.swapaxes(bex, 1, 2), (n2, n1)),
    }[block]
    want = jassembly.assemble_csr_conn(rows, cols, elem, shape)
    got = tassembly.assemble_csr_conn(rows, cols, elem, shape)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.shape == tuple(want.shape)
    assert rel(got.data.numpy(), np.asarray(want.data)) <= 1e-15


def test_permute_csr_matches_tpufem():
    """Onto a larger raster with empty dummy rows: array-equal."""
    _, tm = p2_pair()
    ke = tns._th_element_matrices(tm)[0]
    tris6 = tm.tris_p2.astype(np.int64)
    n = tm.n_nodes
    jop = jassembly.assemble_csr_conn(tris6, tris6, ke, (n, n))
    top = tassembly.assemble_csr_conn(tris6, tris6, ke, (n, n))
    perm = np.random.default_rng(3).permutation(n + 89)[:n]
    shape = (n + 89, n + 89)
    want = jsparse.permute_csr(jop, perm, perm, shape)
    got = tsparse.permute_csr(top, perm, perm, shape)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert got.data.dtype == torch.float64 and got.shape == shape


def test_column_matvec_sums_each_column_as_its_own_matvec():
    """An (N, k) block gives the 1-D matvec's sums column by column
    (bit-equal on the CPU), at f64 and with float32 values."""
    problem = port_problem("build")
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((problem.n2, 3)))
    for op in (problem.K2, problem.BxT.astype(torch.float32)):
        xx = x[: op.shape[1]].to(op.data.dtype)
        block = op.matvec(xx)
        for c in range(3):
            assert torch.equal(block[:, c], op.matvec(xx[:, c].contiguous()))


def test_consistent_divergence_rhs_matches_tpufem():
    """1e-15 relative (measured 1.0e-16)."""
    jm, tm = meshes(20, 24)
    u = np.random.default_rng(5).standard_normal((tm.n_nodes, 2))
    want = np.asarray(jcalculus.consistent_divergence_rhs(jm, u))
    got = tcalculus.consistent_divergence_rhs(tm, torch.as_tensor(u))
    assert rel(got.numpy(), want) <= 1e-15


def test_build_matches_tpufem():
    """Operators pattern- and value-equal (measured 0), host arrays equal."""
    jp, tp = jax_problem(), port_problem("build")
    for name in tth.OPERATORS:
        want, got = getattr(jp, name), getattr(tp, name)
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    for name in ("mp_lumped", "vel_mask", "u_bc"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))
    np.testing.assert_array_equal(tp.corners, jp.corners)
    np.testing.assert_array_equal(tp.pmesh.tris, jp.pmesh.tris)


def test_twolevel_velocity_preconditioner_matches_tpufem():
    """The aggregation and ω of ``precond_inner="twolevel"``: equal, and ω
    within 1e-12 (the power iteration's order; measured 0)."""
    jt, tt = jax_problem("twolevel").tl_vel, port_problem("build", "twolevel").tl_vel
    np.testing.assert_array_equal(tt.agg.numpy(), np.asarray(jt.agg))
    assert rel(tt.ac_inv.numpy(), np.asarray(jt.ac_inv)) <= 1e-12
    assert abs(tt.omega - float(jt.omega)) <= 1e-12 * abs(float(jt.omega))


def test_th_sparse_step_matches_tpufem():
    """One step from a seeded state and warm start: 1e-10 relative in u and
    p (measured 5.5e-16 and 3.4e-16)."""
    jp, tp = jax_problem(), port_problem("build")
    rng = np.random.default_rng(6)
    u = np.asarray(jp.u_bc) + 0.1 * rng.standard_normal((tp.n2, 2)) * np.asarray(jp.vel_mask)[:, None]
    p0 = rng.standard_normal(tp.n1)
    uw, pw, mw = jth.th_sparse_step(jp, u, p0)
    ug, pg, mg = tth.th_sparse_step(tp, torch.as_tensor(u), torch.as_tensor(p0))
    assert rel(ug.numpy(), np.asarray(uw)) <= 1e-10
    assert rel(pg.numpy(), np.asarray(pw)) <= 1e-10
    for k in mw:
        assert float(mg[k]) == pytest.approx(float(mw[k]), rel=1e-6, abs=1e-12), k


@pytest.mark.parametrize("source", ["build", "interop"])
@pytest.mark.parametrize("precond", ["jacobi", "twolevel"])
def test_run_matches_tpufem(source, precond):
    """``run`` over 5 steps: 1e-10 relative in u and p (measured ≤ 3.9e-16
    and ≤ 3.1e-16), the stacked metrics within 1e-10 relative or 1e-12
    absolute (measured ≤ 5.8e-15 absolute; div_weak_max is roundoff,
    ~2e-14)."""
    u_want, p_want, m_want = jax_run(precond)
    u, p, metrics = tth.run(port_problem(source, precond), steps=STEPS)
    assert rel(u.numpy(), u_want) <= 1e-10
    assert rel(p.numpy(), p_want) <= 1e-10
    for k, v in m_want.items():
        assert metrics[k].shape == v.shape
        np.testing.assert_allclose(metrics[k].numpy(), v, rtol=1e-10, atol=1e-12, err_msg=k)


def test_run_host_loop_continues_a_state():
    """``host_loop=True``: the final metrics, and 2 + 3 steps through
    ``state`` equal 5 steps (bit-equal: the same device steps)."""
    tp = port_problem("build")
    u5, p5, m5 = tth.run(tp, steps=STEPS, host_loop=True)
    assert m5["max_u"].ndim == 0
    _, _, _, state = tth.run(tp, steps=2, host_loop=True, return_state=True)
    u, p, _ = tth.run(tp, steps=3, host_loop=True, state=state)
    assert torch.equal(u, u5) and torch.equal(p, p5)


def test_steady_solve_matches_dense_taylor_hood():
    """tpufem's check, at 200 inner and 40 outer iterations (its defaults
    400 and 80 take 28 s here and reach 1.1e-14): the matrix-free steady
    Uzawa solve against the dense LU ``solve_taylor_hood``, 1e-9 absolute
    in u (measured 7.1e-11) and p up to its mean 1e-7 (measured 7.2e-9),
    and against tpufem's steady solve, 1e-10 relative (measured 1.1e-15 at
    the defaults)."""
    _, tm = p2_pair()
    ud, pd, res = tns.solve_taylor_hood(tm, tns.TaylorHoodConfig(nu=1.0, B1=-2.0, B2=0.0),
                                        device=CPU)
    assert float(res) < 1e-10
    us, ps = tth.steady_solve(port_problem("build"), iters_inner=200, iters_outer=40)
    np.testing.assert_allclose(us.numpy(), ud.numpy(), atol=1e-9)
    np.testing.assert_allclose(ps.numpy() - ps.numpy().mean(), pd.numpy() - pd.numpy().mean(),
                               atol=1e-7)
    uj, _ = jth.steady_solve(jax_problem(), iters_inner=200, iters_outer=40)
    assert rel(us.numpy(), np.asarray(uj)) <= 1e-10


@functools.lru_cache(maxsize=None)
def grid_problem(source: str = "build", **kw):
    base = port_problem(source, **GRID_CFG)
    return tth.GridTHProblem.build(base, interpret=True, **kw)


def test_grid_engine_matches_tpufem_csr_engine():
    """tpufem's ``test_grid_th_engine_matches_csr_engine`` on the port: the
    grid engine (K2 and K3 plain, ``tol_inner=0``) against tpufem's CSR
    engine over 5 steps, 1e-6 max abs in u (measured 1.1e-10; the velocity
    operator's remainder is applied with tpufem's float32 rounding), and
    the weak divergence below 1e-6 (measured 8.5e-12)."""
    u_want, _, _ = jax_run("jacobi", **GRID_CFG)
    u, p, m = tth.run_grid(grid_problem(tol_inner=0.0), steps=STEPS)
    np.testing.assert_allclose(u.numpy(), u_want, atol=1e-6)
    assert u.shape == (p2_pair()[1].n_nodes, 2) and p.shape == (len(jax_problem().corners),)
    assert float(m["max_u"]) == pytest.approx(2.0, rel=1e-3)
    assert float(m["div_weak_max"]) < 1e-6


def test_grid_engine_from_interop_equals_own_build():
    """``GridTHProblem.build`` on the interop base gives the same step as
    on the port's own base (bit-equal: the same operators)."""
    a, b = grid_problem(tol_inner=0.0), grid_problem("interop", tol_inner=0.0)
    ua, pa, _ = tth.run_grid(a, steps=1)
    ub, pb, _ = tth.run_grid(b, steps=1)
    assert torch.equal(ua, ub) and torch.equal(pa, pb)


@pytest.mark.parametrize("n_side", [12, 20])
def test_grid_raster_is_the_lattice_width(n_side):
    """The P2 raster is the lattice width (the bottom edge's node count: 23
    and 39), not tpufem's 128-aligned TPU raster; the P1 raster is n_side;
    every operator splits onto at most 25 planes (24 offsets and the
    diagonal) plus a remainder."""
    _, tm = p2_pair(n_side, n_side)
    base = tth.SparseTHProblem.build(tm, tth.SparseTHConfig(**GRID_CFG), device=CPU)
    gp = tth.GridTHProblem.build(base, interpret=True)
    bottom = int((tm.coords[:, 1] < 1e-9).sum())
    assert gp.ns2 == bottom == 2 * n_side - 1
    assert gp.ns1 == n_side
    assert tth.raster_candidates(tm.coords)[0] == bottom
    assert len(gp.vel_solver.K.offsets) <= 25 and gp.vel_solver.K.n_rest > 0
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(gp.ns2 ** 2))
    a_csr = gp.vel_op_unmasked(x[:, None])[:, 0] - x
    dummies = torch.as_tensor(np.setdiff1d(np.arange(gp.ns2 ** 2), gp.perm2))
    a_csr[dummies] = 0.0
    got = gp.vel_solver.K.matvec(x)
    got[dummies] = 0.0
    assert rel(got.numpy(), a_csr.numpy()) <= 1e-15  # the split is exact at f64 off round32


class _Counting:
    """A solver whose ``solve`` counts its calls (the kernel launches a
    step would make on the card)."""

    def __init__(self, solver):
        self.solver, self.calls = solver, 0

    def solve(self, b, x0=None):
        self.calls += 1
        return self.solver.solve(b, x0)


@pytest.mark.parametrize("restarts,tol_outer", [(0, 0.0), (1, 0.0), (1, 1e-8)])
def test_grid_launch_invariant(restarts, tol_outer):
    """Per step K2 = (1 + vel_restarts)·(K3 + 2): one K3 for the first
    preconditioning and one an outer iteration, against K2 for the rhs, the
    initial residual, each outer iteration and the final velocity; with a
    tolerance the outer count varies and the invariant holds."""
    gp = grid_problem(tol_inner=1e-6)
    v, pl = _Counting(gp.vel_solver), _Counting(gp.plap_solver)
    gp = dataclasses.replace(gp, vel_solver=v, plap_solver=pl, tol_outer=tol_outer,
                             vel_restarts=restarts)
    u, p = gp.u_bc_g, torch.zeros(gp.ns1 ** 2, dtype=torch.float64)
    for _ in range(2):
        v.calls = pl.calls = 0
        u, p, _ = tth.th_grid_step(gp, u, p)
        assert v.calls == (1 + restarts) * (pl.calls + 2)
        if tol_outer == 0.0:
            assert pl.calls == GRID_CFG["iters_outer"] + 1


def test_grid_vel_restarts_break_f32_stagnation():
    """tpufem's ``test_grid_th_vel_restarts_break_f32_stagnation`` on the
    port (f32, plain K2/K3, tol_inner 1e-6, tol_outer 2e-6, 3 steps) at
    n_side 28, the smallest size that shows it (12: 1.5×, 20: 3.4×): one
    restart lowers the weak divergence ≥ 5× (measured 1.5e-6 → 1.5e-8)."""
    _, tm = p2_pair(28, 28)
    sp = tth.SparseTHProblem.build(tm, tth.SparseTHConfig(precision="f32", **GRID_CFG),
                                   device=CPU)
    divs = {}
    for vr in (0, 1):
        gp = tth.GridTHProblem.build(sp, interpret=True, tol_inner=1e-6, tol_outer=2e-6,
                                     vel_restarts=vr)
        u, _, m = tth.run_grid(gp, steps=3)
        assert float(m["max_u"]) == pytest.approx(2.0, rel=1e-3)
        divs[vr] = float(sp.b_apply(u).abs().max())
    assert divs[1] < divs[0] / 5, divs


def test_array_body_force():
    """An (N2, 2) nodal body force (as ``benchmarks/ns_th_xcheck_r5.py``
    passes): the CSR engine against tpufem's over 2 steps (1e-10 relative,
    measured 3.9e-16 over 3), and the grid engine against the CSR engine
    (1e-6 max abs, measured 6.5e-13 over 3, |u| ≤ 4.1e-4)."""
    jm, tm = p2_pair()
    force = 2.0 * np.stack([0.5 - tm.coords[:, 1], tm.coords[:, 0] - 0.5], axis=1)
    kw = dict(dt=1e-4, B1=0.0, B2=0.0, body_force=force, iters_inner=60, iters_outer=40,
              iters_plap=20)
    want, _, _ = jth.run(jth.SparseTHProblem.build(jm, jth.SparseTHConfig(**kw)), steps=2,
                         host_loop=True)
    base = tth.SparseTHProblem.build(tm, tth.SparseTHConfig(**kw), device=CPU)
    u, _, _ = tth.run(base, steps=2, host_loop=True)
    assert rel(u.numpy(), np.asarray(want)) <= 1e-10
    ug, _, _ = tth.run_grid(tth.GridTHProblem.build(base, interpret=True, tol_inner=0.0),
                            steps=2)
    np.testing.assert_allclose(ug.numpy(), u.numpy(), atol=1e-6)


@pytest.mark.parametrize("engine", ["csr", "grid"])
def test_run_th_sparse_toy(engine):
    """``bench_large.run_th_sparse`` on the CPU at n_side 12, 2 steps:
    tpufem's row keys and its gate (weak divergence ≪ the P1/P1
    projection's: ratio ≥ 10, measured 4e11 and 2e7 at 3 steps)."""
    row = bench_large.run_th_sparse(12, 12, 2, engine=engine, device=CPU)
    for key in ("n1", "n2", "dofs", "device", "steps", "steps_per_sec", "warm_steps_per_sec",
                "precision", "engine", "build_s", "compile_s", "max_u", "th_final_div_max",
                "th_div_weak_max", "p1p1_final_div_max", "p1p1_div_weak_max", "div_ratio_weak"):
        assert key in row, key
    assert row["dofs"] == 1004 and row["device"] == "cpu" and row["engine"] == engine
    assert row["steps_per_sec"] > 0 and row["div_ratio_weak"] > 10.0
    assert row["max_u"] == pytest.approx(2.0, rel=1e-2)
