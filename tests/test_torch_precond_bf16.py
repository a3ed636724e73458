"""K3's bf16 preconditioner planes (``cg_precond_bf16="on"``) and its
measurement probes: the port's plain versions against tpufem's
``grid_interpret`` on ``generate_annulus_mesh(16, 20, pad_hole=True)`` with
64 coarse nodes, at f64.

tpufem takes the bf16 planes only with grid storage, the two-level
preconditioner and its streamed regime (``cg_stream_diags="on"``, or
``"auto"`` from 360,000 nodes); everywhere else ``"on"`` changes nothing,
in both packages."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.workloads import stokes as jstokes
from tpufem_torch.ops import assembly as tassembly
from tpufem_torch.ops.gridop import GridOperator
from tpufem_torch.solve import grid_cg
from tpufem_torch.solve.pressure import owner_map
from tpufem_torch.workloads import stokes as tstokes

from tests._torch_parity import meshes, rel

torch.set_num_threads(2)

MESH = (16, 20)
CFG = dict(dt=0.01, nu=1.0, solver="cg", cg_iters_visc=30, cg_iters_pressure=60,
           cg_precond="twolevel", cg_warm_start=True, cg_tol_pressure=1e-5, cg_tol_visc=1e-5,
           precision="f64", cg_coarse_nodes=64, cg_stream_diags="on")
PRESSURE_ITERS = 15


@functools.lru_cache(maxsize=None)
def jax_problem(storage: str = "grid_interpret", **kw):
    jm, _ = meshes(*MESH, pad_hole=True)
    return jstokes.StokesProblem.build(jm, jstokes.StokesConfig(cg_storage=storage,
                                                                **{**CFG, **kw}))


@functools.lru_cache(maxsize=None)
def port_problem(storage: str = "grid_interpret", **kw):
    _, tm = meshes(*MESH, pad_hole=True)
    return tstokes.StokesProblem.build(tm, tstokes.StokesConfig(cg_storage=storage,
                                                                **{**CFG, **kw}), device="cpu")


def merged_csr(problem):
    mesh, b = problem.mesh, problem.boundary
    owner = owner_map(mesh.n_nodes, b.masters, b.slaves)
    merged = dataclasses.replace(mesh, tris=owner[mesh.tris].astype(np.int32))
    return tassembly.assemble_csr(merged, tassembly.element_stiffness(mesh))


def to_dense(K: GridOperator) -> np.ndarray:
    """The operator as an (N, N) matrix: each plane entry at its coupling,
    plus the remainder."""
    ns, n = K.ns, K.n
    A = np.zeros((n, n))
    iy, ix = np.divmod(np.arange(n), ns)
    diags = K.diags.double().numpy()
    for g, (dy, s) in enumerate(K.offsets):
        cols = ((iy + dy) % ns) * ns + (ix + s) % ns
        np.add.at(A, (np.arange(n), cols), diags[g].reshape(-1))
    np.add.at(A, (K.rest_tgt.numpy(), K.rest_src.numpy()), K.rest_vals.double().numpy())
    return A


def test_bf16_planes_equal_tpufems_entry_for_entry():
    """K̃ on the card split at this size (the same 15 planes as tpufem's
    streamed split) is tpufem's ``K.diags.astype(bfloat16)`` entry for
    entry, with tpufem's remainder at full width; on a split that puts
    tpufem's remainder on planes, those entries keep their values on K̃'s
    remainder."""
    jp, tp = jax_problem(cg_precond_bf16="on"), port_problem(cg_precond_bf16="on")
    jK, ps = jp.pressure_solver.K, tp.pressure_solver
    assert jp.pressure_solver.precond_bf16 and ps.K_pre is not None
    Kt = ps.K_pre
    assert Kt.offsets == jK.offsets == ps.K.offsets
    assert Kt.diags.dtype == torch.bfloat16 and Kt.rest_vals.dtype == torch.float64
    np.testing.assert_array_equal(Kt.diags.double().numpy(),
                                  np.asarray(jK.diags.astype(jnp.bfloat16).astype(jnp.float64)))
    assert torch.equal(Kt.rest_vals, ps.K.rest_vals) and torch.equal(Kt.rest_src, ps.K.rest_src)
    assert torch.equal(Kt.rest_tgt, ps.K.rest_tgt)

    csr = merged_csr(tp)
    every = GridOperator.build(csr, ps.K.ns, dtype=torch.float64, min_fill=0.0, max_offsets=64,
                               rest_budget_bytes=None)
    assert every.n_rest == 0
    moved = every.bf16_preconditioner(csr)
    assert moved.n_rest == ps.K.n_rest  # tpufem's full-width entries, off the planes
    np.testing.assert_array_equal(to_dense(moved), to_dense(Kt))


def test_plain_k3_matches_tpufem_streamed_on():
    """15 fixed pressure iterations: the port's plain K3 with the bf16
    planes against tpufem's interpreted streamed kernel, on one rhs; "on"
    and "off" part by far more than the tolerance."""
    b = np.random.default_rng(3).standard_normal(port_problem().mesh.n_nodes)
    out = {}
    for mode in ("off", "on"):
        jps = dataclasses.replace(jax_problem(cg_precond_bf16=mode).pressure_solver, tol=0.0,
                                  iters=PRESSURE_ITERS)
        tps = dataclasses.replace(port_problem(cg_precond_bf16=mode).pressure_solver, tol=0.0,
                                  iters=PRESSURE_ITERS)
        out[mode] = (tps.solve(torch.as_tensor(b)).numpy(), np.asarray(jps.solve(jnp.asarray(b))))
    for mode, (got, want) in out.items():
        assert rel(got, want) <= 1e-12, mode
    assert rel(out["on"][1], out["off"][1]) > 1e-10


def test_stokes_steps_match_tpufem_with_bf16_planes():
    jp, tp = jax_problem(cg_precond_bf16="on"), port_problem(cg_precond_bf16="on")
    js, _ = jstokes.run(jp, steps=3)
    before = grid_cg.pressure_cg.launches
    ts, _ = tstokes.run(tp, steps=3)
    assert grid_cg.pressure_cg.launches == before  # the plain versions on the CPU
    assert rel(ts["u"].numpy(), np.asarray(js["u"])) <= 1e-10


# where tpufem's gate is false, "on" changes nothing
NO_OP = {
    "csr": dict(storage="csr"),
    "stencil": dict(storage="stencil"),
    "jacobi": dict(storage="grid_interpret", cg_precond="jacobi"),
    "grid below 360k": dict(storage="grid_interpret", cg_stream_diags="auto"),
}


@pytest.mark.parametrize("case", list(NO_OP))
def test_on_is_a_no_op_where_tpufems_gate_is_false(case):
    kw = dict(NO_OP[case])
    storage = kw.pop("storage")
    runs = {}
    for mode in ("off", "on"):
        tp = port_problem(storage, cg_precond_bf16=mode, **kw)
        jp = jax_problem(storage, cg_precond_bf16=mode, **kw)
        assert getattr(tp.pressure_solver, "K_pre", None) is None
        assert not getattr(jp.pressure_solver, "precond_bf16", False)
        runs[mode] = (tstokes.run(tp, steps=2)[0]["u"].numpy(),
                      np.asarray(jstokes.run(jp, steps=2)[0]["u"]))
    np.testing.assert_allclose(runs["on"][0], runs["off"][0], rtol=0, atol=0)
    np.testing.assert_allclose(runs["on"][1], runs["off"][1], rtol=0, atol=0)


def test_k5_keeps_the_full_planes():
    """tpufem's whole-step kernel has no bf16 planes: K5's pressure solves
    apply K in the preconditioner, while the unfused solver applies K̃."""
    tp = port_problem(cg_precond_bf16="on", grid_steps_per_call=1)
    assert tp.pressure_solver.K_pre is not None
    step = tp.grid_step
    assert step.pressure.K_pre is None and step.pressure.K_precond is step.pressure.K
    assert step.pressure.K is tp.pressure_solver.K


def _with_operator(solver, K):
    """``solver`` applying ``K`` in every apply, with the solver's own
    inverse diagonal and ω."""
    out = dataclasses.replace(solver, K=K)
    out.__dict__["inv_diag_grid"] = solver.inv_diag_grid
    return out


@pytest.mark.parametrize("probe", ["nofma", "nodma"])
def test_plain_probes_match_their_definitions(probe):
    """nofma: every apply is the remainder alone (the planes as zeros);
    nodma: each plane replaced by its mean.  Both differ from the real
    solve; on CPU tensors the wrapper takes the plain version."""
    base = dataclasses.replace(port_problem().pressure_solver, tol=0.0, iters=PRESSURE_ITERS)
    ps = dataclasses.replace(base, probe=probe)
    K = base.K
    if probe == "nofma":
        planes = torch.zeros_like(K.diags)
    else:
        planes = K.diags.mean(dim=(-2, -1))[:, None, None].expand_as(K.diags)
        assert ps.plane_constants[0] == K.diags.mean(dim=(-2, -1)).tolist()
    definition = _with_operator(base, dataclasses.replace(K, diags=planes))
    b = torch.as_tensor(np.random.default_rng(5).standard_normal((K.ns, K.ns))) * base.act_grid
    x0 = torch.zeros_like(b)
    before = grid_cg.pressure_cg.launches
    got = grid_cg.pressure_cg(ps, b, x0)
    assert grid_cg.pressure_cg.launches == before
    torch.testing.assert_close(got, grid_cg.pressure_cg_ref(definition, b, x0), rtol=0, atol=0)
    assert rel(got.numpy(), grid_cg.pressure_cg_ref(base, b, x0).numpy()) > 1e-3


@pytest.mark.parametrize("tol", [0.0, 1e-5])
def test_plain_exchange_probe_visits_no_point(tol):
    """exchange: no point is visited between the grid barriers, so x stays
    the start and leaves projected; r·r reads 0, so every fixed iteration
    runs and a tolerance stops the loop before the first."""
    base = dataclasses.replace(port_problem().pressure_solver, tol=tol, iters=PRESSURE_ITERS)
    ps = dataclasses.replace(base, probe="exchange")
    act = ps.act_grid
    x0 = torch.as_tensor(np.random.default_rng(6).standard_normal(act.shape)) * act
    b = torch.as_tensor(np.random.default_rng(5).standard_normal(act.shape)) * act
    count = torch.zeros(1, dtype=torch.int32)
    got = grid_cg.pressure_cg(ps, b, x0, count)
    want = x0 - (torch.sum(act * x0) / torch.sum(act * act)) * act
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(count.item()) == (PRESSURE_ITERS if tol == 0.0 else 0)
    assert rel(got.numpy(), grid_cg.pressure_cg_ref(base, b, x0).numpy()) > 1e-3


def test_unknown_probe_refused():
    with pytest.raises(ValueError, match="probe"):
        dataclasses.replace(port_problem().pressure_solver, probe="nodram")
