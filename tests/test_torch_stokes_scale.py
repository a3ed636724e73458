"""The scale regime end to end: the port's ``solver="cg"`` Stokes steps on
``generate_annulus_mesh(20, 24, pad_hole=True)`` against tpufem's, from the
port's own build and from tpufem's operators carried across by
``tpufem_torch.interop``; the grid storage (kernels K2/K3 through their
plain versions on the CPU, div/grad on the stencil) against tpufem's
``grid_interpret``, and the CSR, stencil and banded storages against
tpufem's."""

import functools

import numpy as np
import pytest
import torch

from tpufem.workloads import stokes as jstokes
from tpufem_torch import interop
from tpufem_torch.ops import assembly as tassembly
from tpufem_torch.solve import grid_cg
from tpufem_torch.solve.grid_cg import PressureGridCG, ViscousGridCG
from tpufem_torch.solve.grid_step import GridStokesStep
from tpufem_torch.solve.matfree import PressureCG, ViscousCG
from tpufem_torch.workloads import stokes as tstokes

from tests._torch_parity import jax_problem_arrays, meshes, rel

torch.set_num_threads(2)

MESH = (20, 24)
# bench_large's configuration at this size (two-level, warm starts, tol 1e-5
# on both solves), at f64 and with the coarse inverse in the field dtype:
# a bf16 coarse inverse makes the preconditioner depend on float32 summation
# order inside the coarse product (see test_bf16_coarse_tracks_tpufem)
BENCH = dict(
    dt=0.01, nu=1.0, solver="cg", cg_iters_visc=30, cg_iters_pressure=60, cg_precond="twolevel",
    cg_warm_start=True, cg_tol_pressure=1e-5, cg_tol_visc=1e-5, precision="f64",
)
METRICS = ("div_star_max", "final_div_max", "max_u")


@functools.lru_cache(maxsize=None)
def jax_run(storage: str, steps: int, **kw):
    """(tpufem problem, final state, metrics) of one configuration."""
    jm, _ = meshes(*MESH, pad_hole=True)
    problem = jstokes.StokesProblem.build(jm, jstokes.StokesConfig(cg_storage=storage, **{**BENCH, **kw}))
    state, metrics = jstokes.run(problem, steps=steps)
    return (problem, {k: np.asarray(v) for k, v in state.items()},
            {k: np.asarray(v) for k, v in metrics.items()})


def _port_problem(storage: str, **kw):
    _, tm = meshes(*MESH, pad_hole=True)
    return tstokes.StokesProblem.build(
        tm, tstokes.StokesConfig(cg_storage=storage, **{**BENCH, **kw}), device="cpu")


def _compare(state, metrics, want_state, want_metrics, u_tol, metric_tol):
    got = interop.state_to_numpy(state)
    assert rel(got["u"], want_state["u"]) <= u_tol
    assert set(got) == set(want_state)
    for k in METRICS:
        np.testing.assert_allclose(metrics[k].numpy(), want_metrics[k], rtol=metric_tol)


@pytest.mark.parametrize("source", ["build", "interop"])
def test_grid_path_matches_tpufem_grid_interpret(source):
    jp, s1, m1 = jax_run("grid_interpret", 3)
    if source == "build":
        tp = _port_problem("grid")
    else:
        _, tm = meshes(*MESH, pad_hole=True)
        config = tstokes.StokesConfig(cg_storage="grid", **BENCH)
        tp = interop.problem_from_numpy(jax_problem_arrays(jp), tm, config, device="cpu")
    assert isinstance(tp.visc_solver, ViscousGridCG) and isinstance(tp.pressure_solver,
                                                                    PressureGridCG)
    assert tp.visc_solver.K.offsets == jp.visc_solver.K.offsets
    assert tp.pressure_solver.omega == jp.pressure_solver.omega
    before = (grid_cg.viscous_cg.launches, grid_cg.pressure_cg.launches)
    state, metrics = tstokes.run(tp, steps=3)
    assert (grid_cg.viscous_cg.launches, grid_cg.pressure_cg.launches) == before  # plain on CPU
    _compare(state, metrics, s1, m1, 1e-10, 1e-9)


def test_csr_path_matches_tpufem_csr():
    _, s1, m1 = jax_run("csr", 5)
    tp = _port_problem("csr")
    assert isinstance(tp.visc_solver, ViscousCG) and isinstance(tp.pressure_solver, PressureCG)
    state, metrics = tstokes.run(tp, steps=5)
    _compare(state, metrics, s1, m1, 1e-12, 1e-10)


@pytest.mark.parametrize("storage", ["stencil", "banded"])
def test_stencil_and_banded_paths_match_tpufem(storage):
    """tpufem's storages by name: every operator (viscous, merged pressure,
    div/grad) in that storage in both packages, 5 steps within 1e-12."""
    jp, s1, m1 = jax_run(storage, 5)
    tp = _port_problem(storage)
    assert isinstance(tp.visc_solver, ViscousCG) and isinstance(tp.pressure_solver, PressureCG)
    for t, j in ((tp.visc_solver.K, jp.visc_solver.K), (tp.pressure_solver.K_merged,
                                                        jp.pressure_solver.K_merged),
                 (tp.mf_dx, jp.mf_dx), (tp.mf_dy, jp.mf_dy)):
        assert type(t).__name__ == type(j).__name__ == {"stencil": "StencilOperator",
                                                        "banded": "BandedOperator"}[storage]
    state, metrics = tstokes.run(tp, steps=5)
    _compare(state, metrics, s1, m1, 1e-12, 1e-10)


def test_grid_div_grad_on_tpufems_stencil():
    """Under grid storage the div/grad applied between K2 and K3 are
    stencils, as tpufem's are: the same offsets, diagonals and remainder."""
    jp, _, _ = jax_run("grid_interpret", 3)
    for storage in ("grid", "grid_interpret"):
        tp = _port_problem(storage)
        for t, j in ((tp.mf_dx, jp.mf_dx), (tp.mf_dy, jp.mf_dy)):
            assert type(t).__name__ == type(j).__name__ == "StencilOperator"
            assert t.offsets == j.offsets and t.coverage == j.coverage >= 0.9
            np.testing.assert_array_equal(t.diags.numpy(), np.asarray(j.diags))
            np.testing.assert_array_equal(t.rest_cols, np.asarray(j.rest_cols_j))
            np.testing.assert_array_equal(t.rest_data.numpy(), np.asarray(j.rest_data))


@pytest.mark.parametrize("pad_hole,kind", [(True, "StencilOperator"), (False, "CSROperator")])
def test_auto_off_the_grid_on_cuda_is_stencil_else_csr(pad_hole, kind):
    """``"auto"`` on CUDA off the grid (``"auto_accel"``): the stencil at ≥ 90 %
    coverage, as tpufem; below it CSR, where tpufem takes banded (the band
    lost to CSR on the card, PERF.md §6).  The rule runs
    here on CPU tensors."""
    _, tm = meshes(12, 16, pad_hole=pad_hole)
    materialize = tstokes._materializer("auto_accel", torch.float64, torch.device("cpu"))
    K = tassembly.assemble_csr(tm, tassembly.element_stiffness(tm))
    assert type(materialize(K)).__name__ == kind
    banded = tstokes._materializer("banded", torch.float64, torch.device("cpu"))(K)
    assert type(banded).__name__ == "BandedOperator"


def test_auto_storage_is_csr_on_the_cpu():
    tp = _port_problem("auto", precision="f32")
    assert isinstance(tp.visc_solver, ViscousCG)


def test_f32_grid_path_tracks_tpufem_f64():
    _, s1, m1 = jax_run("grid_interpret", 3)
    tp = _port_problem("grid", precision="f32", cg_coarse_dtype="bf16")
    assert tp.pressure_solver.ac_inv.dtype == torch.bfloat16
    state, metrics = tstokes.run(tp, steps=3)
    assert state["u"].dtype == torch.float32
    assert rel(state["u"].numpy(), s1["u"]) <= 5e-3


def test_bf16_coarse_tracks_tpufem():
    """With a bf16 coarse inverse the coarse product accumulates in float32,
    whose summation order differs between XLA and the port; the runs then
    agree to 7.4e-10 rel in u after 3 steps (measured; bound 1e-8)."""
    _, s1, m1 = jax_run("grid_interpret", 3, cg_coarse_dtype="bf16")
    state, metrics = tstokes.run(_port_problem("grid", cg_coarse_dtype="bf16"), steps=3)
    _compare(state, metrics, s1, m1, 1e-8, 1e-7)


def test_tracers_step_on_the_grid_path():
    tp = _port_problem("grid", transport="tracers", tracer_density=15, precision="f32")
    state, metrics = tstokes.run(tp, steps=1)
    assert torch.isfinite(state["tracers"]).all()
    assert 0 <= int(metrics["eaten"][-1]) <= tp.tracer_init.shape[0]
    assert {"p_warm", "p2_warm", "ustar_warm"} <= set(state)


def test_grid_steps_per_call_builds_k5():
    tp = _port_problem("grid", grid_steps_per_call=1)
    assert isinstance(tp.grid_step, GridStokesStep) and tp.grid_step.steps_per_call == 1
    assert tp.grid_step.visc is tp.visc_solver and tp.grid_step.pressure is tp.pressure_solver


@pytest.mark.parametrize(
    "storage,kw,field",
    [
        ("grid", dict(cg_precond_bf16="yes"), "cg_precond_bf16"),
    ],
)
def test_unported_scale_settings_refused(storage, kw, field):
    """A value tpufem does not know is refused; ``cg_precond_bf16="on"``
    builds, and below tpufem's streamed size (360,000 nodes, with
    ``cg_stream_diags="auto"``) the preconditioner keeps its full planes,
    as tpufem's does."""
    with pytest.raises(ValueError, match=field):
        _port_problem(storage, **kw)
    ps = _port_problem(storage, **{field: "on"}).pressure_solver
    assert ps.K_pre is None and ps.K_precond is ps.K
