"""The port's main path against tpufem's: 20 Stokes steps with transport on
a generated mesh, from the port's own build and from tpufem's operator
arrays carried across by ``tpufem_torch.interop``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.workloads import stokes as jstokes
from tpufem_torch import bench_large, interop
from tpufem_torch.ops import fused_matvec as fm
from tpufem_torch.workloads import stokes as tstokes

from tests._torch_parity import jax_problem_arrays, jittered, meshes, rel

torch.set_num_threads(2)

STEPS = 20
BASE = dict(dt=0.01, nu=1.0)
# name: (config, mesh, relative tolerance on u, relative tolerance on the
# per-step metrics).  The small mesh keeps tpufem's build and first run
# under 5 s per case.
CASES = {
    # the bench path (fused merge, inverse) at f64, with tracers
    "fused": (dict(transport="tracers", tracer_density=15, solver="inverse",
                   pressure_mode="merge", fused=True), (12, 16), 1e-12, 1e-10),
    # the reference's parity path: unfused, LU, ±1e10 penalty, with dye.
    # The penalty makes it ill-conditioned: SciPy and JAX triangular solves
    # on the same LU factors differ by ~2e-10 after 20 steps on (20, 24).
    # The divergence metrics difference u and so lose about one more digit
    # (measured 1.8e-8 from the port's build, 1.4e-8 from tpufem's arrays).
    "unfused_lu_penalty": (dict(transport="dye", solver="lu", pressure_mode="penalty"),
                           (12, 16), 1e-8, 1e-7),
}


def _jax_initial_state(problem):
    state = jstokes.initial_state(problem)
    if "tracers" in state:
        state["tracers"] = jnp.asarray(jittered(np.asarray(state["tracers"])))
    return state


@functools.lru_cache(maxsize=None)
def jax_run(case):
    """(tpufem problem, initial state, final state, metrics) of one case,
    built and run once per test process."""
    kw, mesh_size, _, _ = CASES[case]
    jm, _ = meshes(*mesh_size)
    problem = jstokes.StokesProblem.build(jm, jstokes.StokesConfig(**BASE, **kw))
    s0 = _jax_initial_state(problem)
    s1, m1 = jstokes.run(problem, steps=STEPS, state=dict(s0))
    return (problem, {k: np.asarray(v) for k, v in s0.items()},
            {k: np.asarray(v) for k, v in s1.items()},
            {k: np.asarray(v) for k, v in m1.items()})


def _port_problem(case, source, **overrides):
    kw, mesh_size, _, _ = CASES[case]
    _, tm = meshes(*mesh_size)
    config = tstokes.StokesConfig(**{**BASE, **kw, **overrides})
    if source == "build":
        return tstokes.StokesProblem.build(tm, config, device="cpu")
    arrays = jax_problem_arrays(jax_run(case)[0])
    return interop.problem_from_numpy(arrays, tm, config, device="cpu")


@pytest.mark.parametrize("source", ["build", "interop"])
@pytest.mark.parametrize("case", list(CASES))
def test_run_matches_tpufem(case, source):
    _, s0, s1, m1 = jax_run(case)
    tol, metric_tol = CASES[case][2:]
    tp = _port_problem(case, source)
    state = interop.state_from_numpy(s0, device="cpu")
    out, metrics = tstokes.run(tp, steps=STEPS, state=state)
    got = interop.state_to_numpy(out)
    assert got["u"].dtype == np.float64
    assert rel(got["u"], s1["u"]) < tol
    assert int(got["step"]) == STEPS
    for k in ("div_star_max", "final_div_max", "max_u"):
        np.testing.assert_allclose(metrics[k].numpy(), m1[k], rtol=metric_tol)
    if "tracers" in got:
        np.testing.assert_allclose(got["tracers"], s1["tracers"], rtol=0, atol=1e-10)
        np.testing.assert_array_equal(got["tracer_status"], s1["tracer_status"])
        np.testing.assert_array_equal(metrics["eaten"].numpy(), m1["eaten"])
    if "c" in got:
        np.testing.assert_allclose(got["c"], s1["c"], rtol=0, atol=tol)
        np.testing.assert_allclose(metrics["mixing_progress"].numpy(), m1["mixing_progress"],
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("case", list(CASES))
def test_port_initial_state_matches_tpufem(case):
    jp = jax_run(case)[0]
    tp = _port_problem(case, "build")
    got = interop.state_to_numpy(tstokes.initial_state(tp))
    want = {k: np.asarray(v) for k, v in jstokes.initial_state(jp).items()}
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def test_fused_matches_unfused():
    """The composed whole-step matrix is exact linear algebra."""
    _, tm = meshes(20, 24)
    kw = dict(BASE, pressure_mode="merge")
    base = tstokes.StokesProblem.build(tm, tstokes.StokesConfig(**kw), device="cpu")
    fused = tstokes.StokesProblem.build(tm, tstokes.StokesConfig(**kw, fused=True), device="cpu")
    s1, m1 = tstokes.run(base, steps=STEPS)
    s2, m2 = tstokes.run(fused, steps=STEPS)
    assert rel(s2["u"].numpy(), s1["u"].numpy()) < 1e-12
    np.testing.assert_allclose(m2["div_star_max"].numpy(), m1["div_star_max"].numpy(), rtol=1e-10)


def test_f32_port_tracks_tpufem_f64():
    """The bench configuration at f32, through the K1 wrapper (its plain
    version on the CPU), tracks tpufem's f64 run."""
    _, s0, s1, m1 = jax_run("fused")
    tp = _port_problem("fused", "build", precision="f32", matvec_impl="pallas")
    state = tstokes.initial_state(tp)
    state["tracers"] = torch.tensor(s0["tracers"], dtype=torch.float32)
    before = fm.fused_step_matvec.launches
    out, metrics = tstokes.run(tp, steps=STEPS, state=state)
    assert fm.fused_step_matvec.launches == before  # no kernel on the CPU
    assert out["u"].dtype == torch.float32
    assert rel(out["u"].numpy(), s1["u"]) < 5e-3
    frac = metrics["eaten"][-1].item() / len(s0["tracers"])
    assert abs(frac - m1["eaten"][-1] / len(s0["tracers"])) < 0.05


@pytest.mark.parametrize(
    "kw,error",
    [
        (dict(solver="cg", cg_precond_bf16="yes"), ValueError),
        (dict(precision="bf16", pressure_mode="merge"), ValueError),
        (dict(precision="f32", pressure_mode="penalty"), ValueError),
        (dict(fused=True), ValueError),
        (dict(matvec_impl="triton"), ValueError),
        (dict(transport="smoke"), ValueError),
    ],
)
def test_unported_or_invalid_config_refused(kw, error):
    _, tm = meshes(12, 16)
    with pytest.raises(error):
        tstokes.StokesProblem.build(tm, tstokes.StokesConfig(**kw), device="cpu")


@pytest.mark.parametrize(
    "kw",
    [
        dict(variant="report", precision="f32", pressure_mode="merge"),
        dict(variant="report", fused=True, pressure_mode="merge"),
        dict(fused=True, pressure_mode="merge", dense_ops=False),
        dict(solver="cg", transport="dye_griddata"),
        dict(variant="smooth"),
    ],
    ids=["report-f32", "report-fused", "fused-no-dense-ops", "cg-griddata", "unknown-variant"],
)
def test_invalid_variant_config_refused_as_tpufem(kw):
    """tpufem's own refusals of the report variant, griddata dye and the
    fused step, as ValueErrors."""
    _, tm = meshes(12, 16)
    with pytest.raises(ValueError):
        tstokes.StokesProblem.build(tm, tstokes.StokesConfig(**kw), device="cpu")


DENSE_MERGE = dict(solver="inverse", pressure_mode="merge")
CSR = dict(solver="cg", cg_storage="csr")
# The configuration branches of the dense, CSR, stencil and banded paths,
# f64, 10 steps from rest on (12, 16): measured ≤ 3.4e-16 relative in u
# (tracers 2.8e-16 max abs) on the CPU, held at 1e-12; the dye c likewise.
BRANCHES = {
    "dense-lu-merge": dict(solver="lu", pressure_mode="merge"),
    "dense-rotating-ramp": dict(DENSE_MERGE, bc_kind="rotating", ramp_steps=5),
    "dense-all-walls": dict(DENSE_MERGE, all_walls=True, outer_value=(1.0, 0.0)),
    "dense-outer-value": dict(DENSE_MERGE, outer_value=(0.5, 0.0)),
    "dense-body-force": dict(DENSE_MERGE, body_force=(0.1, 0.0)),
    "dense-dirichlet-lift": dict(DENSE_MERGE, dirichlet_lift=True),
    "dense-single-projection": dict(DENSE_MERGE, double_projection=False),
    "dense-pusher": dict(DENSE_MERGE, B2=-5.0),
    "fused-rk2-tracers": dict(DENSE_MERGE, fused=True, transport="tracers", tracer_density=15,
                              tracer_method="rk2"),
    "csr-jacobi": dict(CSR),
    "csr-twolevel-tol": dict(CSR, cg_precond="twolevel", cg_tol_pressure=1e-10),
    "csr-cold-start": dict(CSR, cg_warm_start=False),
    "csr-chebyshev-tol": dict(CSR, cg_precond="chebyshev", cg_tol_pressure=1e-10),
    "csr-twolevel-eulerian-dye": dict(CSR, cg_precond="twolevel", transport="eulerian_dye"),
    # by name on a mesh without the hole: 16 offsets, 88 % coverage
    "stencil-jacobi": dict(CSR, cg_storage="stencil"),
    "stencil-twolevel-tol": dict(CSR, cg_storage="stencil", cg_precond="twolevel",
                                 cg_tol_pressure=1e-10),
    "banded-jacobi": dict(CSR, cg_storage="banded"),
    "banded-chebyshev-tracers": dict(CSR, cg_storage="banded", cg_precond="chebyshev",
                                     transport="tracers", tracer_density=15),
    "topk-dye": dict(DENSE_MERGE, transport="dye", locator="topk"),
    "topk-tracers": dict(DENSE_MERGE, fused=True, transport="tracers", tracer_density=15,
                         locator="topk"),
    "topk-dye-griddata": dict(DENSE_MERGE, transport="dye_griddata", locator="topk"),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_configuration_branches_match_tpufem(branch):
    kw = dict(BASE, **BRANCHES[branch])
    jm, tm = meshes(12, 16)
    jp = jstokes.StokesProblem.build(jm, jstokes.StokesConfig(**kw))
    s0 = _jax_initial_state(jp)
    s1, m1 = jstokes.run(jp, steps=10, state=dict(s0))
    tp = tstokes.StokesProblem.build(tm, tstokes.StokesConfig(**kw), device="cpu")
    out, metrics = tstokes.run(tp, steps=10, state=interop.state_from_numpy(
        {k: np.asarray(v) for k, v in s0.items()}, device="cpu"))
    assert rel(out["u"].numpy(), np.asarray(s1["u"])) < 1e-12
    np.testing.assert_allclose(metrics["final_div_max"].numpy(), np.asarray(m1["final_div_max"]),
                               rtol=1e-10)
    if "tracers" in s1:
        np.testing.assert_allclose(out["tracers"].numpy(), np.asarray(s1["tracers"]), rtol=0,
                                   atol=1e-12)
        np.testing.assert_array_equal(out["tracer_status"].numpy(), np.asarray(s1["tracer_status"]))
    if "c" in s1:
        assert rel(out["c"].numpy(), np.asarray(s1["c"])) < 1e-12


def test_grid_steps_per_call_ignored_on_csr_storage():
    """As in tpufem: K5 needs the grid storage; on CSR the setting is
    ignored and the unfused step runs."""
    _, tm = meshes(12, 16)
    cfg = tstokes.StokesConfig(solver="cg", cg_storage="csr", grid_steps_per_call=1)
    problem = tstokes.StokesProblem.build(tm, cfg, device="cpu")
    assert problem.grid_step is None and tstokes.steps_per_call(problem) == 1


def test_bench_large_config_accepted():
    """bench_large's scale configuration (f32 with the default penalty
    pressure_mode, which the cg path ignores, and non-default cg_* fields)
    passes the checks, as in tpufem."""
    cfg = bench_large.bench_config(n_nodes=1_048_576)
    tstokes.check_config(cfg)
    assert (cfg.precision, cfg.pressure_mode, cfg.cg_coarse_dtype) == ("f32", "penalty", "bf16")
    # and cg_* settings are ignored under a dense solver
    tstokes.check_config(tstokes.StokesConfig(cg_storage="stencil", grid_steps_per_call=1))
