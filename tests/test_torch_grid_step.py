"""Kernel K5 (``tpufem_torch.solve.grid_step``), the whole double-projection
Stokes step, in its plain version against tpufem's ``GridStokesStep`` run
in interpret mode, on ``generate_annulus_mesh(20, 24, pad_hole=True)`` at
f64: the same fields, the same refusals, the same steps; K steps a call
against K calls; K5 against the port's unfused grid path."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from tpufem.solve.pallas_step import GridStokesStep as JStep
from tpufem.workloads import stokes as jstokes
from tpufem_torch import interop
from tpufem_torch.solve import grid_step
from tpufem_torch.solve.grid_step import GridStokesStep as TStep
from tpufem_torch.workloads import stokes as tstokes

from tests._torch_parity import jax_problem_arrays, meshes, rel

torch.set_num_threads(2)

MESH = (20, 24)
# tpufem's K5 test configuration (tests/test_matfree.py), two-level
CONFIG = dict(
    dt=0.01, nu=1.0, solver="cg", cg_precond="twolevel", cg_iters_visc=30, cg_iters_pressure=60,
    cg_warm_start=True, cg_tol_visc=1e-7, cg_tol_pressure=1e-7, precision="f64",
)
METRICS = ("div_star_max", "final_div_max", "max_u")


@functools.lru_cache(maxsize=None)
def jax_run(steps: int = 3):
    """tpufem's K5 problem (interpret mode, K = 1), its state and metrics."""
    jm, _ = meshes(*MESH, pad_hole=True)
    jp = jstokes.StokesProblem.build(
        jm, jstokes.StokesConfig(cg_storage="grid_interpret", grid_steps_per_call=1, **CONFIG))
    state, metrics = jstokes.run(jp, steps=steps)
    return (jp, {k: np.asarray(v) for k, v in state.items()},
            {k: np.asarray(v) for k, v in metrics.items()})


def _port(**kw):
    _, tm = meshes(*MESH, pad_hole=True)
    return tstokes.StokesProblem.build(
        tm, tstokes.StokesConfig(cg_storage="grid", **{**CONFIG, "grid_steps_per_call": 1, **kw}),
        device="cpu")


def test_fields_match_tpufem():
    jp, _, _ = jax_run()
    js, ts = jp.grid_step, _port().grid_step
    assert isinstance(js, JStep) and isinstance(ts, TStep)
    for name in ("Gdx", "Gdy"):
        j, t = getattr(js, name), getattr(ts, name)
        assert t.offsets == j.offsets and t.n_rest == j.n_rest
        np.testing.assert_array_equal(t.diags.numpy(), np.asarray(j.diags))
    for name in ("wall_mask", "inner_mask", "inner_vals", "interior2"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    for name in ("outer_value", "dt", "body_force", "steps_per_call"):
        assert getattr(ts, name) == getattr(js, name), name


@pytest.mark.parametrize("change,want", [
    (dict(grid_steps_per_call=0), None),
    (dict(ramp_steps=5), None),
    (dict(double_projection=False), None),
    (dict(dirichlet_lift=True), None),
    (dict(grid_steps_per_call=3, transport="tracers"), 1),
    (dict(grid_steps_per_call=3), 3),
    (dict(grid_steps_per_call=3, cg_tol_visc=0.0), "raises"),
    ("not grid solvers", None),
])
def test_build_refusals_match_tpufem(change, want):
    """GridStokesStep.build on the same problem with one setting changed."""
    jp, _, _ = jax_run()
    tp = _port()
    outcomes = []
    for problem, build in ((jp, JStep.build), (tp, TStep.build)):
        if change == "not grid solvers":
            problem = dataclasses.replace(problem, visc_solver=problem.pressure_solver)
        else:
            problem = dataclasses.replace(problem,
                                          config=dataclasses.replace(problem.config, **change))
        try:
            step = build(problem)
        except (AssertionError, ValueError):
            outcomes.append("raises")
            continue
        outcomes.append(None if step is None else step.steps_per_call)
    assert outcomes == [want, want]


@pytest.mark.parametrize("source", ["build", "interop"])
def test_plain_k5_matches_tpufem_interpret(source):
    jp, s1, m1 = jax_run()
    if source == "build":
        tp = _port()
    else:
        _, tm = meshes(*MESH, pad_hole=True)
        config = tstokes.StokesConfig(cg_storage="grid", grid_steps_per_call=1, **CONFIG)
        tp = interop.problem_from_numpy(jax_problem_arrays(jp), tm, config, device="cpu")
    assert isinstance(tp.grid_step, TStep)
    before = grid_step.grid_step.launches
    state, metrics = tstokes.run(tp, steps=3)
    assert grid_step.grid_step.launches == before  # the plain version on the CPU
    got = interop.state_to_numpy(state)
    assert set(got) == set(s1)
    assert rel(got["u"], s1["u"]) <= 1e-10
    for k in METRICS:
        np.testing.assert_allclose(metrics[k].numpy(), m1[k], rtol=1e-8)


def test_steps_per_call_is_bit_equal_to_single_steps():
    kw = dict(cg_tol_visc=1e-7)
    s1, m1 = tstokes.run(_port(**kw), steps=6)
    p3 = _port(grid_steps_per_call=3, **kw)
    assert p3.grid_step.steps_per_call == 3
    s3, m3 = tstokes.run(p3, steps=6)
    assert torch.equal(s1["u"], s3["u"]) and int(s3["step"]) == 6
    for k in METRICS:
        assert m3[k].shape == (6,)
        assert torch.equal(m1[k], m3[k]), k
    with pytest.raises(ValueError, match="multiple"):
        tstokes.run(p3, steps=4)


def test_k5_matches_unfused_grid_path():
    """tpufem's tolerances: K5 applies div/grad as grid planes and stops
    each viscous column on its own, so the two paths differ by roundoff
    amplified through the solves."""
    fused = _port()
    unfused = dataclasses.replace(fused, grid_step=None)
    s1, m1 = tstokes.run(fused, steps=10)
    s2, m2 = tstokes.run(unfused, steps=10)
    np.testing.assert_allclose(s1["u"].numpy(), s2["u"].numpy(), atol=1e-6)
    np.testing.assert_allclose(m1["final_div_max"].numpy(), m2["final_div_max"].numpy(),
                               rtol=1e-6)


def test_f32_k5_tracks_tpufem_f64():
    _, s1, _ = jax_run()
    state, _ = tstokes.run(_port(precision="f32"), steps=3)
    assert state["u"].dtype == torch.float32
    assert rel(state["u"].numpy(), s1["u"]) <= 5e-3


def test_cuda_only_arguments_checked_on_cpu():
    step = _port().grid_step
    ns = step.ns
    u = torch.zeros(2, ns, ns, dtype=torch.float64)
    p = torch.zeros(ns, ns, dtype=torch.float64)
    with pytest.raises(ValueError):
        grid_step.grid_step(step, u[:1], u, p, p)
    with pytest.raises(TypeError):
        grid_step.grid_step(step, u.float(), u.float(), p.float(), p.float())
