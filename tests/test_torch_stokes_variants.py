"""The rest of the Stokes workload against tpufem: the "report" variant on
the dense and CG paths, Eulerian and departure-point ("griddata") dye, and
div/grad by ``index_add_`` (``dense_ops=False``), from the port's own build
and, on the dense path, from tpufem's operator arrays carried across by
``tpufem_torch.interop``."""

import functools

import numpy as np
import pytest
import torch

from tpufem.ops import calculus as jcalculus
from tpufem.workloads import stokes as jstokes
from tpufem_torch import interop
from tpufem_torch.ops import calculus as tcalculus
from tpufem_torch.solve.matfree import PressureCG, ViscousCG
from tpufem_torch.workloads import stokes as tstokes

from tests._torch_parity import jax_problem_arrays, meshes, rel

torch.set_num_threads(2)

BASE = dict(dt=0.01, nu=1.0)
PAD = (20, 24, True)  # pad_hole: N = 400 on a 20×20 grid
REPORT = dict(variant="report", bc_kind="rotating", ramp_steps=5, pressure_smoothing=0.01)
CSR = dict(solver="cg", cg_storage="csr", cg_iters_pressure=100)
# name: (config, mesh, steps, relative tolerance on u and max abs on c,
# relative tolerance on the per-step metrics).  Where the ±1e10 penalty is
# on the dense pressure solve, SciPy's and JAX's triangular solves part by
# ~1e-10 over 20 steps, as in tests/test_torch_stokes.py; the divergence
# metrics difference u and lose about one more digit.
CASES = {
    "report_dense": (dict(REPORT, double_projection=False), (12, 16), 20, 1e-8, 1e-7),
    "report_csr": (dict(REPORT, **CSR, cg_tol_visc=1e-12), (12, 16), 10, 1e-12, 1e-10),
    # "grid" storage: both packages renumber the mesh and take the plain CG
    # solvers, as the grid kernels do not implement the pin, with tpufem's
    # storage rule for their operators (the stencil at ≥ 90 % coverage)
    "report_grid": (dict(REPORT, solver="cg", cg_storage="grid", cg_iters_pressure=100),
                    (12, 16), 10, 1e-12, 1e-10),
    "eulerian_dense": (dict(transport="eulerian_dye"), (12, 16), 20, 1e-8, 1e-7),  # c: C_TOL
    "eulerian_csr": (dict(transport="eulerian_dye", **CSR), (12, 16), 10, 1e-12, 1e-10),
    "eulerian_grid": (dict(transport="eulerian_dye", solver="cg", cg_storage="grid_interpret",
                           cg_iters_pressure=100), PAD, 10, 1e-12, 1e-10),
    "griddata": (dict(transport="dye_griddata", solver="inverse", pressure_mode="merge"),
                 (12, 16), 20, 1e-12, 1e-10),
    "griddata_no_diffusion": (dict(transport="dye_griddata", solver="inverse",
                                   pressure_mode="merge", D=0.0), (12, 16), 20, 1e-12, 1e-10),
    "dense_ops_off": (dict(transport="dye", dense_ops=False, solver="inverse",
                           pressure_mode="merge"), (12, 16), 20, 1e-12, 1e-10),
}
DENSE = [k for k, v in CASES.items() if v[0].get("solver") != "cg"]
# The f64 dense dye solve carries the ±1e10 penalty on a mass-scaled matrix:
# cond(A_c) is 3.4e13 on (12, 16), and one solve of the same matrix by
# torch.linalg.solve and by jnp.linalg.solve (or np.linalg.solve, which
# agrees with JAX's to 1.6e-15) parts by 8.9e-6 max abs: eliminating the
# penalty rows rounds away ~ε·1e10 ≈ 1e-6 of rows whose scale is ~1e-3, so
# the scheme holds c only to ~1e-3, and two LAPACKs round it differently.
# Over 20 steps c parts by 1.8e-4 (measured, both sources); u does not see
# the dye.
C_TOL = {"eulerian_dense": 1e-3}


@functools.lru_cache(maxsize=None)
def jax_run(case, **changes):
    """(tpufem problem, final state, metrics) of one case from tpufem's
    initial state, built and run once per test process."""
    kw, mesh_size, steps, _, _ = CASES[case]
    jm, _ = meshes(*mesh_size)
    problem = jstokes.StokesProblem.build(jm, jstokes.StokesConfig(**BASE, **kw, **changes))
    s1, m1 = jstokes.run(problem, steps=steps)
    return (problem, {k: np.asarray(v) for k, v in s1.items()},
            {k: np.asarray(v) for k, v in m1.items()})


def _port_problem(case, source, **changes):
    kw, mesh_size, _, _, _ = CASES[case]
    _, tm = meshes(*mesh_size)
    config = tstokes.StokesConfig(**BASE, **kw, **changes)
    if source == "build":
        return tstokes.StokesProblem.build(tm, config, device="cpu")
    arrays = jax_problem_arrays(jax_run(case)[0])
    return interop.problem_from_numpy(arrays, tm, config, device="cpu")


@pytest.mark.parametrize("case,source", [(c, "build") for c in CASES]
                         + [(c, "interop") for c in DENSE])
def test_variant_matches_tpufem(case, source):
    jp, s1, m1 = jax_run(case)
    steps, tol, metric_tol = CASES[case][2:]
    tp = _port_problem(case, source)
    out, metrics = tstokes.run(tp, steps=steps)
    got = interop.state_to_numpy(out)
    assert got.keys() == s1.keys()
    assert got["u"].dtype == np.float64
    assert rel(got["u"], s1["u"]) < tol
    assert int(got["step"]) == steps
    assert metrics.keys() == m1.keys()
    for k in ("div_star_max", "final_div_max", "max_u"):
        np.testing.assert_allclose(metrics[k].numpy(), m1[k], rtol=metric_tol)
    if "c" in s1:
        c_tol = C_TOL.get(case, tol)
        np.testing.assert_allclose(got["c"], s1["c"], rtol=0, atol=c_tol)
        np.testing.assert_allclose(metrics["mixing_progress"].numpy(), m1["mixing_progress"],
                                   rtol=0, atol=c_tol)
    for k in ("p_warm", "p2_warm", "ustar_warm"):
        if k in s1:  # the pinned gauge is the same in both packages
            assert rel(got[k], s1[k]) < tol, k


def test_report_paths_as_tpufem():
    """What each package builds for the report variant: the pin, the
    smoothing solver, and on "grid" storage the plain CG solvers (not the
    grid kernels) on the renumbered mesh."""
    for case in ("report_dense", "report_csr", "report_grid"):
        jp = jax_run(case)[0]
        tp = _port_problem(case, "build")
        assert tp.pressure_pin == jp.pressure_pin >= 0
        assert tp.mesh.markers[tp.pressure_pin] == 0
        assert (tp.smooth_solver is None) == (jp.smooth_solver is None) is False
        assert (tp.gridified is None) == (jp.gridified is None)
    jp = jax_run("report_grid")[0]
    tp = _port_problem("report_grid", "build")
    assert tp.gridified is not None and tp.mesh.n_nodes == jp.mesh.n_nodes
    assert type(tp.visc_solver) is ViscousCG and type(tp.pressure_solver) is PressureCG
    assert type(jp.visc_solver).__name__ == "ViscousCG"
    assert type(jp.pressure_solver).__name__ == "PressureCG"
    assert tp.pressure_solver.pin == jp.pressure_solver.pin
    for t, j in ((tp.visc_solver.K, jp.visc_solver.K), (tp.pressure_solver.K_merged,
                                                        jp.pressure_solver.K_merged),
                 (tp.mf_dx, jp.mf_dx), (tp.mf_dy, jp.mf_dy)):
        assert type(t).__name__ == type(j).__name__


def test_eulerian_f32_merge_tracks_tpufem_f64():
    """Eulerian dye at f32 (the merged-periodic dye solve) against tpufem's
    f64 run of the same configuration (the penalty dye solve), in relative
    L2.  The penalty's rounding (see C_TOL) holds the f64 c only to ~1e-3:
    the port's f64 merged solve parts from it by 2.5e-3 (measured), f32
    adds 2e-7."""
    kw = dict(solver="inverse", pressure_mode="merge")
    _, s1, _ = jax_run("eulerian_dense", **kw)
    tp = _port_problem("eulerian_dense", "build", precision="f32", **kw)
    assert tp.eul_Mg is not None and tp.eul_Mg.dtype == torch.float32
    out, metrics = tstokes.run(tp, steps=CASES["eulerian_dense"][2])
    assert out["c"].dtype == torch.float32
    assert rel(out["u"].numpy(), s1["u"]) < 5e-3
    assert rel(out["c"].numpy(), s1["c"]) < 5e-3
    assert bool(torch.isfinite(metrics["mixing_progress"]).all())


def test_mass_apply_matches_tpufem():
    jm, tm = meshes(12, 16)
    c = np.random.default_rng(3).standard_normal(tm.n_nodes)
    want = np.asarray(jcalculus.mass_apply(jm, c))
    got = tcalculus.mass_apply(tm, torch.as_tensor(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    # and it is the consistent mass matrix
    from tpufem_torch.ops import assembly

    M = assembly.assemble_dense(tm, assembly.element_mass(tm)).numpy()
    np.testing.assert_allclose(got, M @ c, rtol=0, atol=1e-14)
