"""The ensembles (``tpufem_torch.parallel.spmd``), the batched transport and
the one-program gait campaign against tpufem's, on the CPU.

tpufem's ensembles run under ``shard_map`` on conftest's 8 virtual CPU
devices, ``build_device_mesh(8, data=2)``; the port's on
``build_device_mesh(devices=["cpu"] * 8, data=2)``, every position on the
CPU, so one batch program.  Meshes named ``cpu:0``, ``cpu:1``, … are
distinct devices to the port's grouping while their tensors all live on
the CPU: they drive the several-card code paths (groups stepping apart,
row blocks joined by ``all_gather`` across devices) here.

Tolerances, measured first (f64, ``generate_annulus_mesh(12, 16)``):
* merged pressure, 3 steps: the port's ensemble lies 1.8e-16 (relative)
  from tpufem's single-device step on each gait (held at 1e-12), and
  2.0e-10 (absolute; its max |div| 2.1e-10 relative) from tpufem's
  ensemble, which is itself about that far from its own single-device step
  (held at 1e-8); tracers 5.4e-12 from tpufem's ensemble's (1e-8), 1.1e-16
  from the single-device stepper's (dryrun_multichip's 1e-5);
* the ±1e10 penalty: 2.9e-8 from tpufem's ensemble (tpufem's own 2e-6),
  5.2e-9 relative from its single-device step (1e-7), max |div| 1.2e-8
  relative (1e-6);
* the report ensemble: 9.1e-13 from tpufem's (2e-6, tpufem's), 2.5e-17
  from the port's single-device report step (1e-12);
* per-simulation meshes (``(14, 16, pad_hole, jitter 0.15)``): 8.9e-16
  (1e-12);
* the batched transport: array-equal to a loop of the single calls,
  2.2e-16 from tpufem's batched functions (1e-12).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem
import tpufem_torch
from tpufem import transport as jtr
from tpufem.parallel import spmd as jspmd
from tpufem.workloads import stokes as jstokes
from tpufem.workloads import sweep as jsweep
from tpufem_torch import interop
from tpufem_torch import transport as ttr
from tpufem_torch.parallel import spmd
from tpufem_torch.workloads import stokes as tstokes
from tpufem_torch.workloads import sweep as tsweep

from tests._torch_parity import jax_problem_arrays, jittered, meshes, rel

torch.set_num_threads(2)

B1S = np.full(4, -2.0)
B2S = np.array([0.0, 5.0, -5.0, 2.0])
STEPS = 3
MERGE = dict(solver="inverse", pressure_mode="merge")
PENALTY = dict(solver="inverse")  # tpufem's default ensemble: f64, ±1e10 penalty
TRACERS = dict(transport="tracers", tracer_density=12, dt=0.01, nu=1.0)
REPORT = dict(variant="report", bc_kind="rotating", solver="inverse", pressure_mode="penalty",
              ramp_steps=10, pressure_smoothing=0.01, transport="dye", dt=1e-3, nu=0.1)
OMEGAS = np.array([2.0, 5.0, -3.0, 8.0])


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jspmd.build_device_mesh(8, data=2)


def cpu_mesh(data=2, devices=("cpu",) * 8):
    return spmd.build_device_mesh(devices=list(devices), data=data)


def numpy_state(state) -> dict:
    return {k: np.asarray(v) for k, v in state.items()}


def jittered_tracers(state: dict) -> dict:
    """Both packages' ensembles start from one jittered tracer lattice: the
    lattice lies on the mesh's edges, where tpufem's compiled locator drops
    points (ROADMAP Queue 3)."""
    state = dict(state)
    pts = jittered(np.asarray(state["tracers"][0]))
    state["tracers"] = np.broadcast_to(pts, np.shape(state["tracers"])).copy()
    return state


def run_jax(ens, state, steps=STEPS):
    step = jspmd.make_sharded_step(ens) if isinstance(ens, jspmd.ShardedEnsemble) \
        else jspmd.make_multimesh_step(ens)
    state = {k: jnp.asarray(v) for k, v in state.items()}
    for _ in range(steps):
        state, metric = step(state)
    return numpy_state(state), np.asarray(metric)


def run_port(step, state, steps=STEPS):
    state = {k: torch.as_tensor(np.array(v)) for k, v in state.items()}
    for _ in range(steps):
        state, metric = step(state)
    return {k: v.numpy() for k, v in state.items()}, metric.numpy()


@functools.lru_cache(maxsize=None)
def color_pair(case):
    """tpufem's and the port's ensemble of one color case, the common
    initial state, and tpufem's state and metric after STEPS steps."""
    kw = {"merge-dye": dict(MERGE, transport="dye"), "penalty-dye": dict(PENALTY, transport="dye"),
          "merge-tracers": dict(MERGE, **TRACERS), "penalty-tracers": dict(PENALTY, **TRACERS)}[case]
    jm, tm = meshes(12, 16)
    je = jspmd.ShardedEnsemble.build(jm, jspmd.build_device_mesh(8, data=2), B1S, B2S,
                                     config=jstokes.StokesConfig(**kw))
    te = spmd.ShardedEnsemble.build(tm, cpu_mesh(), B1S, B2S, config=tstokes.StokesConfig(**kw))
    s0 = numpy_state(je.initial_state())
    if "tracers" in s0:
        s0 = jittered_tracers(s0)
    return kw, je, te, s0, run_jax(je, s0)


@pytest.mark.parametrize("case", ["merge-dye", "merge-tracers", "penalty-dye", "penalty-tracers"])
def test_sharded_ensemble_matches_tpufem(jmesh, case):
    kw, je, te, s0, (want, want_metric) = color_pair(case)
    for k, v in numpy_state(te.initial_state()).items():
        if k != "tracers":  # the port's own lattice, before the jitter
            np.testing.assert_array_equal(v, s0[k], err_msg=k)
    got, metric = run_port(spmd.make_sharded_step(te), s0)
    penalty = case.startswith("penalty")
    atol = 2e-6 if penalty else 1e-8
    np.testing.assert_allclose(got["u"], want["u"], rtol=0, atol=atol)
    np.testing.assert_array_equal(got["step"], want["step"])
    if "c" in got:
        np.testing.assert_allclose(got["c"], want["c"], rtol=0, atol=atol)
        np.testing.assert_allclose(metric, want_metric, rtol=1e-6 if penalty else 1e-8)
    else:
        np.testing.assert_allclose(got["tracers"], want["tracers"], rtol=0, atol=atol)
        np.testing.assert_array_equal(got["tracer_status"], want["tracer_status"])
        np.testing.assert_array_equal(metric, want_metric)
    # each simulation against tpufem's single-device step on its own gait
    _, tm = meshes(12, 16)
    jm, _ = meshes(12, 16)
    for i, (b1, b2) in enumerate(zip(B1S, B2S)):
        jp = jstokes.StokesProblem.build(jm, jstokes.StokesConfig(B1=b1, B2=b2, **kw))
        st = jstokes.initial_state(jp)
        if "tracers" in st:
            st["tracers"] = jnp.asarray(s0["tracers"][i])
        step = jstokes.make_step(jp)
        for _ in range(STEPS):
            st, _ = step(st, None)
        single = numpy_state(st)
        assert rel(got["u"][i], single["u"]) < (1e-7 if penalty else 1e-12)
        if "tracers" in single:
            # dryrun_multichip's gate: within 1e-5 of the single-device
            # stepper's tracers, with equal status
            assert np.abs(got["tracers"][i] - single["tracers"]).max() < 1e-5
            np.testing.assert_array_equal(got["tracer_status"][i], single["tracer_status"])


def test_report_ensemble_matches_tpufem(jmesh):
    jm, tm = meshes(12, 16)
    je = jspmd.ShardedEnsemble.build(jm, jmesh, config=jstokes.StokesConfig(**REPORT),
                                     omegas=OMEGAS)
    te = spmd.ShardedEnsemble.build(tm, cpu_mesh(), config=tstokes.StokesConfig(**REPORT),
                                    omegas=OMEGAS)
    assert te.smooth_inv is not None
    s0 = numpy_state(je.initial_state())
    want, want_metric = run_jax(je, s0, 2)
    got, metric = run_port(spmd.make_sharded_step(te), s0, 2)
    np.testing.assert_allclose(got["u"], want["u"], rtol=0, atol=2e-6)
    np.testing.assert_allclose(got["c"], want["c"], rtol=0, atol=2e-6)
    np.testing.assert_allclose(metric, want_metric, rtol=0, atol=2e-5)
    for i, om in enumerate(OMEGAS):
        tp = tstokes.StokesProblem.build(tm, tstokes.StokesConfig(omega=om, **REPORT), device="cpu")
        st, m = tstokes.run(tp, steps=2)
        assert rel(got["u"][i], st["u"].numpy()) < 1e-12
        np.testing.assert_allclose(metric[i], m["final_div_max"][-1].item(), rtol=1e-12)


@functools.lru_cache(maxsize=None)
def jittered_meshes():
    """4 jittered geometry realizations in both packages: one node count,
    identical boundary index sets."""
    kw = dict(n_side=14, n_circle=16, pad_hole=True, jitter=0.15)
    return ([tpufem.generate_annulus_mesh(seed=s, **kw) for s in range(4)],
            [tpufem_torch.generate_annulus_mesh(seed=s, **kw) for s in range(4)])


def multimesh_arrays(ens) -> dict:
    """tpufem's ``MultiMeshEnsemble`` as the arrays ``interop.multimesh_from_numpy`` takes."""
    arrays = {k: np.asarray(getattr(ens, k))
              for k in ("inner_values", "visc_inv", "pressure_inv", "div_x", "div_y")}
    b = jstokes.StokesProblem.build(ens.meshes[0], ens.config).boundary
    arrays.update({f"boundary.{f}": np.asarray(getattr(b, f))
                   for f in ("walls", "inner", "dirichlet", "interior", "masters", "slaves")})
    if ens.locator is not None:
        loc = ens.locator
        arrays.update({"locator.rows": loc.rows, "locator.origins": loc.origins,
                       "locator.extents": loc.extents, "locator.coords": loc.coords,
                       "locator.g": np.asarray(loc.g)})
    if ens.tracer_init is not None:
        arrays["tracer_init"] = np.asarray(ens.tracer_init)
    return arrays


@pytest.mark.parametrize("tr", ["none", "dye", "tracers"])
def test_multimesh_ensemble_matches_tpufem(jmesh, tr):
    jms, tms = jittered_meshes()
    kw = dict(MERGE, transport=tr)
    je = jspmd.MultiMeshEnsemble.build(jms, jmesh, B1S, B2S, config=jstokes.StokesConfig(**kw))
    cfg = tstokes.StokesConfig(**kw)
    te = spmd.MultiMeshEnsemble.build(tms, cpu_mesh(), B1S, B2S, config=cfg)
    arrays = multimesh_arrays(je)
    for k in ("inner_values", "visc_inv", "pressure_inv", "div_x", "div_y"):
        np.testing.assert_array_equal(getattr(te, k).numpy(), arrays[k], err_msg=k)
    if tr != "none":
        assert te.locator.rows.shape[0] == 4
        for k in ("rows", "origins", "extents", "coords"):
            np.testing.assert_array_equal(getattr(te.locator, k).numpy(), arrays[f"locator.{k}"])
    s0 = numpy_state(je.initial_state())
    for k, v in numpy_state(te.initial_state()).items():
        np.testing.assert_array_equal(v, s0[k], err_msg=k)
    want, want_metric = run_jax(je, s0, 2)
    carried = interop.multimesh_from_numpy(arrays, tms, cpu_mesh(), cfg)
    for ens in (te, carried):
        got, metric = run_port(spmd.make_multimesh_step(ens), s0, 2)
        for k in got:
            if k in ("step", "tracer_status"):
                np.testing.assert_array_equal(got[k], want[k])
            else:
                assert rel(got[k], want[k]) < 1e-12, k
        np.testing.assert_allclose(metric, want_metric, rtol=1e-10)


def test_run_sharded_series_matches_tpufem(jmesh):
    """run_sharded's (steps, B) series, from tpufem's own scan, and the
    step-by-step loop of the port."""
    kw, je, te, s0, _ = color_pair("merge-tracers")
    want_state, want = jspmd.run_sharded(je, 5, {k: jnp.asarray(v) for k, v in s0.items()})
    state, series = spmd.run_sharded(te, 5, {k: torch.as_tensor(np.array(v)) for k, v in s0.items()})
    assert series.shape == (5, 4)
    np.testing.assert_array_equal(series.numpy(), np.asarray(want))
    np.testing.assert_allclose(state["tracers"].numpy(), np.asarray(want_state["tracers"]),
                               rtol=0, atol=1e-8)
    step = spmd.make_sharded_step(te)
    s = {k: torch.as_tensor(np.array(v)) for k, v in s0.items()}
    for i in range(5):
        s, m = step(s)
        np.testing.assert_array_equal(m.numpy(), series[i].numpy())
    np.testing.assert_array_equal(s["tracers"].numpy(), state["tracers"].numpy())


# Layouts of 8 positions (or 4): one device, two devices interleaved along
# "space" (row blocks joined by all_gather across devices), four data
# positions on four devices (four groups); each against 1 × 1.
LAYOUTS = {
    "2x4 one device": (2, ("cpu",) * 8),
    "1x4 two devices interleaved": (1, ("cpu:0", "cpu:1", "cpu:0", "cpu:1")),
    "4x1 four devices": (4, ("cpu:0", "cpu:1", "cpu:2", "cpu:3")),
    "2x2 rows on two devices": (2, ("cpu:0", "cpu:0", "cpu:1", "cpu:1")),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_does_not_matter(layout):
    """The positions and devices change where rows and elements are summed,
    not the result: each layout equals the 1 × 1 mesh (measured equal; held
    at 1e-14 relative)."""
    data, devices = LAYOUTS[layout]
    _, tm = meshes(12, 16)
    kw = dict(MERGE, **TRACERS)
    runs = []
    for dm in (spmd.build_device_mesh(devices=["cpu"], data=1),
               spmd.build_device_mesh(devices=list(devices), data=data)):
        ens = spmd.ShardedEnsemble.build(tm, dm, B1S, B2S, config=tstokes.StokesConfig(**kw))
        runs.append(spmd.run_sharded(ens, STEPS))
    (s1, m1), (s2, m2) = runs
    assert rel(s2["u"].numpy(), s1["u"].numpy()) < 1e-14
    assert np.abs(s2["tracers"].numpy() - s1["tracers"].numpy()).max() < 1e-14
    np.testing.assert_array_equal(m2.numpy(), m1.numpy())
    kw = dict(MERGE, transport="dye")
    jms, tms = jittered_meshes()
    runs = []
    for dm in (spmd.build_device_mesh(devices=["cpu"], data=1),
               spmd.build_device_mesh(devices=list(devices), data=data)):
        ens = spmd.MultiMeshEnsemble.build(tms, dm, B1S, B2S, config=tstokes.StokesConfig(**kw))
        runs.append(spmd.run_sharded(ens, 2))
    (s1, m1), (s2, m2) = runs
    assert rel(s2["u"].numpy(), s1["u"].numpy()) < 1e-14
    assert rel(s2["c"].numpy(), s1["c"].numpy()) < 1e-14


def test_batch_must_split_over_data():
    _, tm = meshes(12, 16)
    with pytest.raises(ValueError, match="do not split"):
        spmd.ShardedEnsemble.build(tm, cpu_mesh(data=2), B1S[:3], B2S[:3],
                                   config=tstokes.StokesConfig(**MERGE, transport="dye"))
    with pytest.raises(ValueError, match="solver='inverse'"):
        spmd.ShardedEnsemble.build(tm, cpu_mesh(), B1S, B2S, config=tstokes.StokesConfig())


def test_ensemble_interop_and_own_build_equal_tpufem(jmesh):
    """The port run on tpufem's ensemble arrays equals the port's own build,
    whose arrays equal tpufem's."""
    kw, je, te, s0, _ = color_pair("merge-dye")
    jm, tm = meshes(12, 16)
    arrays = jax_problem_arrays(je.problem)
    arrays.update({f"ensemble.{k}": np.asarray(getattr(je, k))
                   for k in ("inner_values", "visc_inv", "pressure_inv")})
    for k in ("inner_values", "visc_inv", "pressure_inv"):
        np.testing.assert_array_equal(getattr(te, k).numpy(), arrays[f"ensemble.{k}"], err_msg=k)
    carried = interop.ensemble_from_numpy(arrays, tm, cpu_mesh(), tstokes.StokesConfig(**kw))
    a, _ = run_port(spmd.make_sharded_step(carried), s0)
    b, _ = run_port(spmd.make_sharded_step(te), s0)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _swirl(coords: np.ndarray) -> np.ndarray:
    x, y = coords[..., 0], coords[..., 1]
    return np.stack([0.8 * np.sin(np.pi * y) + 0.3, 0.5 * np.sin(2 * np.pi * x)], axis=-1)


def test_batched_transport_equals_loop_and_tpufem():
    jms, tms = jittered_meshes()
    jl = jtr.BatchedGridLocator.build(jms)
    tl = ttr.BatchedGridLocator.build(tms, device="cpu")
    for k in ("rows", "origins", "extents", "coords"):
        np.testing.assert_array_equal(getattr(tl, k).numpy(), getattr(jl, k), err_msg=k)
    assert tl.g == jl.g
    rng = np.random.default_rng(3)
    u = _swirl(jl.coords) * rng.uniform(0.5, 1.5, (4, 1, 1))
    c = (jl.coords[..., 0] < 0.5).astype(np.float64)
    grid = jtr.init_tracer_grid(15)
    pts = jittered(np.broadcast_to(grid, (4,) + grid.shape).copy(), seed=4)
    jt, tt = jl.tables(jnp.float64), tl.tables()
    tu, tc, tp = (torch.as_tensor(a) for a in (u, c, pts))
    c_t = ttr.advect_semilagrange_batched(*tt, tl.g, tc, tu, 0.05)
    c_j = jtr.advect_semilagrange_batched(*jt, jl.g, jnp.asarray(c), jnp.asarray(u), 0.05)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0, atol=1e-12)
    for method in ("euler", "rk2"):
        p_t = ttr.tracer_step_batched(*tt[:3], tl.g, tp, tu, 0.05, method=method)
        p_j = jtr.tracer_step_batched(*jt[:3], jl.g, jnp.asarray(pts), jnp.asarray(u), 0.05,
                                      method=method)
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0, atol=1e-12)
        for i, m in enumerate(tms):
            single = ttr.GridLocator.build(m, g=tl.g).with_cmax(tl.rows.shape[-1] // 10)
            np.testing.assert_array_equal(
                p_t[i].numpy(), ttr.tracer_step(m, single, tp[i], tu[i], 0.05, method=method).numpy())
            if method == "euler":
                np.testing.assert_array_equal(
                    c_t[i].numpy(), ttr.advect_semilagrange(m, single, tc[i], tu[i], 0.05).numpy())


def test_with_cmax_matches_tpufem_and_is_inert():
    jm, tm = meshes(12, 16)
    jl = jtr.GridLocator.build(jm, g=12)
    tl = ttr.GridLocator.build(tm, g=12)
    c_max = tl.cells.shape[1] + 3
    padded = tl.with_cmax(c_max)
    np.testing.assert_array_equal(padded.cells, jl.with_cmax(c_max).cells)
    np.testing.assert_array_equal(padded.rows.numpy(), jl.with_cmax(c_max).rows)
    assert tl.with_cmax(tl.cells.shape[1]) is tl
    with pytest.raises(ValueError):
        tl.with_cmax(tl.cells.shape[1] - 1)
    pts = torch.as_tensor(np.random.default_rng(0).uniform(0.02, 0.98, (200, 2)))
    for a, b in zip(tl.find(pts, return_weights=True), padded.find(pts, return_weights=True)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


SWEEP = dict(steps=150, tracer_density=12, precision="f32")


def test_sharded_sweep_matches_tpufem():
    """The one-program campaign at f32 against tpufem's (its ensemble's
    state is float64, the port's f32) and the port's sequential sweep:
    eaten counts within 2, tpufem's own gate; one gait a card (here
    ``cpu:0``–``cpu:2``) equals all gaits on one device."""
    if len(jax.devices()) < 6:
        pytest.skip("needs 6 virtual devices")
    from jax.sharding import Mesh as JDeviceMesh

    jm, tm = meshes(12, 16)
    want = jsweep.food_capture_sweep_sharded(
        jm, JDeviceMesh(np.asarray(jax.devices()[:6]).reshape(3, 2), ("data", "space")),
        jsweep.SweepConfig(**SWEEP))
    cfg = tsweep.SweepConfig(**SWEEP)
    got = tsweep.food_capture_sweep_sharded(tm, cpu_mesh(3, ("cpu",) * 6), cfg)
    per_card = tsweep.food_capture_sweep_sharded(tm, cpu_mesh(3, ("cpu:0", "cpu:1", "cpu:2")), cfg)
    seq = tsweep.food_capture_sweep(tm, cfg, device="cpu")
    assert list(got) == list(want) == [0.0, -5.0, 5.0]
    for b2, w in want.items():
        assert got[b2]["tracers"] == w["tracers"] == seq[b2]["tracers"]
        assert abs(got[b2]["eaten"] - w["eaten"]) <= 2, b2
        assert abs(got[b2]["eaten"] - seq[b2]["eaten"]) <= 2, b2
        assert per_card[b2] == got[b2]
    assert len({g["eaten"] for g in got.values()}) > 1
    with pytest.raises(ValueError, match="data=3"):
        tsweep.food_capture_sweep_sharded(tm, cpu_mesh(2), cfg)
