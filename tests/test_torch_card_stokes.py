"""The Stokes workload's paths on the card, each held against the port's CPU
path or against tpufem's gates (``bench_large.physics_report``): the dense
step on K1, the grid step (K2, K3) replayed from its captured graph, K5,
the renumbered grid path, tracers, the Eulerian and griddata dyes, the
"report" variant, the stencil and banded storages and K3's bf16 planes."""

import dataclasses

import numpy as np
import pytest
import torch

from _card import (BIG, CPU, EUL_PENALTY_C_RTOL, K5_PARITY_RTOL, MID, PARITY, PB16_F64_U_GAP,
                   SMALL, STORAGE_APPLY_RTOL, STORAGE_F64_RTOL, annulus, assert_finite,
                   assert_replays_eager, cached, card, card_and_cpu, counting, deterministic,
                   k5_problem, max_abs, rel, run_sharded_steps, stokes_grid)
from tpufem_torch import bench_large
from tpufem_torch.bench import bench_config, bench_mesh
from tpufem_torch.ops import assembly, calculus
from tpufem_torch.ops.gridop import GridOperator
from tpufem_torch.ops.stencil import StencilOperator
from tpufem_torch.parallel import build_device_mesh, make_sharded_matfree_step
from tpufem_torch.solve import grid_cg
from tpufem_torch.solve.pressure import owner_map
from tpufem_torch.workloads import navier_stokes, stokes

assert card and deterministic  # fixtures, imported for the tests below
pytestmark = pytest.mark.card

SCALE_STEPS = 200


def test_dense_step_runs_on_k1(card):
    """The bench configuration (fused f32 step, ~10k tracers), 1000 steps:
    K1 once a step, tpufem's boundedness gate, the divergence falls."""
    cfg = bench_config()
    problem = stokes.StokesProblem.build(bench_mesh(), cfg, device=card)
    with counting() as n:
        state, metrics = stokes.run(problem, steps=1000)
    assert n == {"K1": 1000, "eager_steps": 1000}
    assert_finite(state, metrics)
    assert float(metrics["max_u"].max()) < bench_large.MAX_U_FACTOR * (abs(cfg.B1) + abs(cfg.B2))
    assert float(metrics["final_div_max"][-1]) < float(metrics["div_star_max"][0])


def test_dense_step_card_against_cpu(card):
    """f64 card against f64 CPU over 50 steps, tracers moved off the mesh
    edges (containment there is a knife-edge tie); f32 against f64."""
    mesh, runs = bench_mesh(), {}
    for name, device, precision in (("card", card, "f64"), ("cpu", CPU, "f64"),
                                    ("f32", card, "f32")):
        problem = stokes.StokesProblem.build(mesh, bench_config(precision=precision),
                                             device=device)
        state = stokes.initial_state(problem)
        pts = problem.tracer_init + 1e-3 * np.random.default_rng(42).standard_normal(
            problem.tracer_init.shape)
        state["tracers"] = torch.as_tensor(pts, dtype=problem.dtype, device=device)
        state, metrics = stokes.run(problem, steps=50, state=state)
        runs[name] = state, float(metrics["eaten"][-1]) / problem.tracer_init.shape[0]
    (g, g_eaten), (c, _), (f, f_eaten) = runs["card"], runs["cpu"], runs["f32"]
    assert rel(g["u"], c["u"]) <= 1e-10
    assert max_abs(g["tracers"], c["tracers"]) <= 1e-8
    assert torch.equal(g["tracer_status"].cpu(), c["tracer_status"])
    assert rel(f["u"], g["u"]) <= 5e-3
    assert abs(f_eaten - g_eaten) <= 0.05


def test_semi_lagrangian_dye_on_the_fused_step(card):
    cfg = stokes.StokesConfig(transport="dye", solver="inverse", precision="f32",
                              pressure_mode="merge", fused=True, matvec_impl="pallas")
    problem = stokes.StokesProblem.build(bench_mesh("mesh.1", fallback=(20, 24)), cfg,
                                         device=card)
    state, metrics = stokes.run(problem, steps=200)
    assert float(state["c"].min()) >= -1e-6 and float(state["c"].max()) <= 1 + 1e-6
    assert bool(torch.isfinite(metrics["mixing_progress"]).all())


def test_scale_step_replays_its_graph(card, deterministic):
    """The Scale configuration at 10⁶ nodes: 200 steps from rest and 200
    continued, each call bit-equal to the eager loop; tpufem's gates."""
    problem = stokes_grid(card, *BIG)
    state, metrics = assert_replays_eager(problem, SCALE_STEPS)
    state2, metrics2 = assert_replays_eager(problem, SCALE_STEPS, state)
    assert_finite(state, state2, metrics, metrics2)
    bench_large.physics_report(problem, state, metrics, SCALE_STEPS)


@pytest.mark.parametrize("tol", [0.0, 1e-5])
@pytest.mark.parametrize("step", ["unfused", "k5"])
def test_grid_step_card_against_cpu(card, step, tol):
    """The grid path at n_side=40, 10 steps, fixed iterations and tol 1e-5:
    f64 on the card (kernels) against the CPU (plain versions); f32 against
    f64 on the card."""
    kw = dict(cg_tol_pressure=tol, cg_tol_visc=tol)
    if step == "k5":
        kw["grid_steps_per_call"] = 1
    u = []
    for device, precision in ((card, "f64"), (CPU, "f64"), (card, "f32")):
        problem = stokes_grid(device, *PARITY, precision=precision, **kw)
        assert (problem.grid_step is not None) == (step == "k5")
        u.append(stokes.run(dataclasses.replace(problem), steps=10)[0]["u"])
    g, c, f = u
    assert max_abs(g, c) <= 1e-6
    if step == "k5":
        assert rel(g, c) <= K5_PARITY_RTOL[tol]
    assert rel(f, g) <= 5e-3


@pytest.mark.parametrize("step", ["unfused", "k5"])
def test_tracers_on_the_grid_step(card, step):
    """78,400 nodes, 200 steps; K5 once a step."""
    kw = dict(grid_steps_per_call=1) if step == "k5" else {}
    problem = stokes_grid(card, 280, 320, transport="tracers", **kw)
    assert (problem.grid_step is not None) == (step == "k5")
    with counting() as n:
        state, metrics = stokes.run(problem, steps=200)
    if step == "k5":
        assert n["K5"] == 200
    assert_finite(state, metrics)
    assert 0.0 <= float(metrics["eaten"][-1]) / problem.tracer_init.shape[0] <= 1.0


@pytest.mark.parametrize("k", [1, 4])
def test_k5_step_at_scale(card, k):
    """K5 at K steps a launch, 200 steps from rest and 200 continued:
    steps/K launches, none of K2 or K3; tpufem's gates."""
    problem, _ = bench_large.with_iteration_counters(k5_problem(card, *BIG, k))
    with counting() as n:
        state, metrics = stokes.run(problem, steps=SCALE_STEPS)
        state2, _ = stokes.run(problem, steps=SCALE_STEPS, state=state)
    assert n == {"K5": 2 * SCALE_STEPS // k, "eager_steps": 2 * SCALE_STEPS}
    assert_finite(state, state2, metrics)
    bench_large.physics_report(problem, state, metrics, SCALE_STEPS)


# (mesh, tpufem's gate): a compacted mesh renumbered onto 280² on the host
# (gridify) under the "imported" gate, and 160,000 nodes
RASTERS = {"gridify": ((280, 320, False), "imported"), "160k": ((*MID, True), "stokes")}


@pytest.mark.parametrize("step", ["unfused", "k5"])
@pytest.mark.parametrize("raster", RASTERS)
def test_grid_step_on_other_rasters(card, deterministic, raster, step):
    """200 steps from rest and 200 more: the unfused step replayed, K5 once
    a step; tpufem's gate; the renumbered u pulled back to the input's nodes."""
    (n_side, n_circle, pad_hole), gate = RASTERS[raster]
    kw = dict(grid_steps_per_call=1) if step == "k5" else {}
    problem = stokes_grid(card, n_side, n_circle, pad_hole, **kw)
    mesh, g = annulus(n_side, n_circle, pad_hole), problem.gridified
    assert problem.mesh.n_nodes == (g.ns ** 2 if g is not None else mesh.n_nodes)
    assert (problem.grid_step is not None) == (step == "k5")
    if step == "k5":
        with counting() as n:
            state, metrics = stokes.run(problem, steps=SCALE_STEPS)
            stokes.run(problem, steps=SCALE_STEPS, state=state)
        assert n == {"K5": 2 * SCALE_STEPS, "eager_steps": 2 * SCALE_STEPS}
    else:
        state, metrics = assert_replays_eager(problem, SCALE_STEPS)
        assert_replays_eager(problem, SCALE_STEPS, state)
    bench_large.physics_report(problem, state, metrics, SCALE_STEPS, gate=gate)
    if g is not None:
        assert g.pull(state["u"].double().cpu().numpy()).shape == (mesh.n_nodes, 2)


def test_eulerian_dye_at_scale(card):
    """The Scale configuration with Eulerian dye at 10⁶ nodes, 15 steps from
    rest and 15 continued: unfused, K2 once and K3 twice a step; tpufem's
    gates, c in [0, 1], the mixing advancing."""
    problem = stokes_grid(card, *BIG, transport="eulerian_dye")
    assert isinstance(problem.visc_solver, grid_cg.ViscousGridCG) and problem.grid_step is None
    with counting() as n:
        state, metrics = stokes.run(problem, steps=15)
        state2, _ = stokes.run(problem, steps=15, state=state)
    assert n == {"K2": 30, "K3": 60, "eager_steps": 30}
    bench_large.physics_report(problem, state, metrics, 15)
    c = state2["c"]
    assert bool(torch.isfinite(c).all()) and float(c.min()) >= 0.0 and float(c.max()) <= 1.0
    assert float(metrics["mixing_progress"][-1]) > 0.0


def test_eulerian_dye_card_against_cpu(card):
    """f64: the dense penalty path (u tightly; c as far as the ±1e10 penalty
    holds it) and the grid path (kernels against plain versions)."""
    g, c = card_and_cpu(annulus(12, 16), 20, card, dt=0.01, nu=1.0, transport="eulerian_dye")
    assert rel(g["u"], c["u"]) <= 1e-8 and rel(g["c"], c["c"]) <= EUL_PENALTY_C_RTOL
    runs = []
    for device in (card, CPU):
        problem = stokes_grid(device, *PARITY, precision="f64", transport="eulerian_dye")
        with counting() as n:
            state, _ = stokes.run(problem, steps=10)
        runs.append((state, n))
    (g, n_card), (c, n_cpu) = runs
    assert n_card == {"K2": 10, "K3": 20, "eager_steps": 10} and n_cpu == {"eager_steps": 10}
    assert max_abs(g["u"], c["u"]) <= 1e-6 and max_abs(g["c"], c["c"]) <= 1e-6


def test_eulerian_dye_f32_against_f64(card):
    """The dense merged path on the card, 200 steps."""
    kw = dict(transport="eulerian_dye", solver="inverse", pressure_mode="merge")
    c = {p: stokes.run(stokes.StokesProblem.build(bench_mesh(), stokes.StokesConfig(
        precision=p, **kw), device=card), steps=200)[0]["c"] for p in ("f64", "f32")}
    assert rel(c["f32"], c["f64"]) <= 5e-3


REPORT = dict(variant="report", bc_kind="rotating", dt=1e-5, ramp_steps=200,
              pressure_smoothing=0.01, double_projection=False)  # tpufem's CLI configuration
DENSE_DYE = dict(dt=0.01, nu=1.0, solver="inverse", pressure_mode="merge")
# (mesh, steps, configuration, limit on u's relative L2 and, for the dyes,
# on c's max abs)
VARIANTS = {
    "report": (bench_mesh, 50, REPORT, 1e-8),
    "report-csr": (lambda: annulus(*PARITY), 10, dict(REPORT, solver="cg", cg_storage="csr"),
                   1e-9),
    "griddata": (bench_mesh, 20, dict(DENSE_DYE, transport="dye_griddata"), 1e-10),
    "dense_ops-off": (bench_mesh, 20, dict(DENSE_DYE, dense_ops=False, transport="dye"), 1e-10),
}


@pytest.mark.parametrize("variant", VARIANTS)
def test_variants_card_against_cpu(card, variant):
    mesh, steps, kw, limit = VARIANTS[variant]
    g, c = card_and_cpu(mesh(), steps, card, **kw)
    assert rel(g["u"], c["u"]) <= limit
    if kw.get("transport", "").startswith("dye"):
        assert max_abs(g["c"], c["c"]) <= limit


def test_report_variant_runs_1000_steps(card):
    problem = stokes.StokesProblem.build(bench_mesh(), stokes.StokesConfig(**REPORT), device=card)
    assert bool(torch.isfinite(stokes.run(problem, steps=1000)[0]["u"]).all())


@cached
def scale_operators(device) -> dict:
    """The Scale step's four operators at 10⁶ nodes as CSR in its dtype:
    the stiffness, the merged periodic pressure operator, Dx and Dy."""
    problem = stokes_grid(device, *BIG)
    mesh, boundary = problem.mesh, problem.boundary
    ke = assembly.element_stiffness(mesh)
    owner = owner_map(mesh.n_nodes, boundary.masters, boundary.slaves)
    merged = dataclasses.replace(mesh, tris=owner[mesh.tris].astype(np.int32))
    dx, dy = calculus.divergence_csr_operators(mesh)
    ops = {"K": assembly.assemble_csr(mesh, ke), "K_merged": assembly.assemble_csr(merged, ke),
           "Dx": dx, "Dy": dy}
    return {k: op.astype(problem.dtype, device) for k, op in ops.items()}


@pytest.mark.parametrize("operator", ["K", "K_merged", "Dx", "Dy"])
def test_stencil_and_grid_split_applies_against_csr(card, operator):
    """Each of the Scale step's operators at 10⁶ nodes on the stencil and on
    the card's grid split (its plain apply), f32."""
    csr = scale_operators(card)[operator]
    n = stokes_grid(card, *BIG).mesh.n_nodes
    x = torch.randn(n, generator=torch.Generator(device=card).manual_seed(7), device=card)
    want = csr.matvec(x)
    ns = int(round(n ** 0.5))
    for op in (StencilOperator.build(csr, device=card),
               GridOperator.dense_split(csr, ns, device=card)):
        assert rel(op.matvec(x), want) <= STORAGE_APPLY_RTOL


def test_scale_divgrad_on_stencil_and_csr(card, deterministic):
    """The Scale step with its div/grad on the stencil (Dx and Dy in one
    pass, as built), on the stencil as two applies and on CSR: u after 20
    steps from rest within 1e-5 of CSR's; each replayed bit-equal to its
    eager loop, and a second call replays with no capture and no launch."""
    big = stokes_grid(card, *BIG)
    assert type(big.mf_pair).__name__ == "StencilPair"
    dx, dy = calculus.divergence_csr_operators(big.mesh)

    def unpaired(p):
        p.__dict__["mf_pair"] = None  # the cached pair, left out
        return p

    variants = {"stencil": (big, None), "stencil unpaired": (big, unpaired),
                "csr": (dataclasses.replace(big, mf_dx=dx.astype(big.dtype, big.device),
                                            mf_dy=dy.astype(big.dtype, big.device)), None)}
    u = {}
    for label, (problem, adapt) in variants.items():
        state, _ = assert_replays_eager(problem, 20, adapt=adapt)
        u[label] = state["u"]
        again = (adapt or (lambda p: p))(dataclasses.replace(problem))
        stokes.run(again, steps=20, state=state)
        with counting() as n:
            stokes.run(again, steps=20, state=state)
        assert n == {"replays": 20}, label
    assert max(rel(u[k], u["csr"]) for k in ("stencil", "stencil unpaired")) <= 1e-5


@pytest.mark.parametrize("path", ["stokes-stencil", "stokes-csr", "stokes-banded", "ns-stencil",
                                  "ns-csr"])
def test_plain_storages_at_160k(card, path):
    """Stokes (``bench_config``, 20 steps and 20 more) and NS (tpufem's
    ``run_ns`` configuration and gates) at 160,000 nodes on the plain
    storages: finite, and none of the port's kernels launched."""
    workload, storage = path.split("-")
    mesh = annulus(*MID, pad_hole=True)
    if workload == "ns":
        problem = navier_stokes.NSProblem.build(mesh, bench_large.ns_config(storage=storage),
                                                device=card)
        with counting() as n:
            bench_large.run_ns_problem(problem, 20)  # raises on a failed gate
        # the stencil's C(u) refill takes kernel E, as the grid path's does
        assert n == ({"E": 40} if storage == "stencil" else {})
        return
    problem = stokes.StokesProblem.build(
        mesh, bench_large.bench_config(n_nodes=mesh.n_nodes, storage=storage), device=card)
    with counting() as n:
        state, metrics = stokes.run(problem, steps=20)
        state, _ = stokes.run(problem, steps=20, state=state)
    assert n == {"eager_steps": 40}
    assert_finite(state, metrics)


FIXED = dict(solver="cg", precision="f64", cg_tol_pressure=0.0, cg_tol_visc=0.0,
             cg_precond="twolevel", cg_iters_visc=30, cg_iters_pressure=60)
# the sharded step's stencil and banded branches run fixed iteration counts
SHARDED_HALO = dict(solver="cg", cg_iters_visc=30, cg_iters_pressure=60, cg_warm_start=False,
                    transport="none", precision="f64")


def storage_u(case: str, device) -> torch.Tensor:
    """u after 10 steps (the sharded step: 3, on 4 strips) on ``device``."""
    workload, storage, pad = case.split("-")
    mesh = annulus(*PARITY, pad_hole=pad == "hole")
    if workload == "stokes":
        problem = stokes.StokesProblem.build(mesh, stokes.StokesConfig(cg_storage=storage, **FIXED),
                                             device=device)
        return stokes.run(problem, steps=10)[0]["u"]
    if workload == "ns":
        cfg = navier_stokes.NSConfig(dt=1e-4, solver="cg", precision="f64", cg_storage=storage,
                                     cg_tol=0.0, cg_iters_visc=30, cg_iters_pressure=120)
        problem = navier_stokes.NSProblem.build(mesh, cfg, device=device)
        assert type(problem.K_csr).__name__ == "StencilOperator" and problem.conv_refill is not None
        return navier_stokes.run(problem, steps=10)[0]
    dm = build_device_mesh(devices=[device] * 4, data=1)
    problem = stokes.StokesProblem.build(
        mesh, stokes.StokesConfig(cg_storage=storage, **SHARDED_HALO), device=dm.axis_devices()[0])
    step = make_sharded_matfree_step(dm, problem)
    with counting() as n:
        u, _ = run_sharded_steps(step, stokes.initial_state(problem)["u"], 3)
    assert n == {}
    return u


@pytest.mark.parametrize("case", ["stokes-stencil-hole", "stokes-stencil-plain",
                                  "stokes-banded-plain", "ns-stencil-hole",
                                  "sharded-stencil-hole", "sharded-banded-plain"])
def test_plain_storages_card_against_cpu(card, case):
    """f64 at fixed iterations on ``generate_annulus_mesh(40, 48)``, with and
    without the hole; the sharded step on 4 strips."""
    assert rel(storage_u(case, card), storage_u(case, CPU)) <= STORAGE_F64_RTOL


def test_sharded_stencil_step_at_160k(card):
    """The sharded step on its stencil branch, 4 strips on one card, f32."""
    mesh = annulus(*MID, pad_hole=True)
    problem = stokes.StokesProblem.build(
        mesh, bench_large.bench_config(n_nodes=mesh.n_nodes, storage="stencil"), device=card)
    step = make_sharded_matfree_step(build_device_mesh(devices=[card] * 4, data=1), problem)
    u, _ = step(stokes.initial_state(problem)["u"])
    with counting() as n:
        u, _ = run_sharded_steps(step, u, 3)
    assert n == {} and bool(torch.isfinite(u).all())


def pb16_launches() -> int:
    return grid_cg.pressure_cg.variant_launches["pb16"]


def test_bf16_planes_on_the_scale_step(card, deterministic):
    """The Scale cell "off" and "on" (``cg_precond_bf16``): u apart after 20
    steps from rest; 200 steps from rest under tpufem's gates; 20 more
    replayed bit-equal to the eager loop, which launches the bf16-plane K3
    twice a step "on" and never "off"."""
    runs = {"off": stokes_grid(card, *BIG), "on": stokes_grid(card, *BIG, cg_precond_bf16="on")}
    u = {k: stokes.run(dataclasses.replace(p), steps=20)[0]["u"] for k, p in runs.items()}
    # both repeat bit-equal (the kernels' tests), so any gap is the planes'
    assert rel(u["on"], u["off"]) > 0
    for label, problem in runs.items():
        state, metrics = stokes.run(dataclasses.replace(problem), steps=SCALE_STEPS)
        assert_finite(state, metrics)
        bench_large.physics_report(problem, state, metrics, SCALE_STEPS)
        before = pb16_launches()
        assert_replays_eager(problem, 20, state)
        # the capture's warm-up step and the capture, then 20 eager steps
        assert pb16_launches() - before == (2 * (2 + 20) if label == "on" else 0), label


def test_bf16_planes_move_u_at_f64(card, deterministic):
    """At f64 on n_side=20, streamed, "off" and "on": 20 steps replayed
    bit-equal to the eager loop, the bf16-plane K3 twice a step "on"; u
    "on" apart from "off" by more than roundoff."""
    u = {}
    for mode in ("off", "on"):
        problem = stokes_grid(card, *SMALL, cg_coarse_nodes=64, cg_stream_diags="on",
                              cg_precond_bf16=mode, precision="f64")
        before = pb16_launches()
        u[mode] = assert_replays_eager(problem, 20)[0]["u"]
        assert pb16_launches() - before == (2 * (2 + 20) if mode == "on" else 0)
    assert bool(torch.isfinite(u["on"]).all()) and rel(u["on"], u["off"]) >= PB16_F64_U_GAP
