"""The gait campaign, the ensembles (``ShardedEnsemble``,
``MultiMeshEnsemble``), the TopK locator and the bf16 fused step on the
card: against the port's CPU path at f64 and under tpufem's gates (its
``dryrun_multichip``'s).  None of them runs a kernel of the port but K1."""

import dataclasses

import numpy as np
import pytest
import torch

from _card import (BF16_RTOL, CPU, ENS_RTOL, annulus, cached, card, card_and_cpu, counting,
                   kernels, rel)
from tpufem_torch import bench_large
from tpufem_torch.bench import bench_config, bench_mesh, profile_run
from tpufem_torch.ops import assembly, calculus
from tpufem_torch.parallel import (MultiMeshEnsemble, ShardedEnsemble, build_device_mesh,
                                   make_multimesh_step, make_sharded_step, run_sharded)
from tpufem_torch.workloads import stokes, sweep

assert card  # the fixture, imported for the tests below
pytestmark = pytest.mark.card

GAIT = dict(dt=0.01, nu=1.0, B1=-2.0)
CAMPAIGN_MESH = (33, 48)  # 852 nodes, 488 tracers


@cached
def campaign(device, steps: int, precision: str = "f32") -> tuple:
    """``sweep.food_capture_sweep`` at ``steps`` of its 6000 steps a gait →
    (results, the kernels it launched)."""
    cfg = dataclasses.replace(sweep.SweepConfig(), steps=steps, precision=precision)
    with counting() as n:
        results = sweep.food_capture_sweep(annulus(*CAMPAIGN_MESH), cfg, device=device)
    return results, kernels(n)


def test_campaign_runs_on_k1(card):
    """Three gaits × 1500 steps on the fused f32 step: K1 once a step of
    every gait and no other kernel; each fraction in [0, 1]."""
    results, launched = campaign(card, 1500)
    assert launched == {"K1": 3 * 1500}
    assert all(0.0 <= r["consumed_fraction"] <= 1.0 for r in results.values())


def test_campaign_card_against_cpu(card):
    """300 steps a gait: f32 on the card against f64 on the CPU."""
    gpu, host = campaign(card, 300)[0], campaign(CPU, 300, "f64")[0]
    for b2 in gpu:
        assert abs(gpu[b2]["consumed_fraction"] - host[b2]["consumed_fraction"]) <= 0.05, b2


def test_campaign_as_one_sharded_program(card):
    """One gait a "data" position on the card: the fractions within 0.05 of
    the sequential campaign's at 1500 steps, the eaten counts within 2 of
    its f32 ones at 300 (tpufem's own gate); no kernel of the port."""
    mesh, gaits = annulus(*CAMPAIGN_MESH), len(sweep.SweepConfig().b2_values)
    dm = build_device_mesh(devices=[card] * gaits, data=gaits)
    for steps, key, limit in ((1500, "consumed_fraction", 0.05), (300, "eaten", 2)):
        with counting() as n:
            res = sweep.food_capture_sweep_sharded(
                mesh, dm, dataclasses.replace(sweep.SweepConfig(), steps=steps))
        assert not kernels(n)
        seq = campaign(card, steps)[0]
        for b2, r in res.items():
            assert abs(r[key] - seq[b2][key]) <= limit, (steps, b2)


def ensemble_gates(meshes, u: torch.Tensor, b2s) -> None:
    """tpufem's dryrun_multichip gates on each simulation (its own mesh or
    one shared): max|u| < 1.25·(|B1| + |B2|) and the normalized divergence
    below the Scale gate."""
    rels = []
    for i, b2 in enumerate(b2s):
        mesh = meshes[i] if isinstance(meshes, list) else meshes
        ui = u[i].double().cpu()
        div = calculus.divergence(mesh, ui).numpy()
        ml = assembly.lumped_mass(mesh).numpy()
        h = float(np.sqrt(2.0 * np.median(mesh.area)))
        u_l2 = float(np.sqrt((ml * (ui.numpy() ** 2).sum(axis=1)).sum()))
        rels.append(float(np.sqrt((ml * div ** 2).sum())) * h / max(u_l2, 1e-30))
        assert float(ui.abs().max()) < bench_large.MAX_U_FACTOR * (abs(GAIT["B1"]) + abs(float(b2)))
    assert max(rels) < bench_large.DIV_REL_GATES["stokes"]


def jitter_tracers(state: dict) -> np.ndarray:
    """The ensemble's tracer lattice moved off the mesh edges (one draw for
    every simulation, σ 1e-3, seed 42) → the points."""
    pts = state["tracers"][0].double().cpu().numpy()
    pts = pts + 1e-3 * np.random.default_rng(42).standard_normal(pts.shape)
    t = state["tracers"]
    state["tracers"] = torch.as_tensor(np.broadcast_to(pts, t.shape).copy(), dtype=t.dtype,
                                       device=t.device)
    return pts


TRACERS = stokes.StokesConfig(dt=0.01, nu=1.0, transport="tracers", tracer_density=12,
                              solver="inverse", pressure_mode="merge")


def test_sharded_ensemble_gates(card):
    """8 positions on the card (data 2 × space 4), f64 penalty dye on
    (40, 48): the divergence falls step over step, the gates after 10
    steps; on (12, 16) the jittered tracer ensemble within 1e-5 of the
    single-device stepper after 3 steps, with its statuses."""
    dmesh = build_device_mesh(devices=[card] * 8, data=2)
    b2s = np.linspace(-5.0, 5.0, 2)
    mesh = annulus(40, 48)
    with counting() as n:
        ens = ShardedEnsemble.build(mesh, dmesh, np.full(2, GAIT["B1"]), b2s)
        step = make_sharded_step(ens)
        state, d1 = step(ens.initial_state())
        state, d2 = step(state)
        d1, d2 = d1.double().cpu().numpy(), d2.double().cpu().numpy()
        assert np.isfinite(d1).all() and np.isfinite(d2).all() and (d2 < d1).all()
        for _ in range(8):
            state, _ = step(state)
        ensemble_gates(mesh, state["u"], b2s)
        small = annulus(12, 16)
        ens = ShardedEnsemble.build(small, dmesh, np.full(2, GAIT["B1"]), b2s, config=TRACERS)
        st = ens.initial_state()
        pts = jitter_tracers(st)
        st, _ = run_sharded(ens, 3, st)
        one = stokes.StokesProblem.build(small, dataclasses.replace(
            TRACERS, B1=GAIT["B1"], B2=float(b2s[0])), device=card)
        st0 = stokes.initial_state(one)
        st0["tracers"] = torch.as_tensor(pts, dtype=st0["tracers"].dtype, device=card)
        step0 = stokes.make_step(one)
        for _ in range(3):
            st0, _ = step0(st0)
    assert float((st["tracers"][0] - st0["tracers"]).abs().max()) < 1e-5
    assert torch.equal(st["tracer_status"][0], st0["tracer_status"])
    assert not kernels(n)


def ensemble_card_and_cpu(card, build, jitter: bool) -> list:
    """``run_sharded`` of ``build(device mesh)`` on 2 × 4 positions, 10 steps,
    on the card and on the CPU from one initial state → [(state, metric)] × 2."""
    out = []
    for d in (card, CPU):
        ens = build(build_device_mesh(devices=[d] * 8, data=2))
        state = ens.initial_state()
        if jitter:
            jitter_tracers(state)
        out.append(run_sharded(ens, 10, state))
    return out


def assert_ensemble_close(runs) -> None:
    """Every field within ENS_RTOL (relative L2; tracers max abs, statuses
    equal; a zero metric max abs)."""
    (g, gm), (c, cm) = runs
    for k in g:
        if k == "tracers":
            assert float((g[k].cpu() - c[k]).abs().max()) <= ENS_RTOL
        elif g[k].is_floating_point():
            assert rel(g[k], c[k]) <= ENS_RTOL, k
    if "tracers" in g:
        assert torch.equal(g["tracer_status"].cpu(), c["tracer_status"])
    err = rel(gm, cm) if float(cm.abs().max()) > 0 else float((gm.cpu() - cm).abs().max())
    assert err <= ENS_RTOL


B2S = np.array([0.0, 5.0, -5.0, 2.0])
REPORT = stokes.StokesConfig(variant="report", bc_kind="rotating", solver="inverse",
                             pressure_mode="penalty", ramp_steps=10, pressure_smoothing=0.01,
                             transport="dye", dt=1e-3, nu=0.1)
ENSEMBLES = {
    "color-dye": (False, lambda dm: ShardedEnsemble.build(
        annulus(12, 16), dm, np.full(4, GAIT["B1"]), B2S,
        config=stokes.StokesConfig(solver="inverse", pressure_mode="merge", transport="dye"))),
    "color-tracers": (True, lambda dm: ShardedEnsemble.build(
        annulus(12, 16), dm, np.full(4, GAIT["B1"]), B2S, config=TRACERS)),
    "report-rotating": (False, lambda dm: ShardedEnsemble.build(
        annulus(12, 16), dm, config=REPORT, omegas=np.array([2.0, 5.0, -3.0, 8.0]))),
    # four jittered pad_hole meshes, one each
    **{f"multimesh-{tr}": (tr == "tracers", lambda dm, tr=tr: MultiMeshEnsemble.build(
        [annulus(14, 16, pad_hole=True, jitter=0.15, seed=k) for k in range(4)], dm,
        np.full(4, GAIT["B1"]), B2S,
        config=stokes.StokesConfig(solver="inverse", pressure_mode="merge", transport=tr)))
       for tr in ("dye", "tracers")},
}


@pytest.mark.parametrize("case", ENSEMBLES)
def test_ensemble_card_against_cpu(card, case):
    """f64, 2 × 4 positions, 10 steps; no kernel of the port."""
    jitter, build = ENSEMBLES[case]
    with counting() as n:
        runs = ensemble_card_and_cpu(card, build, jitter)
    assert not kernels(n)
    assert_ensemble_close(runs)


def eager_steps(step, state: dict, steps: int):
    for _ in range(steps):
        state, metric = step(state)
    return state, metric


@cached
def campaign_ensemble(device, b: int) -> tuple:
    """The campaign's ensemble at B = ``b`` gaits, one a "data" position on
    the card, after 50 steps → (its step, state)."""
    cfg = stokes.StokesConfig(**GAIT, transport="tracers", precision="f32",
                              pressure_mode="merge", solver="inverse")
    ens = ShardedEnsemble.build(annulus(*CAMPAIGN_MESH), build_device_mesh(devices=[device] * b,
                                                                            data=b),
                                np.full(b, GAIT["B1"]), np.linspace(-5.0, 5.0, b), config=cfg)
    step = make_sharded_step(ens)
    return step, step.run(ens.initial_state(), 50)[0]


@pytest.mark.parametrize("b", [3, 8])
def test_ensemble_graph_run_against_eager_steps(card, b):
    """``run`` (one CUDA graph a step) against the eager step, 20 steps."""
    step, state = campaign_ensemble(card, b)
    with counting() as n:
        graph, _ = step.run(state, 20)
        eager, _ = eager_steps(step, state, 20)
    assert not kernels(n)
    assert max(float((graph[k] - eager[k]).abs().max()) for k in ("u", "tracers")) <= 1e-4
    assert torch.equal(graph["tracer_status"], eager["tracer_status"])


def test_ensemble_kernels_do_not_grow_with_gaits(card):
    """One batch program: kernels a step at B = 8 no more than 5 % above
    B = 3 (cuBLAS picks its product kernels by shape), where a loop over the
    simulations would multiply them by B."""
    k = []
    for b in (3, 8):
        step, state = campaign_ensemble(card, b)
        k.append(profile_run(lambda: eager_steps(step, state, 20), 20)["kernels_per_step"])
    assert k[1] <= 1.05 * k[0]


def test_geometry_ensemble_gates(card):
    """8 jittered 4,096-node meshes, tracers, f32 merge, one a "data"
    position on the card, 500 steps from rest: each simulation under
    tpufem's gates; no kernel of the port."""
    meshes = [annulus(64, 72, pad_hole=True, jitter=0.15, seed=k) for k in range(8)]
    cfg = stokes.StokesConfig(**GAIT, solver="inverse", pressure_mode="merge",
                              transport="tracers", precision="f32")
    b2s = np.linspace(-5.0, 5.0, 8)
    dm = build_device_mesh(devices=[card] * 8, data=8)
    with counting() as n:
        ens = MultiMeshEnsemble.build(meshes, dm, np.full(8, GAIT["B1"]), b2s, config=cfg)
        state, _ = make_multimesh_step(ens).run(ens.initial_state(), 500)
    assert not kernels(n)
    ensemble_gates(meshes, state["u"], b2s)


@pytest.mark.parametrize("locator", ["grid", "topk"])
def test_locators_on_the_dense_step(card, locator):
    """The bench configuration, 200 steps: K1 once a step and nothing else."""
    problem = stokes.StokesProblem.build(bench_mesh(), bench_config(locator=locator), device=card)
    with counting() as n:
        state, _ = stokes.run(problem, steps=200)
    assert kernels(n) == {"K1": 200}
    assert bool(torch.isfinite(state["tracers"]).all())


@pytest.mark.parametrize("transport", ["dye", "tracers"])
def test_topk_card_against_cpu(card, transport):
    """f64 on (12, 16), 20 steps."""
    with counting() as n:
        g, c = card_and_cpu(annulus(12, 16), 20, card, dt=0.01, nu=1.0, solver="inverse",
                            pressure_mode="merge", transport=transport, tracer_density=15,
                            locator="topk")
    assert not kernels(n)
    for k in g:
        assert rel(g[k], c[k]) <= 1e-10, k


def test_bf16_fused_step(card):
    """The bf16 fused step (``torch.addmv``) on (12, 16), 10 steps: tpufem's
    boundedness gate, within BF16_RTOL of f64."""
    fused = dict(solver="inverse", pressure_mode="merge", fused=True)
    mesh = annulus(12, 16)
    with counting() as n:
        p16 = stokes.StokesProblem.build(mesh, stokes.StokesConfig(precision="bf16", **fused),
                                         device=card)
        s16, _ = stokes.run(p16, steps=10)
    assert not kernels(n)
    s64, _ = stokes.run(stokes.StokesProblem.build(mesh, stokes.StokesConfig(**fused),
                                                   device=card), steps=10)
    assert s16["u"].dtype == torch.bfloat16
    assert float(s16["u"].abs().max()) < bench_large.MAX_U_FACTOR * 2.0
    assert rel(s16["u"], s64["u"]) <= BF16_RTOL
