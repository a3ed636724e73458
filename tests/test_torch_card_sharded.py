"""The space-sharded grid path (``tpufem_torch.parallel``) and kernel K6, the
ring halo exchange, on the card: four shards on one card, and one shard on
each of four cards where four are visible (skipped otherwise; K6 then
stores into its neighbours' cards through peer access).  Also the gait
campaign with one gait on each of three cards."""

import dataclasses

import numpy as np
import pytest
import torch

from _card import (BIG, CPU, PARITY, annulus, cached, card, cards, counting, rel,
                   run_sharded_steps, stokes_grid)
from tpufem_torch import bench_large
from tpufem_torch.ops import assembly
from tpufem_torch.parallel import (build_device_mesh, make_sharded_grid_solvers,
                                   make_sharded_matfree_step, make_sharded_viscous_solver)
from tpufem_torch.parallel import grid_remote_dma as rdma
from tpufem_torch.parallel.grid_sharded import _signed_dy
from tpufem_torch.solve.matfree import ViscousCG
from tpufem_torch.workloads import stokes, sweep

assert card  # the fixture, imported for the tests below
pytestmark = pytest.mark.card

SHARDS = 4
DTYPES = {"f32": torch.float32, "f64": torch.float64}
LAYOUTS = ["one-card", "four-cards"]
# tpufem's sharded-solver and dryrun configuration (tests/test_parallel.py)
SHARDED = dict(solver="cg", cg_storage="grid", precision="f64", cg_precond="twolevel",
               cg_iters_visc=25, cg_iters_pressure=40, cg_warm_start=False, transport="none")
SHARDED_TOL = dict(cg_iters_visc=60, cg_iters_pressure=80, cg_tol_visc=1e-8, cg_tol_pressure=1e-8)


def shard_devices(card, layout: str) -> list:
    return [card] * SHARDS if layout == "one-card" else cards(SHARDS)


def shard_mesh(devs):
    """One row of positions, a shard on each of ``devs`` (repeats allowed)."""
    return build_device_mesh(len(devs), data=1, devices=list(devs))


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


# the 10⁶-node strips on 4 shards, and a ragged shape: 1001 values a row is
# no multiple of 16 bytes in f32 or f64, so K6 takes its scalar path
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(256, 1024), (64, 1001)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("layout", LAYOUTS)
def test_k6_against_torch_cat(card, layout, shape, dtype):
    """1, 2, 4 and 8 shards (shard i on card i mod the cards), halo depths 1,
    3 and the sharded solvers' at 10⁶ nodes: bit for bit, on the shard's card."""
    devs = sorted(set(shard_devices(card, layout)), key=lambda d: d.index)
    big = stokes_grid(card, *BIG)
    ns = big.visc_solver.K.ns
    offsets = big.visc_solver.K.offsets + big.pressure_solver.K.offsets
    dmax = max([abs(_signed_dy(dy, ns)) for dy, _ in offsets] + [1])
    rng = np.random.default_rng(23)
    for S in (1, 2, 4, 8):
        for d in sorted({1, 3, dmax}):
            x = [torch.as_tensor(rng.standard_normal(shape), dtype=DTYPES[dtype],
                                 device=devs[i % len(devs)]) for i in range(S)]
            got, want = rdma.halo_rdma(x, d), rdma.halo_rdma_ref(x, d)
            sync_all()
            for a, b in zip(got, want):
                assert a.device == b.device and torch.equal(a, b), (S, d)


@cached
def sharded_problem(device, with_tol: bool):
    mesh = annulus(*PARITY, pad_hole=True)
    return stokes.StokesProblem.build(
        mesh, stokes.StokesConfig(**{**SHARDED, **(SHARDED_TOL if with_tol else {})}),
        device=device)


# (problem, bounds (viscous, pressure), "abs": max abs, "rel": relative L2)
SOLVER_CASES = {"n_side=40-f64-fixed": (lambda d: sharded_problem(d, False), (1e-12, 1e-9), "abs"),
                "n_side=40-f64-tol": (lambda d: sharded_problem(d, True), (1e-6, 1e-5), "abs"),
                "1m-f32": (lambda d: stokes_grid(d, *BIG), (1e-3, 1e-3), "rel")}


@pytest.mark.parametrize("case", SOLVER_CASES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_solvers(card, layout, case):
    """``halo="rdma"`` (K6) against ``"ppermute"``, both against the
    single-device K2/K3 and their plain versions, on seeded right-hand sides."""
    devs = shard_devices(card, layout)
    make, bounds, metric = SOLVER_CASES[case]
    problem = make(card)
    (pv, pp), (rv, rp) = (make_sharded_grid_solvers(shard_mesh(devs), problem, halo=h)
                          for h in ("ppermute", "rdma"))
    visc, pres = problem.visc_solver, problem.pressure_solver
    rng = np.random.default_rng(24)
    n = problem.mesh.n_nodes
    for fns, single, shape, bound in (
            ((rv, pv), (visc, dataclasses.replace(visc, plain=True)), (n, 2), bounds[0]),
            ((rp, pp), (pres, dataclasses.replace(pres, plain=True)), (n,), bounds[1])):
        b = torch.as_tensor(rng.standard_normal(shape), dtype=problem.dtype, device=devs[0])
        got = [f(b) for f in fns]
        want = [s.solve(b) for s in single]
        sync_all()
        assert rel(got[0], got[1]) <= (1e-13 if problem.dtype == torch.float64 else 1e-6)
        for g in got:
            for w in want:
                dist = rel(g, w) if metric == "rel" else float((g - w).abs().max())
                assert dist <= bound


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_step_at_scale(card, layout):
    """``make_sharded_matfree_step(halo="rdma")`` at 10⁶ nodes, 10 steps from
    rest: one K6 launch a card a halo (a halo a viscous iteration, 3k + 2 a
    two-level pressure solve of k iterations, and its two rolls), none of
    K1–K5; tpufem's gates."""
    devs, steps = shard_devices(card, layout), 10
    problem, counters = bench_large.with_iteration_counters(stokes_grid(card, *BIG))
    step = make_sharded_matfree_step(shard_mesh(devs), problem, halo="rdma")
    with counting() as n:
        u, series = run_sharded_steps(step, stokes.initial_state(problem)["u"], steps)
        sync_all()
    visc_it = int(counters["visc_solver"][0].item())
    pres_it = int(counters["pressure_solver"][0].item())
    assert n == {"K6": (visc_it + 3 * pres_it + 4 * 2 * steps) * len(set(devs))}
    bench_large.physics_report(problem, {"u": u}, series, steps)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_step_card_against_cpu(card, layout):
    """f64 at n_side=40, 10 steps: the card's sharded step (K6) against the
    CPU's (plain), each against its single-device step."""
    devs, steps, out = shard_devices(card, layout), 10, []
    for shards in (devs, [CPU] * len(devs)):
        problem = stokes.StokesProblem.build(annulus(*PARITY, pad_hole=True),
                                             stokes.StokesConfig(**SHARDED), device=shards[0])
        on_card = shards[0].type == "cuda"
        step = make_sharded_matfree_step(shard_mesh(shards), problem,
                                         halo="rdma" if on_card else "ppermute")
        with counting() as n:
            u, _ = run_sharded_steps(step, stokes.initial_state(problem)["u"], steps)
        assert ("K6" in n) == on_card
        single, _ = stokes.run(problem, steps=steps)
        out.append((u.double().cpu(), single["u"].double().cpu()))
    (g, g_single), (c, c_single) = out
    assert rel(g, c) <= 1e-10
    assert max(float((g - g_single).abs().max()), float((c - c_single).abs().max())) <= 1e-8


@pytest.mark.parametrize("layout", LAYOUTS)
def test_distributed_csr_cg_against_single_device(card, layout):
    """The row-slab CSR viscous CG (80 iterations) against the single-device
    CSR solve on the card."""
    devs = shard_devices(card, layout)
    mesh = annulus(*PARITY, pad_hole=True)
    K = assembly.assemble_csr(mesh, assembly.element_stiffness(mesh)).astype(torch.float64, card)
    mask = sharded_problem(card, False).visc_solver.interior_mask
    b = torch.as_tensor(np.random.default_rng(26).standard_normal((mesh.n_nodes, 2)), device=card)
    x = make_sharded_viscous_solver(shard_mesh(devs), K, mask.cpu().numpy(), 0.005, iters=80)(b)
    y = ViscousCG(K=K, interior_mask=mask, dt_nu=0.005, iters=80).solve(b)
    assert float((x - y).abs().max()) <= 1e-9


def test_campaign_with_one_gait_a_card(card):
    """The sharded campaign with one gait on each of three cards (three
    groups stepping apart) against all gaits on the first card."""
    devs = cards(SHARDS)
    mesh, cfg = annulus(33, 48), sweep.SweepConfig()
    gaits = len(cfg.b2_values)
    runs = [sweep.food_capture_sweep_sharded(mesh, build_device_mesh(devices=d, data=gaits), cfg)
            for d in (devs[:gaits], [devs[0]] * gaits)]
    for b2 in runs[0]:
        assert abs(runs[0][b2]["consumed_fraction"] - runs[1][b2]["consumed_fraction"]) <= 0.05
