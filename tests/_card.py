"""Shared pieces of the card suite: the tests marked ``card`` in
``tests/test_torch_card_*.py``, ``tests/test_torch_stokes_graph.py`` and
``tests/test_torch_ns_refill.py``, which hold each hand-written kernel
against its plain version and each path on the card against the port's CPU
path.  They skip without a CUDA card.  On the card, without JAX
(``tests/conftest.py`` imports it):

    python -m pytest --noconftest -m card tests/test_torch_card_*.py \\
        tests/test_torch_stokes_graph.py tests/test_torch_ns_refill.py

This module imports neither ``tpufem`` nor ``jax``, which the card's
machine lacks.  The meshes and problems it makes are cached for the test
run, so that the 10⁶-node annulus and each problem on it are made once.
The tolerance tables are the ones each kernel and path was ported under
(PERF.md §6).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import os

import numpy as np
import pytest
import torch

from tpufem_torch import bench_large, gallery
from tpufem_torch.mesh import generate_annulus_mesh
from tpufem_torch.ops import _nvcc, assembly, ns_refill
from tpufem_torch.ops import fused_matvec as fm
from tpufem_torch.parallel import grid_remote_dma as rdma
from tpufem_torch.solve import grid_cg
from tpufem_torch.solve import grid_step as gs
from tpufem_torch.workloads import navier_stokes, stokes

CPU = torch.device("cpu")
BIG = (1024, 1088)  # pad_hole: 1,048,576 nodes, the benchmark cells' mesh
MID = (400, 448)  # pad_hole: 160,000 nodes, below the 360,000-node streamed regime
SMALL = (20, 24)  # with 64 coarse nodes: ragged 3×3 coarse blocks
PARITY = (40, 48)  # the grid paths' card-against-CPU size
STEP_METRICS = ("div_star_max", "final_div_max", "max_u")

# K1 against torch.addmv, relative L2
KERNEL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# K2/K3/K4 against their plain versions, relative L2 of the solution: at
# f64 the two differ in summation order only, at f32 by float32 roundoff
# amplified by the iterations; with tol > 0 they may stop one iteration
# apart, which moves the result within the solve's tolerance
GRID_RTOL = {(torch.float64, 0.0): 1e-9, (torch.float64, 1e-5): 1e-5,
             (torch.float32, 0.0): 1e-3, (torch.float32, 1e-5): 1e-3}
# K5's pressures p and p2 against its plain version's (u, u* and the
# metrics as GRID_RTOL): where u agrees to 4e-12 (f64) and 2e-8 (f32), p
# agrees to 3e-9 and 2e-6 at n_side=20 and 5e-4 (f32) at 10⁶ nodes, in the
# smooth modes the solves leave, which reach u only through the gradient
K5_P_RTOL = {(torch.float64, 0.0): 1e-7, (torch.float64, 1e-5): 1e-4,
             (torch.float32, 0.0): 1e-2, (torch.float32, 1e-5): 1e-2}
# K5 at f64, card against CPU, u after 10 steps at n_side=40: with tol 1e-5
# the pressure solves stop on a tolerance and leave ~1e-9 of p between the
# two summation orders, which reaches u
K5_PARITY_RTOL = {0.0: 1e-9, 1e-5: 1e-8}
# the Taylor–Hood engine's velocity tolerance a precision, and K2/K3 on its
# operators against their plain versions (as GRID_RTOL)
TH_TOL_INNER = {torch.float32: 1e-6, torch.float64: 1e-8}
TH_RTOL = {(torch.float64, 0.0): 1e-9, (torch.float64, 1e-8): 1e-6,
           (torch.float32, 0.0): 1e-3, (torch.float32, 1e-6): 1e-3}
# K3 rounds its restriction and coarse product to float32 at every
# precision: where two summation orders put a float32 block sum one ulp
# apart, its f64 solves part by up to ~1e-8 (4.1e-9 measured at n_side 192)
TH_K3_F64_RTOL = 1e-7
ENS_RTOL = 1e-10  # every field of every ensemble, f64 card against CPU
BF16_RTOL = 1e-2  # the bf16 fused step's u against f64 after 10 steps
# the f64 dense dye solve carries the ±1e10 penalty (cond 3.4e13 on (12, 16)):
# the card's LAPACK and the CPU's land 2.5e-3 apart in c after 20 steps
EUL_PENALTY_C_RTOL = 5e-3
DIAG_TOL = 1e-10  # |card − CPU| ≤ DIAG_TOL·max(|CPU|, 1) for every diag value
STORAGE_APPLY_RTOL = 1e-5  # f32 stencil and grid-split applies against CSR
STORAGE_F64_RTOL = 1e-10  # the storages at f64 and fixed iterations, card against CPU
GALLERY_RTOL = 1e-10  # the gallery's f64 quick fields, card against CPU
XL_C_SLACK = 1e-6  # the XL dye stays in its first range: P1 interpolation is convex
# K3 with bf16 preconditioner planes: the f32 kernel against the f64 one at
# fixed iterations; short of convergence the f64 kernel PB16_GAP times
# farther from the full-plane plain version than from its own; u "on"
# against "off" at f64 after 20 steps above PB16_F64_U_GAP (~4500 ε)
PB16_F32_RTOL = 5e-3
PB16_GAP = 100
PB16_F64_U_GAP = 1e-12


@functools.cache
def build_kernels() -> None:
    """Every kernel library, one nvcc a source, all at once."""
    _nvcc.build_all([fm.SOURCE, grid_cg.SOURCE, gs.SOURCE, rdma.SOURCE, ns_refill.SOURCE])
    for library in (fm, grid_cg, gs, rdma, ns_refill):
        library.build()


@pytest.fixture
def card():
    """The card, TF32 off, the kernels built."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # cuBLAS's fixed order
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    return torch.device("cuda", 0)


@pytest.fixture
def deterministic():
    """Deterministic algorithms on for the test (a warning where an
    operation has none), which a replay's bit-for-bit comparison with the
    eager loop needs: the stencil remainder's ``index_add_`` sums with
    atomics in a varying order otherwise, and two eager loops part by ~1e-7
    in ``u`` after 20 steps at 1,048,576 nodes.  The plain CSR paths'
    ``index_add_`` runs several times slower under it, so no other test
    takes it."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(was)


def cards(n: int) -> list:
    """The first ``n`` cards; skips the test where fewer are visible."""
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards")
    return [torch.device("cuda", i) for i in range(n)]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach().double().cpu() - b.detach().double().cpu()).abs().max())


def assert_finite(*trees: dict) -> None:
    for tree in trees:
        for k, v in tree.items():
            if v.is_floating_point():
                assert bool(torch.isfinite(v).all()), k


WRAPPERS = {"K1": fm.fused_step_matvec, "K2": grid_cg.viscous_cg, "K3": grid_cg.pressure_cg,
            "K4": grid_cg.ns_bicgstab, "K5": gs.grid_step, "K6": rdma.halo_rdma,
            "E": ns_refill.convection_flat, "G": ns_refill.segment_sum}


@contextlib.contextmanager
def counting():
    """After the block, the dict it yields holds what changed in it: each
    kernel's host launches (its wrapper's ``launches``) and
    ``stokes.graph_counts``, nonzero changes only."""
    def now():
        return {**{k: w.launches for k, w in WRAPPERS.items()}, **stokes.graph_counts}

    before, out = now(), {}
    yield out
    out.update({k: v - before[k] for k, v in now().items() if v != before[k]})


def kernels(n: dict) -> dict:
    """The kernel launches in a :func:`counting` dict."""
    return {k: v for k, v in n.items() if k in WRAPPERS}


# ---------------------------------------------------------------------------
# meshes and problems, made once a test run
# ---------------------------------------------------------------------------

def cached(fn):
    """``fn`` run once a process for each set of arguments, however they
    are passed."""
    signature, made = inspect.signature(fn), {}

    @functools.wraps(fn)
    def once(*args, **kw):
        bound = signature.bind(*args, **kw)
        bound.apply_defaults()
        key = tuple((k, tuple(sorted(v.items())) if isinstance(v, dict) else v)
                    for k, v in bound.arguments.items())
        if key not in made:
            made[key] = fn(*args, **kw)
        return made[key]

    return once


@cached
def annulus(n_side: int, n_circle: int, pad_hole: bool = False, **kw):
    return generate_annulus_mesh(n_side=n_side, n_circle=n_circle, pad_hole=pad_hole, **kw)


@cached
def stokes_grid(device, n_side: int, n_circle: int, pad_hole: bool = True, **overrides):
    """``bench_large.bench_config`` on explicit grid storage (renumbered
    where the mesh is not grid-numbered), fields replaced by ``overrides``."""
    mesh = annulus(n_side, n_circle, pad_hole)
    config = bench_large.bench_config(n_nodes=mesh.n_nodes, storage="grid", **overrides)
    return stokes.StokesProblem.build(mesh, config, device=device)


@cached
def k5_problem(device, n_side: int, n_circle: int, k: int = 1, **overrides):
    """:func:`stokes_grid`'s problem with K5 attached at ``k`` steps a call
    through ``GridStokesStep.build`` (no new build of the solvers)."""
    if k != 1:
        one = k5_problem(device, n_side, n_circle, 1, **overrides)
        return dataclasses.replace(
            one, config=dataclasses.replace(one.config, grid_steps_per_call=k),
            grid_step=dataclasses.replace(one.grid_step, steps_per_call=k))
    p = stokes_grid(device, n_side, n_circle, **overrides)
    p = dataclasses.replace(p, config=dataclasses.replace(p.config, grid_steps_per_call=1))
    step = gs.GridStokesStep.build(p)
    assert step is not None and step.steps_per_call == 1
    return dataclasses.replace(p, grid_step=step)


@cached
def ns_grid(device, n_side: int, n_circle: int, precision: str = "f32", **overrides):
    """``bench_large.ns_config`` (tpufem's ``run_ns``) on explicit grid storage."""
    return navier_stokes.NSProblem.build(
        annulus(n_side, n_circle, pad_hole=True),
        bench_large.ns_config(precision, storage="grid", **overrides), device=device)


@cached
def xl_problem(device):
    """The flagship dye movie's problem (``gallery.xl_problem``): 409,600
    nodes, the grid path."""
    return gallery.xl_problem(device=device)[0]


def card_and_cpu(mesh, steps: int, device, **kw) -> list:
    """``stokes.run`` of ``StokesConfig(**kw)`` from rest on the card and on
    the CPU: [card state, CPU state], float64 on the CPU."""
    out = []
    for d in (device, CPU):
        problem = stokes.StokesProblem.build(mesh, stokes.StokesConfig(**kw), device=d)
        state, _ = stokes.run(problem, steps=steps)
        out.append({k: v.double().cpu() for k, v in state.items() if v.is_floating_point()})
    return out


def run_sharded_steps(step, u, steps: int) -> tuple:
    """``steps`` calls of a sharded matrix-free step from ``u`` → (u, each
    metric's series on the device)."""
    series = {}
    for i in range(steps):
        u, m = step(u)
        for k, v in m.items():
            series.setdefault(k, torch.empty(steps, dtype=v.dtype, device=v.device))[i] = v
    return u, series


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def assert_solve(kernel, plain, solver, b, x0, rtol: float) -> None:
    """A whole-solve kernel against its plain version: two launches
    bit-equal, the same iteration count, the solution within ``rtol``."""
    it_k, it_p = (torch.zeros(1, dtype=torch.int32, device=b.device) for _ in range(2))
    got = kernel(solver, b, x0, it_k)
    again = kernel(solver, b, x0)
    want = plain(solver, b, x0, it_p)
    assert torch.equal(got, again)
    assert int(it_k.item()) == int(it_p.item())
    assert rel(got, want) <= rtol


def warm_start(plain, solver, b, seed: int = 0) -> torch.Tensor:
    """The fixed-iteration plain solution of a nearby right-hand side."""
    g = torch.Generator(device=b.device).manual_seed(seed)
    noise = torch.randn(b.shape, generator=g, device=b.device, dtype=b.dtype)
    return plain(dataclasses.replace(solver, tol=0.0), b * (1 + 1e-3 * noise),
                 torch.zeros_like(b))


def seeded(shape, dtype, device, seed: int) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape), dtype=dtype,
                           device=device)


def k3_cast(pres, dtype, coarse_dtype):
    """A ``PressureGridCG`` with its fields and operator in ``dtype`` and its
    coarse inverse in ``coarse_dtype``."""
    return dataclasses.replace(
        pres, K=pres.K.astype(dtype), m_lumped=pres.m_lumped.to(dtype),
        active_mask=pres.active_mask.to(dtype), master_mask=pres.master_mask.to(dtype),
        slave_mask=pres.slave_mask.to(dtype), ac_inv=pres.ac_inv.to(coarse_dtype))


def k2_cast(visc, dtype):
    return dataclasses.replace(visc, K=visc.K.astype(dtype),
                               interior_mask=visc.interior_mask.to(dtype))


def k5_cast(step, dtype, coarse_dtype, tol: float):
    """A ``GridStokesStep`` with its operators and fields in ``dtype``, its
    coarse inverse in ``coarse_dtype`` and both solves at ``tol``."""
    fields = {k: getattr(step, k).to(dtype)
              for k in ("wall_mask", "inner_mask", "inner_vals", "interior2")}
    return dataclasses.replace(
        step, visc=dataclasses.replace(k2_cast(step.visc, dtype), tol=tol),
        pressure=dataclasses.replace(k3_cast(step.pressure, dtype, coarse_dtype), tol=tol),
        Gdx=step.Gdx.astype(dtype), Gdy=step.Gdy.astype(dtype), **fields)


def k5_state(step, state: dict, dtype) -> tuple:
    """A K5 call's inputs from a run's state: u, u*, p, p2 as grid planes."""
    ns = step.ns

    def planes(v):
        return v.T.reshape(2, ns, ns).to(dtype).contiguous()

    u = planes(state["u"])
    us = planes(state["ustar_warm"]) if "ustar_warm" in state else torch.zeros_like(u)
    return (u, us, state["p_warm"].reshape(ns, ns).to(dtype).contiguous(),
            state["p2_warm"].reshape(ns, ns).to(dtype).contiguous())


def ns_operator(problem, dtype, refill=None, seed: int = 3) -> tuple:
    """The NS step's A = Δt·C(u) + νΔt·K refilled from a seeded u into
    ``refill``'s layout (default the problem's), in ``dtype``: (op, mask,
    inverse diagonal, u planes, rhs planes u + Δt·f)."""
    cfg, mesh, dev = problem.config, problem.mesh, problem.device
    refill = refill or problem.grid_refill
    ns = refill.template.ns
    u = seeded((mesh.n_nodes, 2), dtype, dev, seed) * 0.1
    C = refill.refill_flat(assembly.element_convection_flat(mesh, u, "opsplit"))
    K = refill.refill(assembly.element_stiffness(mesh, signed=True).to(dtype=dtype, device=dev))
    nudt = cfg.nu * cfg.dt
    op = dataclasses.replace(C, diags=cfg.dt * C.diags + nudt * K.diags,
                             rest_vals=cfg.dt * C.rest_vals + nudt * K.rest_vals)

    def planes(v):
        return v.T.reshape(-1, ns, ns).contiguous()

    return (op, torch.ones(ns, ns, dtype=dtype, device=dev),
            problem.inv_diag_visc.to(dtype).reshape(ns, ns).contiguous(), planes(u),
            planes(u + cfg.dt * problem.body_force.to(dtype)))


def ns_solver(problem, op, **changes):
    """The problem's K4 solver on ``op``'s layout, without its counter."""
    return dataclasses.replace(problem.vel_solver_grid, offsets=op.offsets, n_rest=op.n_rest,
                               iters_count=None, **changes)


# ---------------------------------------------------------------------------
# the captured Stokes step
# ---------------------------------------------------------------------------

def eager(problem, state: dict, steps: int, keys=STEP_METRICS) -> tuple:
    """A hand-written loop over ``make_step`` → (state, metrics)."""
    step = stokes.make_step(problem)
    series = {k: [] for k in keys}
    for _ in range(steps):
        state, m = step(state)
        for k in keys:
            series[k].append(m[k])
    return state, {k: torch.stack(v) for k, v in series.items()}


def assert_replays_eager(problem, steps: int, state: dict | None = None, adapt=None) -> tuple:
    """``stokes.run`` of ``steps`` steps, one capture and every step
    replayed, bit-equal to the eager loop from the same state, with the
    same iterations on the solvers' device counters → its (state, metrics).
    The host launches K2 and K3 for the capture's warm-up step and for the
    capture alone.  ``adapt`` changes each copy of the problem the two runs
    take."""
    adapt = adapt or (lambda p: p)
    graph_pb, graph_counters = bench_large.with_iteration_counters(problem)
    eager_pb, eager_counters = bench_large.with_iteration_counters(problem)
    graph_pb, eager_pb = adapt(graph_pb), adapt(eager_pb)
    start = state if state is not None else stokes.initial_state(problem)
    with counting() as n:
        got = stokes.run(graph_pb, steps=steps, state=start)
    assert n == {"K2": 2, "K3": 4, "captures": 1, "replays": steps}
    want = eager(eager_pb, start, steps)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert torch.equal(g[k], w[k]), k
    for field, (count, _) in eager_counters.items():
        assert torch.equal(graph_counters[field][0], count), field
    return got
