"""Kernels K1–K5 against their plain versions on the card: two launches
bit-equal, the plain version's iteration count, the result within the
kernel's tolerance (``tests/_card.py``), at each size that selects another
instance or gate: K2 where an iteration fits in L2 (n_side=20, TH-192) and
where it streams (10⁶ nodes, the XL dye movie's 409,600), K3's bf16 planes
in the streamed regime (forced at n_side=20, and at 10⁶).  K6 is in
``test_torch_card_sharded.py``, E and G in ``test_torch_ns_refill.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from _card import (BIG, GRID_RTOL, K5_P_RTOL, KERNEL_RTOL, MID, PB16_F32_RTOL, PB16_GAP, SMALL,
                   TH_K3_F64_RTOL, TH_RTOL, TH_TOL_INNER, assert_solve, cached, card, counting,
                   k2_cast, k3_cast, k5_cast, k5_problem, k5_state, ns_grid, ns_operator,
                   ns_solver, rel, seeded, stokes_grid, warm_start, xl_problem)
from tpufem_torch import bench_large
from tpufem_torch.ops import assembly
from tpufem_torch.ops import fused_matvec as fm
from tpufem_torch.ops.gridop import STREAMED_NODES, GridOperator, GridRefill, _PatternCSR
from tpufem_torch.solve import grid_cg
from tpufem_torch.solve import grid_step as gs
from tpufem_torch.workloads import stokes, th_sparse

assert card  # the fixture, imported for the tests below
pytestmark = pytest.mark.card

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
DTYPES = {"f32": F32, "f64": F64}

# 2N of the bench mesh, an off-tile size, 2N at 3,100 nodes; then the
# scalar-tail path (a row not a multiple of the 16-byte vector) and the
# path that reads x from L2 (over the 48 KB staging limit)
K1_SHAPES = [(1704, 1704), (700, 700), (6200, 6200), (1703, 1701), (256, 13000), (256, 13001)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", K1_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_k1_against_addmv(card, shape, dtype):
    dtype = DTYPES[dtype]
    rng = np.random.default_rng(0)
    M, x, b = (torch.as_tensor(a, dtype=dtype, device=card) for a in (
        rng.standard_normal(shape), rng.standard_normal(shape[1]), rng.standard_normal(shape[0])))
    y = fm.fused_step_matvec(M, x, b)
    assert torch.equal(y, fm.fused_step_matvec(M, x, b))
    assert rel(y, fm.fused_step_matvec_ref(M, x, b)) <= KERNEL_RTOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_step_matvec_takes_k1_by_default(card, dtype):
    dtype, n = DTYPES[dtype], K1_SHAPES[0][0]
    rng = np.random.default_rng(0)
    M, b, x = rng.standard_normal((n, n)), rng.standard_normal(n), rng.standard_normal(n)
    mv = fm.FusedStepMatvec(M, b, dtype=dtype, device=card)
    with counting() as n_launched:
        y = mv(x)
    assert mv.use_pallas and n_launched == {"K1": 1}
    x = torch.as_tensor(x, dtype=dtype, device=card)
    assert rel(y, fm.fused_step_matvec_ref(mv.M, x, mv.b)) <= KERNEL_RTOL[dtype]


def test_small_sizes_have_ragged_coarse_blocks(card):
    """64 coarse nodes at n_side=20: 3×3 blocks, 7 a side, the last ragged.
    (With the default 2048 the coarse space is the whole grid, and a
    fixed-iteration f32 solve converges in one or two iterations and then
    iterates on roundoff, where kernel and plain version drift apart.)"""
    for problem in (stokes_grid(card, *SMALL, cg_coarse_nodes=64),
                    ns_grid(card, *SMALL, cg_coarse_nodes=64)):
        assert (problem.pressure_solver.block, problem.pressure_solver.n_blocks) == (3, 7)


NS_SIZES = {"n_side=20": (SMALL, dict(cg_coarse_nodes=64)), "1m": (BIG, {})}
# the Stokes grid path's operators (K2 and K3), and the NS step's pressure
# operator (K3: active mask deg > 0, no periodic pairs)
OPERATORS = {"stokes-n_side=20": lambda d: stokes_grid(d, *SMALL, cg_coarse_nodes=64),
             "stokes-1m": lambda d: stokes_grid(d, *BIG), "stokes-xl": xl_problem,
             **{f"ns-{k}": lambda d, k=k: ns_grid(d, *NS_SIZES[k][0], **NS_SIZES[k][1])
                for k in NS_SIZES}}
# (dtype, K3's coarse inverse dtype; None: K2); on the NS operator its
# step's instance (f32, f32 coarse inverse) and f64 throughout
GRID_CASES = {"K2-f32": (F32, None), "K3-f32-bf16": (F32, BF16), "K3-f32-f32": (F32, F32),
              "K2-f64": (F64, None), "K3-f64": (F64, F64)}


@pytest.mark.parametrize("tol", [0.0, 1e-5])
@pytest.mark.parametrize("operator,case", [
    (o, c) for o in OPERATORS for c in GRID_CASES
    if o.startswith("stokes") or c in ("K3-f32-f32", "K3-f64")])
def test_k2_k3_against_plain(card, operator, case, tol):
    """Fixed iterations from zero, and tol 1e-5 from a warm start."""
    problem = OPERATORS[operator](card)
    dtype, coarse = GRID_CASES[case]
    if coarse is None:
        kernel, plain = grid_cg.viscous_cg, grid_cg.viscous_cg_ref
        solver = k2_cast(problem.visc_solver, dtype)
        b = seeded((2, solver.K.ns, solver.K.ns), dtype, card, 7)
    else:
        kernel, plain = grid_cg.pressure_cg, grid_cg.pressure_cg_ref
        solver = k3_cast(problem.pressure_solver, dtype, coarse)
        b = seeded((solver.K.ns, solver.K.ns), dtype, card, 7) * solver.act_grid
    solver = dataclasses.replace(solver, tol=tol)
    x0 = warm_start(plain, solver, b) if tol else torch.zeros_like(b)
    assert_solve(kernel, plain, solver, b, x0, GRID_RTOL[(dtype, tol)])


@cached
def ns_layout(device, size: str, other: bool):
    """The NS problem and a layout of its velocity operator: its own
    template, or another (``other``): below 360,000 nodes a
    remainder-heavy one (five planes), from there tpufem's split of the
    mesh pattern (its TPU caps; 13 planes at 10⁶ nodes)."""
    mesh, kw = NS_SIZES[size]
    problem = ns_grid(device, *mesh, **kw)
    if not other:
        return problem, None
    m, ns = problem.mesh, problem.grid_refill.template.ns
    pattern = assembly._csr_pattern(m)
    csr = _PatternCSR(pattern, m.n_nodes)
    kw = {} if m.n_nodes >= STREAMED_NODES else dict(max_offsets=5, rest_budget_bytes=None)
    template = GridOperator.build(csr, ns, dtype=problem.dtype, device=device, **kw)
    return problem, GridRefill.from_template(m, template, pattern)


@pytest.mark.parametrize("start", ["fixed", "warm"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["own", "other"])
@pytest.mark.parametrize("size", NS_SIZES)
def test_k4_against_plain(card, size, layout, dtype, start):
    """30 fixed iterations from zero on a seeded right-hand side, and tol
    1e-5 from the step's warm start (u) on its own (u + Δt·f)."""
    problem, refill = ns_layout(card, size, layout == "other")
    dtype = DTYPES[dtype]
    op, mask, invd, u, b_step = ns_operator(problem, dtype, refill)

    def kernel(s, b, x0, it=None):
        return grid_cg.ns_bicgstab(s, op, mask, invd, b, x0, it)

    def plain(s, b, x0, it=None):
        return grid_cg.ns_bicgstab_ref(s, op, mask, invd, b, x0, it)

    if start == "fixed":
        tol, b, x0 = 0.0, seeded(tuple(u.shape), dtype, card, 8), torch.zeros_like(u)
    else:
        tol, b, x0 = 1e-5, b_step, u
    assert_solve(kernel, plain, ns_solver(problem, op, iters=30, tol=tol), b, x0,
                 GRID_RTOL[(dtype, tol)])


# (problem, steps from rest before the call)
K5_SIZES = {
    "n_side=20": (lambda d: k5_problem(d, *SMALL, cg_coarse_nodes=64), 3),
    "1m": (lambda d: k5_problem(d, *BIG), 20),
    # a compacted mesh renumbered onto 280², and 160,000 nodes
    "gridify": (lambda d: stokes_grid(d, 280, 320, pad_hole=False, grid_steps_per_call=1), 3),
    "160k": (lambda d: stokes_grid(d, *MID, grid_steps_per_call=1), 3),
}


@cached
def k5_start(device, size: str) -> tuple:
    make, steps = K5_SIZES[size]
    problem = make(device)
    state, _ = stokes.run(problem, steps=steps)
    return problem.grid_step, state


def k5_case(device, size: str, dtype, tol: float) -> tuple:
    """(K5 in ``dtype`` at ``tol``, its inputs); f32 keeps the problem's
    coarse inverse dtype."""
    step, state = k5_start(device, size)
    coarse = step.pressure.ac_inv.dtype if dtype == F32 else F64
    return k5_cast(step, dtype, coarse, tol), k5_state(step, state, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("size,tol", [(s, t) for s in ("n_side=20", "1m") for t in (0.0, 1e-5)]
                         + [("gridify", 1e-5), ("160k", 1e-5)])
def test_k5_against_plain(card, size, tol, dtype):
    """u, u* and the metrics within GRID_RTOL, p and p2 within K5_P_RTOL."""
    dtype = DTYPES[dtype]
    step, args = k5_case(card, size, dtype, tol)
    counts = [torch.zeros(1, dtype=torch.int32, device=card) for _ in range(4)]
    got = gs.grid_step(step, *args, counts[0], counts[1])
    again = gs.grid_step(step, *args)
    want = gs.grid_step_ref(step, *args, counts[2], counts[3])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert [int(c.item()) for c in counts[:2]] == [int(c.item()) for c in counts[2:]]
    for name, a, w in zip(("u", "u*", "p", "p2", "metrics"), got, want):
        limit = K5_P_RTOL if name in ("p", "p2") else GRID_RTOL
        assert rel(a, w) <= limit[(dtype, tol)], name


@pytest.mark.parametrize("size", ["n_side=20", "1m"])
def test_k5_four_steps_a_call_are_four_calls(card, size):
    """One launch of K = 4 against four launches of K = 1, bit for bit."""
    step, args = k5_case(card, size, F32, 1e-5)
    one, four = (dataclasses.replace(step, steps_per_call=k) for k in (1, 4))
    u, us, p, p2 = args
    mets = []
    for _ in range(4):
        u, us, p, p2, met = gs.grid_step(one, u, us, p, p2)
        mets.append(met)
    got = gs.grid_step(four, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, (u, us, p, p2, torch.cat(mets))))


@cached
def th_grid(device, n_side: int):
    """The grid engine on ``p2_refine(generate_annulus_mesh(n_side, n_side))``
    with ``bench_large.run_th_sparse``'s budgets; K3 with 64 coarse nodes at
    n_side 20 (1024 would be the whole grid there)."""
    _, base = bench_large.th_problem(n_side, n_side, "f64", device)
    return th_sparse.GridTHProblem.build(base, target_coarse=64 if n_side <= 32 else 1024)


# (kernel, iterations: the engine's velocity cap (288 at TH-192) or 60,
# whichever is less, or the cap itself; a tolerance; from a warm start)
TH_CASES = {"K2-fixed": ("K2", False, False, False), "K2-cap-tol": ("K2", True, True, False),
            "K2-cap-tol-warm": ("K2", True, True, True), "K3-fixed": ("K3", False, False, False),
            "K3-tol-warm": ("K3", False, True, True)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", TH_CASES)
@pytest.mark.parametrize("n_side", [20, 192])
def test_k2_k3_on_the_taylor_hood_operators(card, n_side, case, dtype):
    """The P2 velocity operator's identity split on its raster (K2, both
    columns) and the P1 pressure Laplacian (K3), the engine's tol_inner;
    the warm start is a fixed-iteration solve of a nearby rhs."""
    gp, dtype = th_grid(card, n_side), DTYPES[dtype]
    name, at_cap, with_tol, warm = TH_CASES[case]
    if name == "K2":
        cap = gp.vel_solver.iters
        base = dataclasses.replace(k2_cast(gp.vel_solver, dtype), iters=min(cap, 60))
        kernel, plain = grid_cg.viscous_cg, grid_cg.viscous_cg_ref
        b = seeded((2, gp.ns2, gp.ns2), dtype, card, 36) * base.mask_grid
    else:
        cap = gp.plap_solver.iters
        base = k3_cast(gp.plap_solver, dtype, dtype)
        kernel, plain = grid_cg.pressure_cg, grid_cg.pressure_cg_ref
        b = seeded((gp.ns1, gp.ns1), dtype, card, 37) * base.act_grid
    tol = TH_TOL_INNER[dtype] if with_tol else 0.0
    rtol = TH_RTOL[(dtype, tol)]
    if name == "K3" and dtype == F64:
        rtol = max(rtol, TH_K3_F64_RTOL)
    x0 = warm_start(plain, base, b) if warm else torch.zeros_like(b)
    solver = dataclasses.replace(base, iters=cap if at_cap else base.iters, tol=tol)
    assert_solve(kernel, plain, solver, b, x0, rtol)


# K3 with bf16 preconditioner planes where tpufem's gate takes them: the
# streamed regime, forced at n_side=20 and by size at 10⁶ nodes
PB16_SIZES = {
    "n_side=20": lambda d: stokes_grid(d, *SMALL, cg_coarse_nodes=64, cg_stream_diags="on",
                                       cg_precond_bf16="on"),
    "1m": lambda d: stokes_grid(d, *BIG, cg_precond_bf16="on"),
}


def pb16_case(device, size: str, dtype, coarse):
    """The problem's bf16-plane K3 with its fields in ``dtype``: K̃'s
    remainder cast with them, its planes left in bf16."""
    pres = PB16_SIZES[size](device).pressure_solver
    assert pres.K_pre is not None and pres.K_pre.offsets == pres.K.offsets
    assert pres.K_pre.diags.dtype == BF16
    s = k3_cast(pres, dtype, coarse or pres.ac_inv.dtype)
    K_pre = dataclasses.replace(pres.K_pre, rest_vals=pres.K_pre.rest_vals.to(dtype))
    s = dataclasses.replace(s, K_pre=K_pre)
    return s, seeded((pres.K.ns, pres.K.ns), F64, device, 48).to(dtype) * s.act_grid


@pytest.mark.parametrize("tol", [0.0, 1e-5])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("size", PB16_SIZES)
def test_k3_bf16_planes_against_plain(card, size, dtype, tol):
    """f64 (f64 coarse inverse) and f32 (the problem's), fixed iterations
    and tol 1e-5 from a warm start; the bf16-plane instance launched."""
    dtype = DTYPES[dtype]
    solver, b = pb16_case(card, size, dtype, F64 if dtype == F64 else None)
    solver = dataclasses.replace(solver, tol=tol)
    plain = grid_cg.pressure_cg_ref
    x0 = warm_start(plain, solver, b) if tol else torch.zeros_like(b)
    before = grid_cg.pressure_cg.variant_launches["pb16"]
    assert_solve(grid_cg.pressure_cg, plain, solver, b, x0, GRID_RTOL[(dtype, tol)])
    assert grid_cg.pressure_cg.variant_launches["pb16"] == before + 2


@pytest.mark.parametrize("size", PB16_SIZES)
def test_k3_bf16_planes_short_of_convergence(card, size):
    """10 fixed iterations from zero, where the answer still depends on the
    preconditioner: the f64 kernel within GRID_RTOL of its plain version and
    PB16_GAP times farther from the full-plane one, so that a kernel that
    reads the full planes, or misreads K̃, fails; f32 within PB16_F32_RTOL
    of f64."""
    runs = {}
    for dtype, coarse in ((F64, F64), (F32, None)):
        s, b = pb16_case(card, size, dtype, coarse)
        runs[dtype] = (dataclasses.replace(s, tol=0.0, iters=10), b)
    s, b = runs[F64]
    x0 = torch.zeros_like(b)
    got = grid_cg.pressure_cg(s, b, x0)
    err = rel(got, grid_cg.pressure_cg_ref(s, b, x0))
    gap = rel(got, grid_cg.pressure_cg_ref(dataclasses.replace(s, K_pre=None), b, x0))
    assert err <= GRID_RTOL[(F64, 0.0)]
    assert gap >= PB16_GAP * err and gap > 0
    s32, b32 = runs[F32]
    assert rel(grid_cg.pressure_cg(s32, b32, torch.zeros_like(b32)), got) <= PB16_F32_RTOL


# (dtype, coarse inverse dtype, fixed iterations): nofma's CG on the
# remainder alone grows its iterate ~10⁶× in 10 iterations at n_side=20,
# where its f32 kernel and plain version part by 1.6e-3: f32 runs 3
PROBE_CASES = {"f64": (F64, F64, 10), "f32": (F32, F32, 3), "f32-bf16": (F32, BF16, 3)}


@pytest.mark.parametrize("probe", ["nofma", "nodma"])
@pytest.mark.parametrize("case", PROBE_CASES)
@pytest.mark.parametrize("size", PB16_SIZES)
def test_k3_probes_against_plain(card, size, case, probe):
    """The measurement variants (wrong by design) on the full planes."""
    dtype, coarse, iters = PROBE_CASES[case]
    pres = dataclasses.replace(PB16_SIZES[size](card).pressure_solver, K_pre=None)
    s = dataclasses.replace(k3_cast(pres, dtype, coarse), tol=0.0, iters=iters, probe=probe)
    b = seeded((pres.K.ns, pres.K.ns), F64, card, 49).to(dtype) * s.act_grid
    x0 = torch.zeros_like(b)
    before = grid_cg.pressure_cg.variant_launches[probe]
    got, again = grid_cg.pressure_cg(s, b, x0), grid_cg.pressure_cg(s, b, x0)
    assert grid_cg.pressure_cg.variant_launches[probe] == before + 2
    assert torch.equal(got, again) and bool(torch.isfinite(got).all())
    assert rel(got, grid_cg.pressure_cg_ref(s, b, x0)) <= GRID_RTOL[(dtype, 0.0)]


@pytest.mark.parametrize("case", PROBE_CASES)
@pytest.mark.parametrize("size", PB16_SIZES)
def test_k3_exchange_probe_against_plain(card, size, case):
    """The exchange probe visits no point between the grid barriers: after
    its fixed iterations it returns its start projected, as its plain
    version does."""
    dtype, coarse, iters = PROBE_CASES[case]
    pres = dataclasses.replace(PB16_SIZES[size](card).pressure_solver, K_pre=None)
    s = dataclasses.replace(k3_cast(pres, dtype, coarse), tol=0.0, iters=iters, probe="exchange")
    b, x0 = (seeded((pres.K.ns, pres.K.ns), F64, card, seed).to(dtype) * s.act_grid
             for seed in (49, 50))
    before = grid_cg.pressure_cg.variant_launches["exchange"]
    assert_solve(grid_cg.pressure_cg, grid_cg.pressure_cg_ref, s, b, x0, GRID_RTOL[(dtype, 0.0)])
    assert grid_cg.pressure_cg.variant_launches["exchange"] == before + 2


# K3's exchange at the grid barriers (grid_common.cuh: the totals, phase C)
# at launch shapes the cells do not take: on 280² K3 launches 307 blocks at
# f32 (the totals read a padded last run) and 264 at f64, neither a
# multiple of 32 nor 528, with 1,024 coarse nodes or, asked for 900, 784;
# at 10⁶ nodes a coarse space of 900
EXCHANGE_SIZES = {
    "280-m1024": (lambda d: stokes_grid(d, 280, 320), 1024),
    "280-m784": (lambda d: stokes_grid(d, 280, 320, cg_coarse_nodes=900), 784),
    "1m-m900": (lambda d: stokes_grid(d, *BIG, cg_coarse_nodes=900), 900),
}


@pytest.mark.parametrize("tol", [0.0, 1e-5])
@pytest.mark.parametrize("case", ["K3-f32-bf16", "K3-f32-f32", "K3-f64"])
@pytest.mark.parametrize("size", EXCHANGE_SIZES)
def test_k3_exchange_at_other_launch_shapes(card, size, case, tol):
    """Fixed iterations from zero, and tol 1e-5 from a warm start."""
    make, m = EXCHANGE_SIZES[size]
    dtype, coarse = GRID_CASES[case]
    solver = dataclasses.replace(k3_cast(make(card).pressure_solver, dtype, coarse), tol=tol)
    assert tuple(solver.ac_inv.shape) == (m, m)
    b = seeded((solver.K.ns, solver.K.ns), dtype, card, 7) * solver.act_grid
    plain = grid_cg.pressure_cg_ref
    x0 = warm_start(plain, solver, b) if tol else torch.zeros_like(b)
    assert_solve(grid_cg.pressure_cg, plain, solver, b, x0, GRID_RTOL[(dtype, tol)])
