"""Kernels K2 and K3 (``tpufem_torch.solve.grid_cg``) in their plain
versions against tpufem's Pallas kernels run in interpret mode, on the
operators of ``generate_annulus_mesh(20, 24, pad_hole=True)`` and on the
grid Taylor–Hood engine's velocity operator of
``p2_refine(generate_annulus_mesh(12, 12))``, with seeded inputs; and the
wrappers' CPU behaviour."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem import bc as jbc
from tpufem.ops import assembly as jassembly
from tpufem.ops.gridop import GridOperator as JGrid
from tpufem.solve.pallas_cg import PressureGridCG as JPressure
from tpufem.solve.pallas_cg import ViscousGridCG as JViscous
from tpufem.solve.pressure import owner_map
from tpufem_torch import interop
from tpufem_torch.ops import assembly as tassembly
from tpufem_torch.ops.gridop import GridOperator as TGrid
from tpufem_torch.solve import grid_cg

from tests._torch_parity import meshes, rel

torch.set_num_threads(2)

NS = 20
DT_NU = 0.01


@functools.lru_cache(maxsize=None)
def _setup():
    """Both packages' stiffness and merged CSR operators and the masks."""
    jm, tm = meshes(NS, 24, pad_hole=True)
    b = jbc.ChannelBoundary.build(jm)
    owner = owner_map(jm.n_nodes, b.masters, b.slaves)
    merge = lambda m: dataclasses.replace(m, tris=owner[m.tris].astype(np.int32))
    kj, kt = jassembly.element_stiffness(jm), tassembly.element_stiffness(tm)
    ml = np.array(jassembly.lumped_mass(jm))
    act = ((owner == np.arange(jm.n_nodes)) & (ml > 0)).astype(np.float64)
    mask = np.ones(jm.n_nodes)
    mask[b.dirichlet] = 0.0
    return dict(
        K=(jassembly.assemble_csr(jm, kj), tassembly.assemble_csr(tm, kt)),
        Km=(jassembly.assemble_csr(merge(jm), kj), tassembly.assemble_csr(merge(tm), kt)),
        boundary=b, ml=ml, act=act, mask=mask,
    )


def _viscous(tol: float):
    s = _setup()
    jK = JGrid.build(s["K"][0], NS, dtype=jnp.float64)
    tK = TGrid.build(s["K"][1], NS, dtype=torch.float64)
    jv = JViscous(K=jK, interior_mask=jnp.asarray(s["mask"]), dt_nu=DT_NU, iters=30, tol=tol,
                  interpret=True)
    tv = grid_cg.ViscousGridCG(K=tK, interior_mask=torch.as_tensor(s["mask"]), dt_nu=DT_NU,
                               iters=30, tol=tol, plain=True)
    return jv, tv


def _pressure(tol: float, target: int, use_coarse: bool, dtype=torch.float64, coarse=None,
              **port_kw):
    s = _setup()
    b = s["boundary"]
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    jG = JGrid.build(s["Km"][0], NS, dtype=jdt)
    tG = TGrid.build(s["Km"][1], NS, dtype=dtype)
    common = dict(iters=60, tol=tol, target_coarse=target, use_coarse=use_coarse)
    jp = JPressure.build(s["Km"][0], jG, s["ml"], b.masters, b.slaves, s["act"], interpret=True,
                         coarse_dtype=jnp.bfloat16 if coarse == "bf16" else None, **common)
    tp = grid_cg.PressureGridCG.build(s["Km"][1], tG, s["ml"], b.masters, b.slaves, s["act"],
                                      plain=True, **common, **port_kw,
                                      coarse_dtype=torch.bfloat16 if coarse == "bf16" else None)
    return jp, tp


@pytest.mark.parametrize("tol", [0.0, 1e-5])
def test_viscous_plain_matches_tpufem_kernel(tol):
    jv, tv = _viscous(tol)
    rng = np.random.default_rng(11)
    n = NS * NS
    b, x0 = rng.standard_normal((n, 2)), rng.standard_normal((n, 2))
    want = np.asarray(jv.solve(jnp.asarray(b), jnp.asarray(x0) if tol else None))
    got = tv.solve(torch.as_tensor(b), torch.as_tensor(x0) if tol else None).numpy()
    assert rel(got, want) <= 1e-12


TH_MESH = (12, 12)  # P2-refined: 440 velocity nodes on a raster
TH_CFG = dict(dt=0.01, nu=1.0, iters_inner=60, iters_outer=40, iters_plap=20)
TH_TOL_INNER = 1e-8  # the grid engine's velocity tolerance at f64 (bench_large.run_th_sparse)
# K2 against tpufem's kernel on the TH velocity operator, relative L2.  On
# tpufem's split carried across, the two differ in summation order only,
# which the 30 fixed iterations from zero amplify (CG short of convergence
# on A = M/dt + νK − I): measured 1.3e-12 there, 2.5e-14 with the tolerance
# from a warm start.  The port's card split
# (GridOperator.dense_split) keeps one plane (the diagonal) where tpufem's
# split keeps two on tpufem's 128-wide raster, and its remainder rounds the
# other plane's couplings to float32 as tpufem's kernels round theirs:
# measured 3.6e-8 (fixed 30) and 5.2e-8 (tolerance, warm)
TH_RTOL = {("tpufem", 0.0): 5e-12, ("tpufem", TH_TOL_INNER): 1e-12,
           ("card", 0.0): 1e-7, ("card", TH_TOL_INNER): 1e-7}
_GRID_FIELDS = ("diags", "n_rest", "gr_rowT", "gr_laneT", "sc_row", "sc_laneT", "rest_vals",
                "offsets", "coverage")


@functools.lru_cache(maxsize=None)
def _th_velocity():
    """tpufem's grid TH engine (interpret mode) on ``p2_refine(
    generate_annulus_mesh(12, 12))`` and the port's grid engine on the same
    rasters (the port's own build): (tpufem's velocity solver, the port's
    plain K2 on tpufem's split carried across by ``interop``, the port's
    plain K2 on its own card split)."""
    from tpufem.mesh.p2 import p2_refine as jp2_refine
    from tpufem.workloads import th_sparse as jth
    from tpufem_torch.mesh.p2 import p2_refine as tp2_refine
    from tpufem_torch.workloads import th_sparse as tth

    snap = dict(snap_center=(0.5, 0.5), snap_radius=0.25)
    jm, tm = meshes(*TH_MESH)
    jbase = jth.SparseTHProblem.build(jp2_refine(jm, **snap), jth.SparseTHConfig(**TH_CFG))
    jgp = jth.GridTHProblem.build(jbase, interpret=True, tol_inner=TH_TOL_INNER)
    jv = jgp.vel_solver
    arrays = {f"K.{f}": np.asarray(getattr(jv.K, f)) for f in _GRID_FIELDS}
    mask = torch.as_tensor(np.array(jv.interior_mask))
    carried = grid_cg.ViscousGridCG(K=interop._grid_operator(arrays, "K", "cpu"),
                                    interior_mask=mask, dt_nu=jv.dt_nu, iters=jv.iters,
                                    tol=jv.tol, plain=True)
    tbase = tth.SparseTHProblem.build(tp2_refine(tm, **snap), tth.SparseTHConfig(**TH_CFG),
                                      device=torch.device("cpu"))
    tgp = tth.GridTHProblem.build(tbase, interpret=True, ns2=jgp.ns2, ns1=jgp.ns1,
                                  tol_inner=TH_TOL_INNER)
    np.testing.assert_array_equal(tgp.perm2, np.asarray(jgp.perm2))
    return jv, carried, tgp.vel_solver


@pytest.mark.parametrize("split,tol", [("tpufem", 0.0), ("tpufem", TH_TOL_INNER),
                                       ("card", 0.0), ("card", TH_TOL_INNER)])
def test_viscous_plain_matches_tpufem_kernel_on_th_velocity_operator(split, tol):
    """K2 on the grid TH engine's velocity operator (dt_nu 1, both columns,
    f64): fixed 30 iterations from zero, and the engine's f64 tol_inner
    from a warm start, on tpufem's split carried across and on the port's
    card split, within ``TH_RTOL``."""
    jv, carried, card = _th_velocity()
    port = carried if split == "tpufem" else card
    assert port.K.ns == jv.K.ns and port.dt_nu == jv.dt_nu == 1.0
    assert port.K.rest_round32
    if split == "card":
        assert len(card.K.offsets) < len(jv.K.offsets) and card.K.n_rest > jv.K.n_rest
    jv = dataclasses.replace(jv, iters=30, tol=0.0) if not tol else jv
    port = dataclasses.replace(port, iters=30, tol=0.0) if not tol else port
    n = jv.K.ns ** 2
    rng = np.random.default_rng(16)
    b = rng.standard_normal((n, 2)) * np.asarray(jv.interior_mask)[:, None]
    x0 = None
    if tol:
        fixed = dataclasses.replace(jv, iters=30, tol=0.0)
        x0 = np.asarray(fixed.solve(jnp.asarray(b * (1 + 1e-3 * rng.standard_normal(b.shape)))))
    want = np.asarray(jv.solve(jnp.asarray(b), None if x0 is None else jnp.asarray(x0)))
    it = torch.zeros(1, dtype=torch.int32)
    port = dataclasses.replace(port, iters_count=it)
    got = port.solve(torch.as_tensor(b), None if x0 is None else torch.tensor(x0)).numpy()
    assert (it.item() == 30) if not tol else (0 < it.item() < port.iters)
    assert rel(got, want) <= TH_RTOL[(split, tol)]


# (target_coarse, use_coarse, tol, bound).  target 64 gives a ragged 7×7
# coarse grid of 3×3 blocks; the default target a coarse grid equal to the
# fine one.  The ragged case with the coarse level on is held to 5e-6: its
# lane-block restriction adds float32 values in float32, and XLA's CPU
# interpreter sums such short dots in its own vectorized order, which
# differs from the kernels' lane order by an ulp now and then (measured
# 8.2e-7; the same restriction at the 32×32 coarse grids of the scale
# sizes matches XLA's order bit for bit).
PRESSURE_CASES = [
    (64, True, 1e-5, 5e-6),
    (64, False, 1e-5, 1e-10),
    (1024, True, 1e-5, 1e-10),
    (1024, True, 0.0, 1e-10),
    (1024, False, 1e-5, 1e-10),
]


@pytest.mark.parametrize("target,use_coarse,tol,bound", PRESSURE_CASES)
def test_pressure_plain_matches_tpufem_kernel(target, use_coarse, tol, bound):
    jp, tp = _pressure(tol, target, use_coarse)
    assert (tp.n_blocks, tp.block) == ((7, 3) if target == 64 else (20, 1))
    assert tp.omega == jp.omega and tp.pair_axis == jp.pair_axis
    np.testing.assert_allclose(tp.ac_inv.numpy(), np.asarray(jp.ac_inv), rtol=0, atol=1e-12)
    rng = np.random.default_rng(12)
    b, x0 = rng.standard_normal(NS * NS), rng.standard_normal(NS * NS)
    want = np.asarray(jp.solve(jnp.asarray(b), jnp.asarray(x0)))
    got = tp.solve(torch.as_tensor(b), torch.as_tensor(x0)).numpy()
    assert rel(got, want) <= bound


def test_pressure_plain_f32_bf16_coarse_tracks_tpufem_kernel():
    """f32 fields with a bf16 coarse inverse, as the scale configuration runs.
    At f32 this solve is accurate to ~1e-4 only: tpufem's f32 kernel lies
    1.4e-4 (rel L2) from the f64 solve with the same bf16 coarse inverse,
    the port's plain version 1.8e-4, and the two 1.5e-4 from each other
    (measured), so the bound is 1e-3."""
    jp, tp = _pressure(1e-5, 1024, True, dtype=torch.float32, coarse="bf16")
    assert tp.ac_inv.dtype == torch.bfloat16
    rng = np.random.default_rng(13)
    b, x0 = rng.standard_normal(NS * NS), rng.standard_normal(NS * NS)
    want = np.asarray(jp.solve(jnp.asarray(b, dtype=jnp.float32), jnp.asarray(x0, dtype=jnp.float32)))
    got = tp.solve(torch.as_tensor(b, dtype=torch.float32),
                   torch.as_tensor(x0, dtype=torch.float32))
    assert got.dtype == torch.float32
    assert rel(got.numpy(), want) <= 1e-3


def test_wrappers_take_the_plain_versions_on_cpu():
    _, tv = _viscous(1e-5)
    _, tp = _pressure(1e-5, 64, True)
    rng = np.random.default_rng(14)
    b2 = torch.as_tensor(rng.standard_normal((2, NS, NS)))
    b1 = torch.as_tensor(rng.standard_normal((NS, NS))) * tp.act_grid
    before = (grid_cg.viscous_cg.launches, grid_cg.pressure_cg.launches)
    it_k, it_p = torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    x = grid_cg.viscous_cg(tv, b2, torch.zeros_like(b2), it_k)
    torch.testing.assert_close(x, grid_cg.viscous_cg_ref(tv, b2, torch.zeros_like(b2), it_p),
                               rtol=0, atol=0)
    assert it_k.item() == it_p.item() > 0
    p = grid_cg.pressure_cg(tp, b1, torch.zeros_like(b1))
    torch.testing.assert_close(p, grid_cg.pressure_cg_ref(tp, b1, torch.zeros_like(b1)),
                               rtol=0, atol=0)
    assert (grid_cg.viscous_cg.launches, grid_cg.pressure_cg.launches) == before
    with pytest.raises(ValueError):
        grid_cg.viscous_cg(tv, b2[:, :-1], torch.zeros_like(b2[:, :-1]))
    with pytest.raises(TypeError):
        grid_cg.pressure_cg(tp, b1.float(), torch.zeros_like(b1).float())
    with pytest.raises(ValueError):
        grid_cg.viscous_cg(tv, b2, torch.zeros_like(b2), torch.zeros(1, dtype=torch.int64))


def test_tpu_only_fields_refused_or_ignored():
    """The TPU memory fields are ignored; ``precond_bf16`` is ignored off
    tpufem's gate (the streamed regime) and gives the preconditioner bf16
    planes on it; ``probe`` selects a measurement variant, an unknown one
    is refused."""
    _, tp = _pressure(0.0, 64, True)
    b = torch.as_tensor(np.random.default_rng(15).standard_normal(NS * NS))
    _, unstreamed = _pressure(0.0, 64, True, precond_bf16=True)
    assert unstreamed.K_pre is None
    torch.testing.assert_close(unstreamed.solve(b), tp.solve(b), rtol=0, atol=0)
    _, on = _pressure(0.0, 64, True, precond_bf16=True, stream_diags=True)
    assert on.K_pre is not None
    short = {k: dataclasses.replace(v, iters=5).solve(b).numpy() for k, v in (("on", on), ("off", tp))}
    assert rel(short["on"], short["off"]) > 1e-8  # before CG has converged
    with pytest.raises(ValueError, match="probe"):
        dataclasses.replace(tp, probe="nodram")
    assert rel(dataclasses.replace(tp, probe="nodma").solve(b).numpy(), tp.solve(b).numpy()) > 1e-3
    streamed = dataclasses.replace(tp, stream_diags=True, stream_loop=True, hbm_io=True,
                                   stream_chunk=2, lean=True)
    torch.testing.assert_close(streamed.solve(b), tp.solve(b), rtol=0, atol=0)
