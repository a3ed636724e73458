"""Kernels K2 and K3 (``tpufem_torch.solve.grid_cg``) in their plain
versions against tpufem's Pallas kernels run in interpret mode, on the
operators of ``generate_annulus_mesh(20, 24, pad_hole=True)`` with seeded
inputs; and the wrappers' CPU behaviour."""

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


def _pressure(tol: float, target: int, use_coarse: bool, dtype=torch.float64, coarse=None):
    s = _setup()
    b = s["boundary"]
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    jG = JGrid.build(s["Km"][0], NS, dtype=jdt)
    tG = TGrid.build(s["Km"][1], NS, dtype=dtype)
    common = dict(iters=60, tol=tol, target_coarse=target, use_coarse=use_coarse)
    jp = JPressure.build(s["Km"][0], jG, s["ml"], b.masters, b.slaves, s["act"], interpret=True,
                         coarse_dtype=jnp.bfloat16 if coarse == "bf16" else None, **common)
    tp = grid_cg.PressureGridCG.build(s["Km"][1], tG, s["ml"], b.masters, b.slaves, s["act"],
                                      plain=True, **common,
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
    _, tp = _pressure(0.0, 64, True)
    with pytest.raises(NotImplementedError):
        dataclasses.replace(tp, precond_bf16=True)
    with pytest.raises(NotImplementedError):
        dataclasses.replace(tp, probe="nodma")
    streamed = dataclasses.replace(tp, stream_diags=True, stream_loop=True, hbm_io=True,
                                   stream_chunk=2, lean=True)
    b = torch.as_tensor(np.random.default_rng(15).standard_normal(NS * NS))
    torch.testing.assert_close(streamed.solve(b), tp.solve(b), rtol=0, atol=0)
