"""The halo-exchange CG of the port over banded and stencil storage
(``tpufem_torch.parallel.halo``, ``halo_stencil``) and the sharded Stokes
step on those storages, against tpufem's on ``generate_annulus_mesh(40,
48)`` (pad_hole for the stencil), f64 on the CPU.  tpufem's solvers run
under ``shard_map`` on the 8 virtual CPU devices of ``conftest.py`` (its
``tests/test_parallel.py`` set-up); the port's 8 shards all live on
``cpu``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JDeviceMesh

from tpufem import bc as jbc
from tpufem.ops import assembly as jassembly
from tpufem.ops import calculus as jcalculus
from tpufem.ops.banded import BandedOperator as JBanded
from tpufem.ops.stencil import StencilOperator as JStencil
from tpufem.parallel import halo as jhalo
from tpufem.parallel import halo_stencil as jhs
from tpufem.parallel import stokes_sharded as jss
from tpufem.workloads import stokes as jstokes
from tpufem_torch.ops import assembly as tassembly
from tpufem_torch.ops.banded import BandedOperator as TBanded
from tpufem_torch.ops.stencil import StencilOperator as TStencil
from tpufem_torch.parallel import halo, halo_stencil, spmd, stokes_sharded
from tpufem_torch.solve.matfree import ViscousCG
from tpufem_torch.workloads import stokes as tstokes

from tests._torch_parity import meshes

torch.set_num_threads(2)

CPU = torch.device("cpu")
SHARDS = 8
MESH = (40, 48)
STORAGES = {"banded": (JBanded, TBanded, False), "stencil": (JStencil, TStencil, True)}
# tpufem's sharded-step configuration (tests/test_parallel.py)
STEP = dict(cg_iters_visc=80, cg_iters_pressure=300, cg_warm_start=False,
            transport="none")


def _jax_mesh():
    if len(jax.devices()) < SHARDS:
        pytest.skip(f"needs {SHARDS} virtual devices")
    return JDeviceMesh(np.asarray(jax.devices()[:SHARDS]), ("space",))


def _cpu_mesh(n: int = SHARDS):
    return spmd.DeviceMesh(shape={"space": n}, devices=(CPU,) * n, axis_names=("space",))


@functools.lru_cache(maxsize=None)
def _operators(storage: str):
    """(tpufem's, the port's) stiffness on ``storage``, and the mask."""
    jcls, tcls, pad = STORAGES[storage]
    jm, tm = meshes(*MESH, pad_hole=pad)
    jK = jassembly.assemble_csr(jm, jassembly.element_stiffness(jm))
    tK = tassembly.assemble_csr(tm, tassembly.element_stiffness(tm))
    mask = np.ones(jm.n_nodes)
    mask[jbc.ChannelBoundary.build(jm).dirichlet] = 0.0
    return (jcls.build(jK, dtype=jnp.float64),
            tcls.build(tK, dtype=torch.float64, device=CPU), mask)


@functools.lru_cache(maxsize=None)
def _problems(storage: str, **kw):
    """tpufem's and the port's Stokes problem on ``storage``."""
    pad = STORAGES[storage][2]
    jm, tm = meshes(*MESH, pad_hole=pad)
    cfg = dict(solver="cg", cg_storage=storage, **kw)
    return (jstokes.StokesProblem.build(jm, jstokes.StokesConfig(**cfg)),
            tstokes.StokesProblem.build(tm, tstokes.StokesConfig(**cfg), device=CPU))


@pytest.mark.parametrize("storage", list(STORAGES))
def test_halo_viscous_solver_matches_tpufem(storage):
    """80 iterations on two columns: within 1e-9 of tpufem's halo solve and
    of the port's single-device ``ViscousCG`` (tpufem's own bound)."""
    jop, top, mask = _operators(storage)
    make_j = {"banded": jhalo.make_halo_viscous_solver,
              "stencil": jhs.make_stencil_halo_viscous_solver}[storage]
    make_t = {"banded": halo.make_halo_viscous_solver,
              "stencil": halo_stencil.make_stencil_halo_viscous_solver}[storage]
    b = np.random.default_rng(0).standard_normal((top.n, 2))
    want = np.asarray(make_j(_jax_mesh(), jop, mask, 0.005, iters=80)(jnp.asarray(b)))
    got = make_t(_cpu_mesh(), top, mask, 0.005, iters=80)(torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    single = ViscousCG(K=top, interior_mask=torch.as_tensor(mask), dt_nu=0.005, iters=80)
    np.testing.assert_allclose(got, single.solve(torch.as_tensor(b)).numpy(), rtol=0, atol=1e-9)


@pytest.mark.parametrize("storage", list(STORAGES))
def test_halo_pressure_solver_matches_tpufem(storage):
    """The merged periodic pressure, 300 iterations, on a divergence
    right-hand side: within 1e-9 of tpufem's halo solve, and of the port's
    single-device ``PressureCG`` within tpufem's 1e-7 up to the constant
    gauge on the active dofs."""
    jp, tp = _problems(storage, cg_iters_pressure=300)
    jps, tps = jp.pressure_solver, tp.pressure_solver
    make_j = {"banded": jhalo.make_halo_pressure_solver,
              "stencil": jhs.make_stencil_halo_pressure_solver}[storage]
    make_t = {"banded": halo.make_halo_pressure_solver,
              "stencil": halo_stencil.make_stencil_halo_pressure_solver}[storage]
    u = np.random.default_rng(0).standard_normal((tp.mesh.n_nodes, 2))
    b = -np.asarray(jcalculus.divergence(jp.mesh, jnp.asarray(u))) / 0.01
    want = np.asarray(make_j(_jax_mesh(), jps.K_merged, jps.m_lumped, jps.masters, jps.slaves,
                             np.asarray(jps.active_mask), iters=300)(jnp.asarray(b)))
    got = make_t(_cpu_mesh(), tps.K_merged, tps.m_lumped, tps.masters, tps.slaves,
                 tps.active_mask, iters=300)(torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    single = tps.solve(torch.as_tensor(b)).numpy()
    act = tps.active_mask.numpy() > 0
    np.testing.assert_allclose(got[act] - got[act].mean(), single[act] - single[act].mean(),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_stencil_layout_matches_tpufem(shards):
    """``build_stencil_layout``'s tables array-equal to tpufem's, on the
    pad_hole stiffness (a short remainder) and the stiffness of the mesh
    without the hole (16 offsets, a long remainder)."""
    jop, top, _ = _operators("stencil")
    jm, tm = meshes(*MESH)
    ops = [(jop, top)]
    jK = jassembly.assemble_csr(jm, jassembly.element_stiffness(jm))
    tK = tassembly.assemble_csr(tm, tassembly.element_stiffness(tm))
    ops.append((JStencil.build(jK, dtype=jnp.float64),
                TStencil.build(tK, dtype=torch.float64, device=CPU)))
    for j, t in ops:
        want = jhs.build_stencil_layout(j, shards)
        got = halo_stencil.build_stencil_layout(t, shards)
        for f in ("offsets", "bw", "rows", "n_pad", "has_local", "has_cross"):
            assert getattr(got, f) == getattr(want, f), f
        for f in ("diags", "lrows", "lcols", "ldata", "send_idx", "crows", "cpos", "cdata"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert want.has_cross


@pytest.mark.parametrize("storage", list(STORAGES))
def test_sharded_step_matches_tpufem(storage):
    """Three sharded steps from rest on the banded and stencil branches:
    the port's against tpufem's sharded step within 1e-10 in u, and
    against the port's single-device run within tpufem's 1e-7."""
    jp, tp = _problems(storage, **STEP)
    jstep = jss.make_sharded_matfree_step(_jax_mesh(), jp)
    step = stokes_sharded.make_sharded_matfree_step(_cpu_mesh(), tp)
    ju = jstokes.initial_state(jp)["u"]
    u = tstokes.initial_state(tp)["u"]
    for _ in range(3):
        ju, jm = jstep(ju)
        u, m = step(u)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=1e-10)
    for key in ("div_star_max", "final_div_max", "max_u"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-8)
    single, _ = tstokes.run(tp, steps=3)
    np.testing.assert_allclose(u.numpy(), single["u"].numpy(), rtol=0, atol=1e-7)


def test_halo_refusals():
    """Blocks no deeper than the band (tpufem's assertion, as a ValueError)
    and the sharded step's K6 halo on stencil storage."""
    _, band, _ = _operators("banded")
    with pytest.raises(ValueError, match="must exceed bandwidth"):
        halo.make_halo_viscous_solver(_cpu_mesh(band.n // band.bandwidth + 1), band,
                                      np.ones(band.n), 0.005, iters=1)
    with pytest.raises(ValueError, match="halo='ppermute'"):
        stokes_sharded.make_sharded_matfree_step(_cpu_mesh(), _problems("stencil", **STEP)[1],
                                                 halo="rdma")
