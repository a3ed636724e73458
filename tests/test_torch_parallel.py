"""The sharded grid path (``tpufem_torch.parallel``) against tpufem's, on the
CPU: the ring halo (K6's plain version) against tpufem's ``ppermute`` halo
and its remote-DMA kernel in interpret mode, the sharded grid solvers and
Stokes step on ``generate_annulus_mesh(28, 32, pad_hole=True)`` at f64, the
distributed CSR viscous CG, and the refusals.  tpufem's sharded functions
run under ``shard_map`` on the 8 virtual CPU devices of ``conftest.py``;
the port's shards all live on ``cpu``."""

import dataclasses
import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JDeviceMesh
from jax.sharding import PartitionSpec as P

from tpufem import bc as jbc
from tpufem.ops import assembly as jassembly
from tpufem.parallel import dist_cg as jdist
from tpufem.parallel import grid_remote_dma as jrdma
from tpufem.parallel import grid_sharded as jgs
from tpufem.parallel import stokes_sharded as jss
from tpufem.workloads import stokes as jstokes
from tpufem_torch import interop
from tpufem_torch.ops import assembly as tassembly
from tpufem_torch.parallel import dist_cg, grid_remote_dma, grid_sharded, spmd, stokes_sharded
from tpufem_torch.solve.matfree import ViscousCG
from tpufem_torch.workloads import stokes as tstokes

from tests._torch_parity import jax_problem_arrays, meshes

torch.set_num_threads(2)

CPU = torch.device("cpu")
MESH = (28, 32)  # pad_hole: a 28×28 grid, 7-row strips on 4 shards
GRID = dict(solver="cg", cg_storage="grid_interpret", precision="f64", cg_precond="twolevel",
            cg_iters_visc=25, cg_iters_pressure=40, cg_warm_start=False, transport="none")
# the tol case of tpufem's test_sharded_grid_solvers_tolerance_early_exit
TOL = dict(iters_visc=60, iters_pressure=80, tol=1e-8)


def _jax_mesh(n: int, data: int | None = None):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    devs = np.asarray(jax.devices()[:n])
    if data is None:
        return JDeviceMesh(devs, ("space",))
    return JDeviceMesh(devs.reshape(data, n // data), ("data", "space"))


def _cpu_mesh(n: int, axes=("data", "space")):
    if axes == ("space",):
        return spmd.DeviceMesh(shape={"space": n}, devices=(CPU,) * n, axis_names=axes)
    return spmd.build_device_mesh(n, devices=["cpu"] * n)


@functools.lru_cache(maxsize=None)
def _problems():
    """tpufem's grid problem and the port's, built from tpufem's arrays."""
    jm, tm = meshes(*MESH, pad_hole=True)
    jp = jstokes.StokesProblem.build(jm, jstokes.StokesConfig(**GRID))
    tp = interop.problem_from_numpy(jax_problem_arrays(jp), tm, tstokes.StokesConfig(**GRID),
                                    device=CPU)
    return jp, tp


def _with_tol(problem):
    """``problem`` with tpufem's early-exit iteration caps and tolerance."""
    v, p = problem.visc_solver, problem.pressure_solver
    return dataclasses.replace(
        problem, visc_solver=dataclasses.replace(v, iters=TOL["iters_visc"], tol=TOL["tol"]),
        pressure_solver=dataclasses.replace(p, iters=TOL["iters_pressure"], tol=TOL["tol"]))


@pytest.mark.parametrize("d", [1, 3])
def test_halo_matches_tpufem_ppermute_and_rdma(d):
    """The port's ``_halo_exchange``, ``halo_rdma_ref`` and ``make_halo_rdma``
    (CPU strips: the plain version) are array-equal to tpufem's ppermute
    halo and its remote-DMA kernel (interpret mode) at S = 8, ns = 32."""
    S, ns = 8, 32
    x = np.random.default_rng(d).standard_normal((ns, ns))
    dm = _jax_mesh(S)
    spec = dict(mesh=dm, in_specs=P("space", None), out_specs=P("space", None), check_vma=False)
    jhalo = jrdma.make_halo_rdma("space")
    want_rdma = np.asarray(jax.jit(shard_map(lambda xl: jhalo(xl, d), **spec))(jnp.asarray(x)))
    want_pp = np.asarray(jax.jit(shard_map(
        lambda xl: jgs._halo_exchange(xl, d, S, "space"), **spec))(jnp.asarray(x)))
    np.testing.assert_array_equal(want_rdma, want_pp)

    strips = list(torch.as_tensor(x).split(ns // S))
    before = grid_remote_dma.halo_rdma.launches
    for got in (grid_sharded._halo_exchange(strips, d), grid_remote_dma.halo_rdma_ref(strips, d),
                grid_remote_dma.make_halo_rdma(_cpu_mesh(S, ("space",)))(strips, d)):
        np.testing.assert_array_equal(torch.cat(got).numpy(), want_rdma)
    assert grid_remote_dma.halo_rdma.launches == before  # CPU strips launch nothing


def test_halo_rdma_wrapper_checks_its_inputs():
    strips = list(torch.zeros(16, 8, dtype=torch.float64).split(4))
    with pytest.raises(ValueError, match="halo depth"):
        grid_remote_dma.halo_rdma(strips, 5)
    with pytest.raises(ValueError, match="one shape"):
        grid_remote_dma.halo_rdma(strips[:-1] + [torch.zeros(4, 8)], 1)
    with pytest.raises(ValueError, match="shards' devices"):
        grid_remote_dma.make_halo_rdma(_cpu_mesh(2, ("space",)))(strips, 1)
    assert grid_remote_dma.halo_rdma(strips, 0) == strips


def test_device_mesh_shape_rule_and_collectives():
    assert _cpu_mesh(8).shape == {"data": 2, "space": 4}
    assert spmd.build_device_mesh(devices=["cpu"] * 3).shape == {"data": 1, "space": 3}
    dm = spmd.build_device_mesh(6, data=3, devices=["cpu"] * 8)
    assert dm.shape == {"data": 3, "space": 2} and len(dm.axis_devices("data")) == 3
    parts = [torch.full((2,), float(i)) for i in range(4)]
    assert [p.tolist() for p in spmd.psum(parts)] == [[6.0, 6.0]] * 4
    assert spmd.all_gather(parts)[3].tolist() == [0.0, 0.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0]


@pytest.mark.parametrize("case,bounds", [("fixed", (1e-12, 1e-9)), ("tol", (1e-6, 1e-5))])
def test_sharded_grid_solvers_match_tpufem(case, bounds):
    """Port and tpufem sharded solvers (4 shards, two-level, f64) from the
    same operators, to 1e-14 (both round as tpufem's sharded form does); the
    port's against its single-device plain solvers within tpufem's own
    bounds for its sharded against its single-device solvers (those round
    the remainder through float32), and its K6 path (the plain version on
    the CPU) bit-equal to ``ppermute``."""
    jp, tp = _problems()
    if case == "tol":
        jp, tp = _with_tol(jp), _with_tol(tp)
    jvs, jps = jgs.make_sharded_grid_solvers(_jax_mesh(8, data=2), jp)
    tvs, tps = grid_sharded.make_sharded_grid_solvers(_cpu_mesh(8), tp)
    rvs, rps = grid_sharded.make_sharded_grid_solvers(_cpu_mesh(8), tp, halo="rdma")
    rng = np.random.default_rng(0)
    n = tp.mesh.n_nodes
    for (jfn, tfn, rfn, single), shape, bound in (
            ((jvs, tvs, rvs, tp.visc_solver.solve), (n, 2), bounds[0]),
            ((jps, tps, rps, tp.pressure_solver.solve), (n,), bounds[1])):
        b = rng.standard_normal(shape)
        got = tfn(torch.as_tensor(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(jfn(jnp.asarray(b))), rtol=0,
                                   atol=1e-14)
        np.testing.assert_allclose(got.numpy(), single(torch.as_tensor(b)).numpy(), rtol=0,
                                   atol=bound)
        np.testing.assert_array_equal(rfn(torch.as_tensor(b)).numpy(), got.numpy())


def test_sharded_step_matches_tpufem():
    """Two sharded Stokes steps from rest: the port's (both halos) against
    tpufem's on the same operators, u to 1e-10, final divergence to 1e-5."""
    jp, tp = _problems()
    jstep = jss.make_sharded_matfree_step(_jax_mesh(8, data=2), jp)
    steps = [stokes_sharded.make_sharded_matfree_step(_cpu_mesh(8), tp, halo=h)
             for h in ("ppermute", "rdma")]
    ju = jstokes.initial_state(jp)["u"]
    us = [tstokes.initial_state(tp)["u"]] * 2
    for _ in range(2):
        ju, jm = jstep(ju)
        out = [step(u) for step, u in zip(steps, us)]
        us = [u for u, _ in out]
    np.testing.assert_allclose(us[0].numpy(), np.asarray(ju), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(us[1].numpy(), us[0].numpy())
    for key in ("div_star_max", "final_div_max", "max_u"):
        np.testing.assert_allclose(float(out[0][1][key]), float(jm[key]), rtol=1e-5)


def test_sharded_viscous_cg_matches_tpufem():
    """The distributed CSR viscous CG (4 row slabs, 80 iterations) against
    tpufem's to 1e-12, and against the single-device CSR solve to tpufem's
    own 1e-9, on ``generate_annulus_mesh(20, 24)``."""
    jm, tm = meshes(20, 24)
    boundary = jbc.ChannelBoundary.build(jm)
    mask = np.ones(jm.n_nodes)
    mask[boundary.dirichlet] = 0.0
    jK = jassembly.assemble_csr(jm, jassembly.element_stiffness(jm))
    tK = tassembly.assemble_csr(tm, tassembly.element_stiffness(tm))
    b = np.random.default_rng(0).standard_normal((jm.n_nodes, 2))
    want = np.asarray(jdist.make_sharded_viscous_solver(_jax_mesh(4), jK, mask, 0.005, iters=80)(
        jnp.asarray(b)))
    got = dist_cg.make_sharded_viscous_solver(_cpu_mesh(4, ("space",)), tK, mask, 0.005,
                                              iters=80)(torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    single = ViscousCG(K=tK, interior_mask=torch.as_tensor(mask), dt_nu=0.005, iters=80)
    np.testing.assert_allclose(got, single.solve(torch.as_tensor(b)).numpy(), rtol=0, atol=1e-9)


def _csr_problem():
    _, tm = meshes(12, 16)
    return tstokes.StokesProblem.build(
        tm, tstokes.StokesConfig(solver="cg", cg_storage="csr", cg_iters_visc=5,
                                 cg_iters_pressure=5), device=CPU)


@pytest.mark.parametrize("call,error,match", [
    (lambda: grid_sharded.make_sharded_grid_solvers(_cpu_mesh(3, ("space",)), _problems()[1]),
     ValueError, "must divide"),
    (lambda: grid_sharded.make_sharded_grid_solvers(_cpu_mesh(14, ("space",)), _problems()[1]),
     ValueError, "halo depth"),
    (lambda: stokes_sharded.make_sharded_matfree_step(_cpu_mesh(4), _csr_problem()),
     ValueError, "needs cg_storage"),
    (lambda: spmd.build_device_mesh(4) if not torch.cuda.is_available() else pytest.skip("a card"),
     RuntimeError, "CUDA is not available"),
    (lambda: spmd.build_device_mesh(devices=["cpu", "meta"]), ValueError, "one kind of device"),
])
def test_refusals(call, error, match):
    with pytest.raises(error, match=match):
        call()


def test_parallel_imports_no_jax():
    """The sharded path, the ensembles, the batched transport, the sharded
    sweep and the metrics and checkpoint modules import neither JAX nor
    tpufem."""
    code = ("import sys, tpufem_torch.parallel, tpufem_torch.transport, tpufem_torch.interop, "
            "tpufem_torch.metrics, tpufem_torch.checkpoint, tpufem_torch.workloads.sweep; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tpufem')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
