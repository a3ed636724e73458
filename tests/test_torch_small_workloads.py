"""The small workloads of the port (advection–diffusion, graph average,
Stam's grid solver) against tpufem's on generated meshes and grids, f64 on
the CPU, from the port's own build and from tpufem's arrays (``interop``);
and tpufem's physics checks of Stam's solver repeated on the port.  Each
tolerance has the value measured on the CPU beside it."""

import functools

import jax
import numpy as np
import pytest
import torch

from tpufem.workloads import advection_diffusion as jad
from tpufem.workloads import graph_average as jga
from tpufem.workloads import stam_grid as jstam
from tpufem_torch import interop
from tpufem_torch.workloads import advection_diffusion as tad
from tpufem_torch.workloads import graph_average as tga
from tpufem_torch.workloads import stam_grid as tstam

from tests._torch_parity import meshes, rel

torch.set_num_threads(2)

CPU = torch.device("cpu")
MESH = (20, 24)
AD_STEPS = 100
STAM_FRAMES = 20
# tpufem's physics-check configuration of Stam's solver
STAM_CHECK = dict(size=64, inflow_radius=16, solver_iters=10)


@functools.lru_cache(maxsize=None)
def jax_ad(**kw):
    problem = jad.ADProblem.build(meshes(*MESH)[0], jad.ADConfig(**kw))
    f, maxf = jad.run(problem, AD_STEPS)
    return problem, np.asarray(f), np.asarray(maxf)


@pytest.mark.parametrize("solver", ["lu", "inverse"])
def test_advection_diffusion_matches_tpufem(solver):
    """100 steps at f64: 1e-12 relative in f and in max f per step
    (measured 1.6e-15 and 1.2e-15 with LU, 1.8e-15 and 9.7e-16 with the
    inverse)."""
    _, f_want, max_want = jax_ad(solver=solver)
    problem = tad.ADProblem.build(meshes(*MESH)[1], tad.ADConfig(solver=solver), device=CPU)
    f, maxf = tad.run(problem, AD_STEPS)
    assert rel(f.numpy(), f_want) <= 1e-12
    assert rel(maxf.numpy(), max_want) <= 1e-12
    np.testing.assert_allclose(f.numpy()[meshes(*MESH)[1].markers != 0], 0.0, atol=1e-10)


def test_advection_diffusion_from_tpufem_arrays():
    """The port stepping tpufem's factored system and mass: 1e-12
    (measured 1.6e-15)."""
    jp, f_want, _ = jax_ad(solver="lu")
    arrays = {"solver.lu": np.asarray(jp.solver.lu), "solver.piv": np.asarray(jp.solver.piv),
              "mass": np.asarray(jp.mass), "dirichlet": jp.dirichlet,
              "inject_idx": jp.inject_idx, "inject_vals": jp.inject_vals}
    problem = interop.ad_problem_from_numpy(arrays, meshes(*MESH)[1], tad.ADConfig(), CPU)
    f, _ = tad.run(problem, AD_STEPS)
    assert rel(f.numpy(), f_want) <= 1e-12


def test_advection_diffusion_advects_downstream():
    """tpufem's physics check: at c = (5, 5), downstream (up-right) of an
    injection the concentration exceeds the upstream side."""
    _, tm = meshes(*MESH)
    cfg = tad.ADConfig(steps=200, injections=(((0.2, 0.2), 10.0),), init_blobs=())
    f, _ = tad.run(tad.ADProblem.build(tm, cfg, device=CPU))
    f, c = f.numpy(), tm.coords
    down = (c[:, 0] > 0.25) & (c[:, 0] < 0.45) & (c[:, 1] > 0.25) & (c[:, 1] < 0.45)
    up = (c[:, 0] < 0.15) & (c[:, 1] < 0.15)
    assert f[down].mean() > f[up].mean()


def test_graph_average_matches_tpufem():
    """1e-12 relative (measured 1.9e-16); the harmonic
    interpolation stays within the boundary values and keeps the mean-value
    property at an interior node."""
    jm, tm = meshes(*MESH)
    f_want, _ = jga.solve(jm)
    f, res = tga.solve(tm, device=CPU)
    f = f.numpy()
    assert rel(f, np.asarray(f_want)) <= 1e-12
    assert float(res) < 1e-10
    assert f.min() >= -1e-12 and f.max() <= 1.0 + 1e-12
    neigh = tga.neighbor_lists(tm)
    assert neigh == jga.neighbor_lists(jm)
    i = int(np.nonzero(tm.markers == 0)[0][5])
    np.testing.assert_allclose(f[i], np.mean(f[neigh[i]]), atol=1e-10)


def max_abs(state, want) -> float:
    return max(float(np.abs(state[k].numpy() - np.asarray(want[k])).max())
               for k in ("vx", "vy", "density"))


def test_stam_matches_tpufem():
    """``size=32``, 20 frames at f64 from rest: 1e-12 max abs in vx, vy and
    the density (measured 6.7e-16), and the max speed per frame."""
    cfg = dict(size=32, precision="f64")
    want, speed_want = jstam.run(jstam.StamConfig(**cfg), frames=STAM_FRAMES)
    got, speed = tstam.run(tstam.StamConfig(**cfg), frames=STAM_FRAMES, device=CPU)
    assert max_abs(got, want) <= 1e-12
    np.testing.assert_allclose(speed.numpy(), np.asarray(speed_want), rtol=1e-12)
    assert float(got["t"]) == pytest.approx(float(want["t"]), abs=1e-15)


def test_stam_one_frame_from_the_same_state():
    """tpufem's physics-check configuration (size 64): both packages step
    one frame from tpufem's state after 12 frames, carried across by
    ``interop.stam_state_from_numpy``: 1e-12 max abs (measured 1.1e-14).
    Free-running, this flow amplifies roundoff ~4× a frame: tpufem's own
    compiled and eager runs part by 1.4e-4 at frame 20, so a longer
    comparison from rest measures the flow, not the port."""
    jc = jstam.StamConfig(**STAM_CHECK, precision="f64")
    state, _ = jstam.run(jc, frames=12)
    want = jax.jit(lambda s: jstam.step(jc, s))(state)
    start = interop.stam_state_from_numpy({k: np.asarray(v) for k, v in state.items()}, CPU)
    got = tstam.step(tstam.StamConfig(**STAM_CHECK, precision="f64"), start)
    assert max_abs(got, want) <= 1e-12


def test_stam_state_from_numpy_refuses_other_keys():
    with pytest.raises(ValueError):
        interop.stam_state_from_numpy({"vx": np.zeros((4, 4))}, CPU)


@functools.lru_cache(maxsize=None)
def port_stam(frames: int):
    cfg = tstam.StamConfig(**STAM_CHECK)
    state, speed = tstam.run(cfg, frames=frames, device=CPU)
    return cfg, state, speed


def test_stam_run_develops_flow():
    """tpufem's check: dye from the inflow jet, advected right of it."""
    _, state, speed = port_stam(30)
    d = state["density"].numpy()
    assert np.isfinite(d).all()
    assert d.max() > 0.5
    assert d[:, 5:30].max() > 0.05
    assert bool(torch.isfinite(speed).all())


def test_stam_obstacle_blocks_flow():
    """tpufem's check: obstacle cells carry the fixed 0.1 shade (the last
    frame applied the mask at t − dt)."""
    cfg, state, _ = port_stam(20)
    mask = tstam.obstacle_mask(cfg, state["t"] - cfg.dt).numpy()
    np.testing.assert_allclose(state["density"].numpy()[mask], 0.1, atol=1e-6)


def test_stam_projection_reduces_divergence():
    """tpufem's check: the mean central divergence below 0.2 of the max speed."""
    _, state, _ = port_stam(10)
    vx, vy = state["vx"].numpy(), state["vy"].numpy()
    div = (vx[1:-1, 2:] - vx[1:-1, :-2] + vy[2:, 1:-1] - vy[:-2, 1:-1]) * 0.5
    assert np.abs(div).mean() < 0.2 * np.hypot(vx, vy).max()


@pytest.mark.parametrize("shape", [(8, 8), (4, 4), (4, 7), (6, 5)])
@pytest.mark.parametrize("b", [0, 1, 2])
def test_stam_boundaries_match_tpufem(b, shape):
    """Array-equal to tpufem's sequential boundary treatment, down to the
    smallest grid (4 × 4), and tpufem's check: b = 2 negates the top and
    bottom rows, the right wall copies."""
    x = np.random.default_rng(0).random(shape)
    y = tstam.set_boundaries(b, torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(y, np.asarray(jstam.set_boundaries(b, jax.numpy.asarray(x))))
    if b == 2:
        np.testing.assert_allclose(y[0, 1:-1], -y[1, 1:-1])
    np.testing.assert_allclose(y[1:-1, -1], y[1:-1, -2])


def test_stam_smallest_grid_matches_tpufem():
    """``size=4``, the smallest grid the corner views take: 5 frames at f64
    from rest, 1e-12 max abs (measured 0.0); a 3 × 3 grid is refused."""
    cfg = dict(size=4, precision="f64")
    want, _ = jstam.run(jstam.StamConfig(**cfg), frames=5)
    got, _ = tstam.run(tstam.StamConfig(**cfg), frames=5, device=CPU)
    assert max_abs(got, want) <= 1e-12
    with pytest.raises(ValueError, match="at least 4"):
        tstam.set_boundaries(0, torch.zeros(3, 3))
