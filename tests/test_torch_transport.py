"""tpufem_torch transport against tpufem at float64 on a jittered lattice
(lattice points sit on mesh edges, where containment is a knife-edge tie):
point location, interpolation, 20 tracer steps with capture, and
semi-Lagrangian dye advection with the mixing index."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem import transport as jtr
from tpufem_torch import transport as ttr

from tests._torch_parity import jittered, meshes

torch.set_num_threads(2)

MESHES = [(12, 16), (20, 24)]


def _locators(n_side, n_circle):
    jm, tm = meshes(n_side, n_circle)
    g = int(2 * np.sqrt(jm.n_tris))
    return jm, tm, jtr.GridLocator.build(jm, g=g), ttr.GridLocator.build(tm, g=g)


def _swirl(coords: np.ndarray) -> np.ndarray:
    """A smooth nodal velocity field that carries tracers across cells."""
    x, y = coords[:, 0], coords[:, 1]
    return np.stack([0.8 * np.sin(np.pi * y) + 0.3, 0.5 * np.sin(2 * np.pi * x)], axis=1)


def test_barycentric():
    rng = np.random.default_rng(5)
    tri = rng.standard_normal((50, 3, 2))
    p = rng.standard_normal((50, 2))
    wj, dj = jtr._barycentric(jnp.asarray(tri), jnp.asarray(p))
    wt, dt = ttr._barycentric(torch.as_tensor(tri), torch.as_tensor(p))
    np.testing.assert_allclose(wt.numpy(), wj, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-12, atol=0)


@pytest.mark.parametrize("n_side,n_circle", MESHES)
def test_find_and_interpolate(n_side, n_circle):
    jm, tm, jl, tl = _locators(n_side, n_circle)
    # the seed lattice plus points outside the domain and inside the hole
    pts = jittered(np.concatenate([jtr.init_tracer_grid(31), [[1.2, 0.5], [0.5, 0.5], [-0.1, 0.3]]]))
    pj, pt = jnp.asarray(pts), torch.as_tensor(pts)
    tri_j, found_j, w_j = jl.find(pj, return_weights=True)
    tri_t, found_t, w_t = tl.find(pt, return_weights=True)
    np.testing.assert_array_equal(found_t.numpy(), found_j)
    assert not found_t[-3:].any() and found_t[:-3].all()
    np.testing.assert_array_equal(tri_t.numpy(), tri_j)
    np.testing.assert_allclose(w_t.numpy(), w_j, rtol=0, atol=1e-12)
    rng = np.random.default_rng(11)
    for shape in ((jm.n_nodes,), (jm.n_nodes, 2)):
        field = rng.standard_normal(shape)
        vj, _ = jtr.interpolate(jm, jnp.asarray(field), pj, jl)
        vt, _ = ttr.interpolate(tm, torch.as_tensor(field), pt, tl)
        np.testing.assert_allclose(vt.numpy(), vj, rtol=0, atol=1e-12)


def _jax_tracer_step(jm, jl, p, s, u, method):
    p = jtr.tracer_step(jm, jl, p, u, 0.01, method=method)
    return p, jtr.capture_update(p, s, (0.5, 0.5), 0.28)


@pytest.mark.parametrize("n_side,n_circle", MESHES)
def test_tracer_steps_and_capture(n_side, n_circle):
    jm, tm, jl, tl = _locators(n_side, n_circle)
    u = _swirl(jm.coords)
    pts = jittered(jtr.init_tracer_grid(25))
    pj, pt = jnp.asarray(pts), torch.as_tensor(pts)
    sj = jnp.zeros(len(pts), dtype=jnp.int32)
    st = torch.zeros(len(pts), dtype=torch.int32)
    uj, ut = jnp.asarray(u), torch.as_tensor(u)
    jax_step = {
        m: jax.jit(lambda p, s, m=m: _jax_tracer_step(jm, jl, p, s, uj, m))
        for m in ("euler", "rk2")
    }
    for k in range(20):
        method = "rk2" if k % 2 else "euler"
        pj, sj = jax_step[method](pj, sj)
        pt = ttr.tracer_step(tm, tl, pt, ut, 0.01, method=method)
        st = ttr.capture_update(pt, st, (0.5, 0.5), 0.28)
    np.testing.assert_allclose(pt.numpy(), pj, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(st.numpy(), sj)
    assert 0 < int(st.sum()) < len(pts)  # some, not all, were captured


@pytest.mark.parametrize("n_side,n_circle", MESHES)
def test_semilagrange_dye_and_mixing(n_side, n_circle):
    jm, tm, jl, tl = _locators(n_side, n_circle)
    u = _swirl(jm.coords)
    c0 = (jm.coords[:, 0] < 0.5).astype(np.float64)
    cj, ct = jnp.asarray(c0), torch.as_tensor(c0)
    uj, ut = jnp.asarray(u), torch.as_tensor(u)
    mass = np.random.default_rng(2).uniform(0.5, 1.5, jm.n_nodes)
    mask = jm.markers == 0
    jax_advect = jax.jit(lambda c: jtr.advect_semilagrange(jm, jl, c, uj, 0.05))
    for _ in range(5):
        cj = jax_advect(cj)
        ct = ttr.advect_semilagrange(tm, tl, ct, ut, 0.05)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=1e-12)
    got = ttr.mixing_index(ct, torch.as_tensor(mass), torch.as_tensor(mask))
    want = jtr.mixing_index(cj, jnp.asarray(mass), jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-12)
