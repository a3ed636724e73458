"""``TopKLocator`` (the reference's k-nearest-centroid locator) against
tpufem's, on the CPU.

tpufem takes the k candidates with ``jax.lax.top_k``, which puts the lower
index first among equal distances; the port takes them by a stable sort.
``torch.topk`` orders ties otherwise, and generated meshes are lattices:
at mesh nodes and centroids many rows tie at the k-th place (30 and 12 of
them on ``generate_annulus_mesh(12, 16)`` at f64, 44 and 18 at f32), and
there the port's candidates, and so the first containing triangle, must
be tpufem's.  Measured: candidate lists and tri ids equal at f64 and f32;
weights and transport 2.2e-16 (held at 1e-12, as the grid locator's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem import transport as jtr
from tpufem.workloads import stokes as jstokes
from tpufem_torch import transport as ttr
from tpufem_torch.workloads import stokes as tstokes

from tests._torch_parity import jittered, meshes

torch.set_num_threads(2)

K = 10
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}


def locators(mesh_size, precision="f64"):
    jm, tm = meshes(*mesh_size)
    return jm, tm, jtr.TopKLocator(jm, k=K), ttr.TopKLocator(
        tm, K, dtype=DTYPES[precision][1], device="cpu")


def tie_points(jm) -> np.ndarray:
    """Mesh nodes and triangle centroids: on a lattice, equidistant from
    several centroids, and lying on several triangles at once."""
    return np.concatenate([jm.coords, jm.centroids()])


@pytest.mark.parametrize("precision", list(DTYPES))
@pytest.mark.parametrize("mesh_size", [(12, 16), (20, 24)])
def test_candidates_in_tpufem_tie_order(mesh_size, precision):
    jm, tm, jl, tl = locators(mesh_size, precision)
    jdt, tdt = DTYPES[precision]
    pts = tie_points(jm)
    pj = jnp.asarray(pts, dtype=jdt)
    # tpufem's candidates, as TopKLocator.find takes them
    d2 = jnp.sum((pj[:, None, :] - jnp.asarray(jm.centroids(), dtype=jdt)[None]) ** 2, axis=-1)
    _, want = jax.lax.top_k(-d2, K)
    srt = np.sort(np.asarray(d2), axis=1)
    assert np.sum(srt[:, K - 1] == srt[:, K]) >= 10  # rows tied at the k-th place
    got = tl.candidates(torch.as_tensor(pts, dtype=tdt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tri_j, found_j = jl.find(pj)
    tri_t, found_t = tl.find(torch.as_tensor(pts, dtype=tdt))
    np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_j))
    np.testing.assert_array_equal(tri_t.numpy(), np.asarray(tri_j))


def test_find_interpolate_and_transport_match_tpufem():
    jm, tm, jl, tl = locators((12, 16))
    # the jittered seed lattice plus points outside the domain and inside the hole
    pts = jittered(np.concatenate([jtr.init_tracer_grid(31), [[1.2, 0.5], [0.5, 0.5],
                                                               [-0.1, 0.3]]]))
    pj, pt = jnp.asarray(pts), torch.as_tensor(pts)
    tri_j, found_j = jl.find(pj)
    tri_t, found_t, w_t = tl.find(pt, return_weights=True)
    np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_j))
    assert not found_t[-3:].any() and found_t[:-3].all()
    np.testing.assert_array_equal(tri_t.numpy(), np.asarray(tri_j))
    w_j, _ = jtr._barycentric(jnp.asarray(jm.coords[jm.tris])[tri_j], pj)
    np.testing.assert_allclose(w_t.numpy()[:-3], np.asarray(w_j)[:-3], rtol=0, atol=1e-12)
    rng = np.random.default_rng(11)
    for shape in ((jm.n_nodes,), (jm.n_nodes, 2)):
        field = rng.standard_normal(shape)
        vj, _ = jtr.interpolate(jm, jnp.asarray(field), pj, jl)
        vt, _ = ttr.interpolate(tm, torch.as_tensor(field), pt, tl)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-12)
    x, y = jm.coords[:, 0], jm.coords[:, 1]
    u = np.stack([0.8 * np.sin(np.pi * y) + 0.3, 0.5 * np.sin(2 * np.pi * x)], axis=1)
    c = (x < 0.5).astype(np.float64)
    uj, ut = jnp.asarray(u), torch.as_tensor(u)
    cj, ct = jnp.asarray(c), torch.as_tensor(c)
    tracers = jittered(jtr.init_tracer_grid(25))
    qj, qt = jnp.asarray(tracers), torch.as_tensor(tracers)
    for k in range(6):
        method = "rk2" if k % 2 else "euler"
        cj = jtr.advect_semilagrange(jm, jl, cj, uj, 0.05)
        ct = ttr.advect_semilagrange(tm, tl, ct, ut, 0.05)
        qj = jtr.tracer_step(jm, jl, qj, uj, 0.01, method=method)
        qt = ttr.tracer_step(tm, tl, qt, ut, 0.01, method=method)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0, atol=1e-12)


def test_topk_locator_in_stokes_build_and_batched_points():
    """``locator="topk"`` builds a TopKLocator of ``locator_k`` candidates;
    points with a leading batch axis locate as each row alone."""
    _, tm = meshes(12, 16)
    problem = tstokes.StokesProblem.build(
        tm, tstokes.StokesConfig(transport="dye", locator="topk", locator_k=7), device="cpu")
    loc = problem.locator
    assert isinstance(loc, ttr.TopKLocator) and loc.k == 7
    pts = torch.as_tensor(jittered(np.stack([tm.coords, tm.coords[::-1]]), seed=5))
    together = loc.locate(pts)
    for b in range(2):
        for a, one in zip(together, loc.locate(pts[b])):
            np.testing.assert_array_equal(a[b].numpy(), one.numpy())


def test_topk_refuses_large_meshes_as_tpufem():
    _, tm = meshes(12, 16)
    big = dataclasses.replace(tm, tris=np.tile(tm.tris, (50_001 // tm.n_tris + 1, 1)))
    assert big.n_tris > 50_000
    loc = ttr.TopKLocator(big, device="cpu")
    with pytest.raises(ValueError, match="50k triangles"):
        loc.find(torch.zeros((1, 2), dtype=torch.float64))
    problem_cfg = jstokes.StokesConfig(locator="topk")
    assert problem_cfg.locator_k == tstokes.StokesConfig().locator_k == K
