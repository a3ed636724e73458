"""The dense P2/P1 Taylor–Hood solvers of the port
(``tpufem_torch.workloads.navier_stokes``) and ``mesh.p2.p2_refine`` against
tpufem's on a P2-refined generated mesh, f64 on the CPU, from the port's
own build and from tpufem's arrays (``interop``).  Each tolerance has the
value measured on the CPU beside it."""

import functools

import numpy as np
import pytest
import torch

from tpufem.mesh.p2 import p2_refine as jp2_refine
from tpufem.workloads import navier_stokes as jns
from tpufem_torch import interop
from tpufem_torch.mesh.p2 import p2_refine as tp2_refine
from tpufem_torch.workloads import navier_stokes as tns

from tests._torch_parity import meshes, rel

torch.set_num_threads(2)

CPU = torch.device("cpu")
MESH = (12, 16)
SNAP = dict(snap_center=(0.5, 0.5), snap_radius=0.25)
STEPS = 20
TRANSIENT = dict(dt=0.01)


@functools.lru_cache(maxsize=None)
def p2_meshes():
    """(tpufem's, the port's) snapped P2 refinement of ``MESH``: 452 nodes,
    1,032 dofs."""
    jm, tm = meshes(*MESH)
    return jp2_refine(jm, **SNAP), tp2_refine(tm, **SNAP)


@pytest.mark.parametrize("snap", [False, True])
def test_p2_refine_matches_tpufem(snap):
    jm, tm = meshes(*MESH)
    kw = SNAP if snap else {}
    want, got = jp2_refine(jm, **kw), tp2_refine(tm, **kw)
    for field in ("coords", "tris", "tris_p2", "markers", "det", "area", "grads", "valid",
                  "holes"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_assemble_taylor_hood_matches_tpufem():
    """1e-13 relative (measured 0: the host assembly is the same NumPy)."""
    jm, tm = p2_meshes()
    A, b, corners = jns.assemble_taylor_hood(jm)
    got_A, got_b, got_corners = tns.assemble_taylor_hood(tm)
    assert rel(got_A, A) <= 1e-13
    assert rel(got_b, b) <= 1e-13
    np.testing.assert_array_equal(got_corners, corners)


def test_solve_taylor_hood_matches_tpufem():
    """1e-10 relative in u and p (measured 1.5e-15 and 1.1e-14); tpufem's
    residual gate (< 1e-10) and the squirmer and no-slip BCs."""
    jm, tm = p2_meshes()
    u_want, p_want, _ = jns.solve_taylor_hood(jm)
    u, p, res = tns.solve_taylor_hood(tm, device=CPU)
    assert rel(u.numpy(), np.asarray(u_want)) <= 1e-10
    assert rel(p.numpy(), np.asarray(p_want)) <= 1e-10
    assert float(res) < 1e-10
    from tpufem_torch import bc

    inner = np.nonzero(tm.markers == 2)[0]
    np.testing.assert_allclose(u.numpy()[inner], bc.squirmer_values(tm.coords, inner),
                               atol=1e-12)
    np.testing.assert_allclose(u.numpy()[tm.markers == 1], 0.0, atol=1e-12)


@functools.lru_cache(maxsize=None)
def jax_transient():
    jm, _ = p2_meshes()
    problem = jns.TransientTHProblem.build(jm, jns.TransientTHConfig(**TRANSIENT))
    u, p, metrics = jns.run_transient_th(problem, STEPS)
    return problem, np.asarray(u), np.asarray(p), {k: np.asarray(v) for k, v in metrics.items()}


@pytest.mark.parametrize("source", ["port", "tpufem"])
def test_transient_taylor_hood_matches_tpufem(source):
    """20 θ-steps at f64 from rest, built by the port or carried across from
    tpufem's inverse: 1e-10 relative in u, p and the per-step metrics
    (measured 3.2e-16, 3.1e-15, and 0 and 8.4e-16, from either)."""
    jp, u_want, p_want, m_want = jax_transient()
    _, tm = p2_meshes()
    cfg = tns.TransientTHConfig(**TRANSIENT)
    if source == "port":
        problem = tns.TransientTHProblem.build(tm, cfg, device=CPU)
        np.testing.assert_array_equal(problem.bc_dofs, jp.bc_dofs)
    else:
        arrays = {"e_inv": np.asarray(jp.e_inv), "r_op": np.asarray(jp.r_op),
                  "bc_dofs": jp.bc_dofs, "bc_values": np.asarray(jp.bc_values),
                  "corners": jp.corners}
        problem = interop.th_problem_from_numpy(arrays, tm, cfg, CPU)
    u, p, metrics = tns.run_transient_th(problem, STEPS)
    assert rel(u.numpy(), u_want) <= 1e-10
    assert rel(p.numpy(), p_want) <= 1e-10
    for key in ("max_u", "div_max"):
        assert metrics[key].shape == (STEPS,)
        assert rel(metrics[key].numpy(), m_want[key]) <= 1e-10


def test_transient_taylor_hood_f32_tracks_f64():
    """The f32 θ-scheme within 1e-4 of the f64 one over 20 steps (measured
    1.1e-7)."""
    _, tm = p2_meshes()
    runs = {}
    for precision in ("f64", "f32"):
        problem = tns.TransientTHProblem.build(
            tm, tns.TransientTHConfig(precision=precision, **TRANSIENT), device=CPU)
        runs[precision] = tns.run_transient_th(problem, STEPS)[0]
    assert runs["f32"].dtype == torch.float32
    assert rel(runs["f32"].numpy(), runs["f64"].numpy()) <= 1e-4


def test_taylor_hood_needs_a_p2_mesh():
    with pytest.raises(ValueError, match="P2"):
        tns.assemble_taylor_hood(meshes(*MESH)[1])
