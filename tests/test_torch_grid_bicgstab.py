"""The grid path of the Navier–Stokes step: ``GridRefill`` and kernel K4
(``tpufem_torch.solve.grid_cg.NSGridBiCGStab``) in its plain version
against tpufem's refill, ``bicgstab_fixed`` and interpreted Pallas kernel,
on the operators of ``generate_annulus_mesh(20, 24, pad_hole=True)`` with
the seeded velocity of ``tests._torch_parity.ns_refill_pair``; and the
wrapper's CPU behaviour."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.ops import assembly as jassembly
from tpufem.ops import calculus as jcalculus
from tpufem.solve.cg import bicgstab_fixed as jbicgstab
from tpufem.solve.pallas_cg import NSGridBiCGStab as JNSGrid
from tpufem_torch.ops import assembly as tassembly
from tpufem_torch.ops import calculus as tcalculus
from tpufem_torch.solve import grid_cg

from tests._torch_parity import meshes, ns_refill_pair, rel

torch.set_num_threads(2)

DT, NU = 1e-4, 1.0


@functools.lru_cache(maxsize=None)
def _operators():
    """Both packages' A = Δt·C(u) + νΔt·K, refilled from the seeded u, the
    inverse diagonal 1/(1 + diag A) and a seeded right-hand side."""
    jm, jr, tp, u = ns_refill_pair()
    tm, tr = tp.mesh, tp.grid_refill
    jC = jr.refill(jassembly.element_convection(jm, jnp.asarray(u), variant="opsplit"))
    jK = jr.refill(jnp.asarray(jassembly.element_stiffness(jm, signed=True)))
    jA = dataclasses.replace(jC, diags=DT * jC.diags + NU * DT * jK.diags,
                             rest_vals=DT * jC.rest_vals + NU * DT * jK.rest_vals)
    tC = tr.refill_flat(tassembly.element_convection_flat(tm, torch.as_tensor(u), "opsplit"))
    tK = tr.refill(tassembly.element_stiffness(tm, signed=True))
    tA = dataclasses.replace(tC, diags=DT * tC.diags + NU * DT * tK.diags,
                             rest_vals=DT * tC.rest_vals + NU * DT * tK.rest_vals)
    rng = np.random.default_rng(2)
    b = rng.standard_normal((jm.n_nodes, 2))
    return dict(jA=jA, tA=tA, jinvd=1.0 / (1.0 + jA.diag()), tinvd=1.0 / (1.0 + tA.diag()),
                b=b, u=u, ns=tr.template.ns)


def _solver(iters: int, tol: float) -> grid_cg.NSGridBiCGStab:
    t = ns_refill_pair()[2].grid_refill.template
    return grid_cg.NSGridBiCGStab(ns=t.ns, offsets=t.offsets, n_rest=t.n_rest, iters=iters,
                                  tol=tol, interpret=True)


def test_refill_matches_tpufem():
    """Planes and remainder of C(u) and K: array-equal at f64, the
    remainder in the port's target order."""
    jm, jr, tp, u = ns_refill_pair()
    tr = tp.grid_refill
    assert tr.template.offsets == jr.template.offsets
    assert tr.n_flat == len(jr.template.offsets) * jm.n_nodes + jr.template.n_rest
    jflat = jassembly.element_convection_flat(jm, jnp.asarray(u), variant="opsplit")
    tflat = tassembly.element_convection_flat(tp.mesh, torch.as_tensor(u), "opsplit")
    for jop, top in ((jr.refill_flat(jflat), tr.refill_flat(tflat)),
                     (jr.refill(jnp.asarray(jassembly.element_stiffness(jm, signed=True))),
                      tr.refill(tassembly.element_stiffness(tp.mesh, signed=True)))):
        np.testing.assert_array_equal(top.diags.numpy(), np.asarray(jop.diags))
        m = top.n_rest
        np.testing.assert_array_equal(top.rest_vals.numpy(), np.asarray(jop.rest_vals)[:m, 0])


def test_refilled_operator_applies_convection():
    """tpufem's ``test_ns_grid_refill_matches_convection_apply`` on the
    port, plus the port's ``convection_apply`` against tpufem's."""
    jm, _, tp, u = ns_refill_pair()
    x = np.random.default_rng(3).standard_normal(tp.mesh.n_nodes)
    C = tp.grid_refill.refill(tassembly.element_convection(tp.mesh, torch.as_tensor(u), "opsplit"))
    got = tcalculus.convection_apply(tp.mesh, torch.as_tensor(u), torch.as_tensor(x), "opsplit")
    np.testing.assert_allclose(C.matvec(torch.as_tensor(x)).numpy(), got.numpy(), rtol=0, atol=1e-12)
    for variant in ("opsplit", "stokescolor"):
        want = jcalculus.convection_apply(jm, jnp.asarray(u), jnp.asarray(x), variant=variant)
        got = tcalculus.convection_apply(tp.mesh, torch.as_tensor(u), torch.as_tensor(x), variant)
        assert rel(got.numpy(), np.asarray(want)) <= 1e-12


def test_plain_k4_matches_tpufem_bicgstab_fixed():
    """tpufem's ``test_ns_grid_bicgstab_kernel_matches_xla`` across the
    packages: 150 fixed iterations from zero, each column against tpufem's
    ``bicgstab_fixed`` on its refilled operator."""
    o = _operators()
    x = _solver(150, 0.0).solve(o["tA"], torch.ones(o["b"].shape[0], dtype=torch.float64),
                                o["tinvd"], torch.as_tensor(o["b"]),
                                torch.zeros(o["b"].shape, dtype=torch.float64)).numpy()
    for c in range(2):
        xc, _ = jbicgstab(lambda v: v + o["jA"].matvec(v), jnp.asarray(o["b"][:, c]),
                          x0=jnp.zeros(o["b"].shape[0]), iters=150,
                          precond=lambda r: o["jinvd"] * r)
        np.testing.assert_allclose(x[:, c], np.asarray(xc), rtol=0, atol=1e-10)


def test_plain_k4_matches_tpufem_kernel_tol_warm():
    """Lockstep columns, ``tol=1e-8`` from a warm start (the seeded u),
    against tpufem's kernel in interpret mode; the iteration count lands in
    the counter."""
    o = _operators()
    jsolver = JNSGrid(ns=o["ns"], offsets=o["jA"].offsets, n_rest=o["jA"].n_rest, iters=60,
                      tol=1e-8, interpret=True)
    n = o["b"].shape[0]
    want = jsolver.solve(o["jA"], jnp.ones(n), o["jinvd"], jnp.asarray(o["b"]), jnp.asarray(o["u"]))
    count = torch.zeros(1, dtype=torch.int32)
    solver = dataclasses.replace(_solver(60, 1e-8), iters_count=count)
    got = solver.solve(o["tA"], torch.ones(n, dtype=torch.float64), o["tinvd"],
                       torch.as_tensor(o["b"]), torch.as_tensor(o["u"]))
    assert rel(got.numpy(), np.asarray(want)) <= 1e-10
    assert 0 < int(count.item()) < 60


@pytest.mark.parametrize("n_side", [20, 40])
def test_template_is_the_card_split_and_tpufems_here(n_side):
    """The refill template is ``GridOperator.dense_split`` of the mesh
    pattern, the split K4 applies; at these sizes tpufem's caps do not bind,
    so it is tpufem's template too (offsets, remainder entries, order)."""
    from tpufem.ops.gridop import GridRefill as JGridRefill
    from tpufem_torch.ops import assembly
    from tpufem_torch.ops.gridop import GridOperator, GridRefill, _PatternCSR

    jm, tm = meshes(n_side, n_side + 4, pad_hole=True)
    refill = GridRefill.build(tm, n_side, dtype=torch.float64, device="cpu")
    t = refill.template
    want = GridOperator.dense_split(_PatternCSR(assembly._csr_pattern(tm), tm.n_nodes), n_side,
                                    dtype=torch.float64)
    assert t.offsets == want.offsets and t.rest_round32 == want.rest_round32
    for name in ("rest_rowptr", "rest_tgt", "rest_src"):
        assert torch.equal(getattr(t, name), getattr(want, name)), name
    jt = JGridRefill.build(jm, n_side, dtype=jnp.float64).template
    assert t.offsets == jt.offsets and t.n_rest == jt.n_rest
    assert len(t.offsets) == 9


def _remainder_heavy(refill):
    """The same mesh's refill onto five planes (the rest on the remainder)."""
    from tpufem_torch.ops import assembly
    from tpufem_torch.ops.gridop import GridOperator, GridRefill, _PatternCSR

    mesh = ns_refill_pair()[2].mesh
    pattern = assembly._csr_pattern(mesh)
    template = GridOperator.build(_PatternCSR(pattern, mesh.n_nodes), refill.template.ns,
                                  dtype=torch.float64, max_offsets=5, rest_budget_bytes=None)
    return GridRefill.from_template(mesh, template, pattern)


@pytest.mark.parametrize("iters,tol", [(30, 0.0), (60, 1e-8)], ids=["fixed30", "tol1e-8-warm"])
def test_plain_k4_agrees_on_a_remainder_heavy_layout(iters, tol):
    """One refilled operator on two layouts, the template's (9 planes) and
    five planes with the rest on the remainder: K4's plain version gives the
    same x at f64, fixed 30 iterations from zero and tol 1e-8 from the
    warm start."""
    jm, _, tp, u = ns_refill_pair()
    o = _operators()
    heavy = _remainder_heavy(tp.grid_refill)
    assert len(heavy.template.offsets) == 5 and heavy.template.n_rest > 10 * o["tA"].n_rest
    tm = tp.mesh
    C = heavy.refill_flat(tassembly.element_convection_flat(tm, torch.as_tensor(u), "opsplit"))
    K = heavy.refill(tassembly.element_stiffness(tm, signed=True))
    A = dataclasses.replace(C, diags=DT * C.diags + NU * DT * K.diags,
                            rest_vals=DT * C.rest_vals + NU * DT * K.rest_vals)
    np.testing.assert_allclose(A.diag().numpy(), o["tA"].diag().numpy(), rtol=0, atol=1e-15)
    n = o["b"].shape[0]
    b = torch.as_tensor(o["b"])
    x0 = torch.as_tensor(o["u"]) if tol else torch.zeros_like(b)
    xs = []
    for op in (o["tA"], A):
        solver = grid_cg.NSGridBiCGStab(ns=op.ns, offsets=op.offsets, n_rest=op.n_rest,
                                        iters=iters, tol=tol, interpret=True)
        xs.append(solver.solve(op, torch.ones(n, dtype=torch.float64), o["tinvd"], b, x0).numpy())
    assert rel(xs[1], xs[0]) <= 1e-12


def test_wrapper_plain_on_cpu_and_raises_elsewhere():
    o = _operators()
    solver = _solver(20, 1e-8)
    ns = o["ns"]
    b = torch.as_tensor(o["b"]).T.reshape(2, ns, ns).contiguous()
    mask = torch.ones(ns, ns, dtype=torch.float64)
    invd = o["tinvd"].reshape(ns, ns)
    before = grid_cg.ns_bicgstab.launches
    it_k, it_p = torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    x = grid_cg.ns_bicgstab(solver, o["tA"], mask, invd, b, torch.zeros_like(b), it_k)
    want = grid_cg.ns_bicgstab_ref(solver, o["tA"], mask, invd, b, torch.zeros_like(b), it_p)
    torch.testing.assert_close(x, want, rtol=0, atol=0)
    assert it_k.item() == it_p.item() > 0
    assert grid_cg.ns_bicgstab.launches == before
    with pytest.raises(ValueError):
        grid_cg.ns_bicgstab(solver, o["tA"], mask, invd, b[:, :-1], torch.zeros_like(b[:, :-1]))
    with pytest.raises(TypeError):
        grid_cg.ns_bicgstab(solver, o["tA"], mask, invd, b.float(), torch.zeros_like(b).float())
    meta = dataclasses.replace(o["tA"], diags=o["tA"].diags.to("meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        grid_cg.ns_bicgstab(solver, meta, mask.to("meta"), invd.to("meta"), b.to("meta"),
                            b.to("meta"))
