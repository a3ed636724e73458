"""The stencil and banded storages of the port (``tpufem_torch.ops.stencil``,
``tpufem_torch.ops.banded``) against tpufem's on generated meshes, f64 on
the CPU: the decomposition array-equal, the applies within 1e-13 (the
div/grad pair too), the refills of the convection matrix, the RCM band,
the interop readers, and Poisson and heat through the stencil."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.ops import assembly as jassembly
from tpufem.ops.banded import BandedOperator as JBanded
from tpufem.ops.stencil import StencilOperator as JStencil
from tpufem.ops.stencil import StencilRefill as JRefill
from tpufem.workloads import heat as jheat
from tpufem.workloads import poisson as jpoisson
from tpufem_torch import interop
from tpufem_torch.ops import assembly as tassembly
from tpufem_torch.ops import stencil as tstencil
from tpufem_torch.ops.banded import BandedOperator as TBanded
from tpufem_torch.ops.stencil import StencilOperator as TStencil
from tpufem_torch.ops.stencil import StencilRefill as TRefill
from tpufem_torch.workloads import heat as theat
from tpufem_torch.workloads import poisson as tpoisson

from tests._torch_parity import meshes, operator_arrays, rel

torch.set_num_threads(2)

CPU = torch.device("cpu")
# pad_hole: 9 grid offsets, 99 % coverage, a short remainder; without the
# hole: 16 offsets, 88 % coverage (the trimming and a long remainder)
MESHES = [(12, 16, True), (12, 16, False)]
TOL = 1e-13  # the applies: measured 0 (stencil) and ≤ 1.1e-16 (banded)


def _stiffness(mesh_key):
    jm, tm = meshes(*mesh_key)
    return (jassembly.assemble_csr(jm, jassembly.element_stiffness(jm)),
            tassembly.assemble_csr(tm, tassembly.element_stiffness(tm)))


def _x(n: int, k: int = 2):
    return np.random.default_rng(0).standard_normal((n, k))


def _jax_cols(matvec, x):
    return np.asarray(jax.vmap(matvec, in_axes=1, out_axes=1)(jnp.asarray(x)))


@pytest.mark.parametrize("mesh_key", MESHES)
def test_stencil_build_matches_tpufem(mesh_key):
    """Offsets, diagonals, the row-sorted remainder and the coverage
    array-equal to tpufem's; the default trimming and explicit offsets."""
    jK, tK = _stiffness(mesh_key)
    for kw in ({}, {"max_offsets": 4}, {"min_fill": 0.5}, {"offsets": (-1, 0, 1)}):
        js = JStencil.build(jK, dtype=jnp.float64, **kw)
        ts = TStencil.build(tK, dtype=torch.float64, device=CPU, **kw)
        assert ts.offsets == js.offsets and ts.coverage == js.coverage
        np.testing.assert_array_equal(ts.diags.numpy(), np.asarray(js.diags))
        np.testing.assert_array_equal(ts.rest_rows, js.rest_rows)
        np.testing.assert_array_equal(ts.rest_cols, np.asarray(js.rest_cols_j))
        np.testing.assert_array_equal(ts.rest_data.numpy(), np.asarray(js.rest_data))
    assert ts.n_rest > 0
    with pytest.raises(ValueError, match="offset 0"):
        TStencil.build(tK, offsets=(-1, 1), device=CPU)


@pytest.mark.parametrize("mesh_key", MESHES)
def test_stencil_matvec_and_diag_match_tpufem(mesh_key):
    """(N,) and (N, 2) applies (each column as tpufem's vmapped 1-D apply)
    and the diagonal, within 1e-13; f32 through ``astype``."""
    jK, tK = _stiffness(mesh_key)
    js = JStencil.build(jK, dtype=jnp.float64)
    ts = TStencil.build(tK, dtype=torch.float64, device=CPU)
    x = _x(ts.n)
    assert rel(ts.matvec(torch.as_tensor(x[:, 0])).numpy(),
               np.asarray(js.matvec(jnp.asarray(x[:, 0])))) <= TOL
    assert rel(ts.matvec(torch.as_tensor(x)).numpy(), _jax_cols(js.matvec, x)) <= TOL
    assert rel(ts.diag().numpy(), np.asarray(js.diag())) <= TOL
    # the CSR apply of the same operator
    assert rel(ts.matvec(torch.as_tensor(x)).numpy(), tK.matvec(torch.as_tensor(x)).numpy()) <= TOL
    f32 = ts.astype(torch.float32)
    assert f32.matvec(torch.as_tensor(x[:, 0], dtype=torch.float32)).dtype == torch.float32


@pytest.mark.parametrize("offsets,lattice", [
    ((-13, -12, -11, -1, 0, 1, 11, 12, 13), (-13, 3, 12, 3)),
    ((-2, -1, 0, 1, 2), (-2, 1, 0, 5)),
    ((-12, 0, 12), (-12, 3, 12, 1)),
    ((-13, -12, -1, 0, 1, 12, 13), None),
    ((-8, -7, -1, 0, 1, 7, 8), None),
])
def test_shift_sum_lattice_and_stack_forms_agree(offsets, lattice):
    """The strided-view form (offsets on a lattice) and the stacked form
    give the offset loop's sum."""
    assert tstencil._lattice(offsets) == lattice
    rng = np.random.default_rng(3)
    n, pad = 50, 13
    diags = torch.as_tensor(rng.standard_normal((len(offsets), n)))
    x = torch.as_tensor(rng.standard_normal((n, 2)))
    want = sum(diags[k][:, None] * tstencil.pad_rows(x, pad)[pad + o:pad + o + n]
               for k, o in enumerate(offsets))
    got = tstencil.shift_sum(diags, tstencil.pad_rows(x, pad), offsets, pad, n)
    assert rel(got.numpy(), want.numpy()) <= TOL
    got1 = tstencil.shift_sum(diags, tstencil.pad_rows(x[:, 0], pad), offsets, pad, n)
    assert rel(got1.numpy(), want[:, 0].numpy()) <= TOL


@pytest.mark.parametrize("mesh_key", MESHES)
def test_stencil_pair_is_two_applies(mesh_key):
    """The div/grad pair (one pass for Dx and Dy) against tpufem's div and
    grad, two applies and an add or a stack, within 1e-13."""
    from tpufem.ops import calculus as jcalculus
    from tpufem_torch.ops import calculus as tcalculus

    jm, tm = meshes(*mesh_key)
    jd = [JStencil.build(op, dtype=jnp.float64) for op in jcalculus.divergence_csr_operators(jm)]
    td = [TStencil.build(op, dtype=torch.float64, device=CPU)
          for op in tcalculus.divergence_csr_operators(tm)]
    pair = tstencil.StencilPair.of(*td)
    assert pair is not None and tstencil.StencilPair.of(td[0], td[0].astype(torch.float32)) is None
    u = _x(tm.n_nodes)
    want = np.asarray(jd[0].matvec(jnp.asarray(u[:, 0])) + jd[1].matvec(jnp.asarray(u[:, 1])))
    assert rel(pair.combine(torch.as_tensor(u)).numpy(), want) <= TOL
    want = np.stack([np.asarray(j.matvec(jnp.asarray(u[:, 0]))) for j in jd], axis=1)
    assert rel(pair.split(torch.as_tensor(u[:, 0])).numpy(), want) <= TOL


@pytest.mark.parametrize("mesh_key", MESHES)
def test_stencil_refill_matches_tpufem(mesh_key):
    """C(u)'s element matrices refilled onto the pattern's stencil, from the
    (T, 3, 3) and the k-major flat layouts: diagonals, remainder and an
    apply within 1e-13 of tpufem's refill."""
    jm, tm = meshes(*mesh_key)
    jr = JRefill.build(jm, dtype=jnp.float64)
    tr = TRefill.build(tm, dtype=torch.float64, device=CPU)
    assert tr.template.offsets == jr.template.offsets and tr.n_flat == jr.n_flat
    u = 0.1 * np.random.default_rng(1).standard_normal((jm.n_nodes, 2))
    x = _x(jm.n_nodes)
    pairs = [
        (jr.refill(jassembly.element_convection(jm, jnp.asarray(u), variant="opsplit")),
         tr.refill(tassembly.element_convection(tm, torch.as_tensor(u), "opsplit"))),
        (jr.refill_flat(jassembly.element_convection_flat(jm, jnp.asarray(u), variant="opsplit")),
         tr.refill_flat(tassembly.element_convection_flat(tm, torch.as_tensor(u), "opsplit"))),
    ]
    for want, got in pairs:
        assert rel(got.diags.numpy(), np.asarray(want.diags)) <= TOL
        if got.n_rest:
            assert rel(got.rest_data.numpy(), np.asarray(want.rest_data)) <= TOL
        assert rel(got.matvec(torch.as_tensor(x)).numpy(), _jax_cols(want.matvec, x)) <= TOL


@pytest.mark.parametrize("mesh_key", MESHES)
def test_banded_matches_tpufem(mesh_key):
    """The RCM permutation and bandwidth equal to tpufem's; the applies
    (global and permuted order, (N,) and (N, 2), in chunks of diagonals
    too) and the diagonal within 1e-13."""
    jK, tK = _stiffness(mesh_key)
    jb = JBanded.build(jK, dtype=jnp.float64)
    tb = TBanded.build(tK, dtype=torch.float64, device=CPU)
    assert tb.bandwidth == jb.bandwidth
    np.testing.assert_array_equal(tb.perm, jb.perm)
    np.testing.assert_array_equal(tb.inv_perm, jb.inv_perm)
    np.testing.assert_array_equal(tb.diags.numpy(), np.asarray(jb.diags))
    x = _x(tb.n)
    assert rel(tb.matvec(torch.as_tensor(x[:, 0])).numpy(),
               np.asarray(jb.matvec(jnp.asarray(x[:, 0])))) <= TOL
    assert rel(tb.matvec(torch.as_tensor(x)).numpy(), _jax_cols(jb.matvec, x)) <= TOL
    assert rel(tb.matvec_permuted(torch.as_tensor(x[:, 1])).numpy(),
               np.asarray(jb.matvec_permuted(jnp.asarray(x[:, 1])))) <= TOL
    assert rel(tb.diag().numpy(), np.asarray(jb.diag())) <= TOL
    import tpufem_torch.ops.banded as banded

    whole = tb.matvec(torch.as_tensor(x))
    chunk, banded.CHUNK_VALUES = banded.CHUNK_VALUES, 5 * tb.n * 2  # five diagonals a chunk
    try:
        assert rel(tb.matvec(torch.as_tensor(x)).numpy(), whole.numpy()) <= TOL
    finally:
        banded.CHUNK_VALUES = chunk


@pytest.mark.parametrize("kind", ["stencil", "banded", "csr"])
def test_interop_reads_tpufem_operators(kind):
    """``interop.operator_from_numpy`` carries tpufem's operator across:
    the same apply bit for bit in every storage."""
    jK, _ = _stiffness((12, 16, True))
    jop = {"stencil": lambda: JStencil.build(jK, dtype=jnp.float64),
           "banded": lambda: JBanded.build(jK, dtype=jnp.float64),
           "csr": lambda: jK}[kind]()
    op = interop.operator_from_numpy(operator_arrays(jop, "K"), "K", jK.shape[0], device=CPU)
    assert type(op).__name__ == type(jop).__name__
    x = _x(jK.shape[0], 1)[:, 0]
    np.testing.assert_allclose(op.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(jop.matvec(jnp.asarray(x))), rtol=0, atol=1e-14)


def test_poisson_through_the_stencil_matches_tpufem():
    """On the pad_hole mesh both packages take the stencil (≥ 90 %
    coverage): the two-level CG within 1e-12 of tpufem's; without the hole
    both keep CSR."""
    for pad, kind in ((True, "StencilOperator"), (False, "CSROperator")):
        jm, tm = meshes(12, 16, pad_hole=pad)
        cfg = dict(solver="cg", cg_tol=1e-10)
        op = tpoisson.build_system_csr(tm, tpoisson.PoissonConfig(**cfg), CPU)[0]
        jop = jpoisson.build_system_csr(jm, jpoisson.PoissonConfig(**cfg))[0]
        assert type(op).__name__ == type(jop).__name__ == kind
        want, _ = jpoisson.solve(jm, jpoisson.PoissonConfig(**cfg))
        got, res = tpoisson.solve(tm, tpoisson.PoissonConfig(**cfg), device=CPU)
        assert rel(got.numpy(), np.asarray(want)) <= 1e-12
        assert float(res) < 1e-8


def test_heat_through_the_stencil_matches_tpufem():
    """Heat's CG inherits Poisson's stencil: 20 steps within 1e-12 of
    tpufem's."""
    jm, tm = meshes(12, 16, pad_hole=True)
    cfg = dict(solver="cg", steps=20)
    problem = theat.HeatProblem.build(tm, theat.HeatConfig(**cfg), CPU)
    assert isinstance(problem.solver.op, TStencil)
    u, _ = theat.run(tm, theat.HeatConfig(**cfg), device=CPU)
    want, _ = jheat.run(jm, jheat.HeatConfig(**cfg))
    assert rel(u.numpy(), np.asarray(want)) <= 1e-12
