"""The grid-offset operator against tpufem's: the same offset selection,
planes and remainder on the stiffness and merged pressure operators of
generated pad_hole meshes, the same matvec and diagonal, the same refusals
and the same grid-numbering check."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem import bc as jbc
from tpufem.mesh import gridify as jgridify
from tpufem.ops import assembly as jassembly
from tpufem.ops import gridop as jgridop
from tpufem.solve.pressure import owner_map
from tpufem_torch.mesh import gridify as tgridify
from tpufem_torch.ops import assembly as tassembly
from tpufem_torch.ops import gridop as tgridop

from tests._torch_parity import meshes

torch.set_num_threads(2)


def _operators(size, merged: bool, pad_hole: bool = True):
    jm, tm = meshes(*size, pad_hole=pad_hole)
    ke_j, ke_t = jassembly.element_stiffness(jm), tassembly.element_stiffness(tm)
    if merged:
        b = jbc.ChannelBoundary.build(jm)
        owner = owner_map(jm.n_nodes, b.masters, b.slaves)
        jm = dataclasses.replace(jm, tris=owner[jm.tris].astype(np.int32))
        tm = dataclasses.replace(tm, tris=owner[tm.tris].astype(np.int32))
    return jassembly.assemble_csr(jm, ke_j), tassembly.assemble_csr(tm, ke_t)


def _remainder(op):
    """tpufem's one-hot remainder as sorted (target, source, value) rows."""
    ns, m = op.ns, op.n_rest
    gr, gl = np.asarray(op.gr_rowT)[:m], np.asarray(op.gr_laneT)[:m]
    sr, sl = np.asarray(op.sc_row)[:, :m], np.asarray(op.sc_laneT)[:m]
    rows = np.stack([sr.argmax(0) * ns + sl.argmax(1), gr.argmax(1) * ns + gl.argmax(1),
                     np.asarray(op.rest_vals)[:m, 0]], axis=1)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


@pytest.mark.parametrize("rest_target", [None, 128])
@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("size", [(20, 24), (28, 32)])
def test_grid_operator_matches_tpufem(size, merged, rest_target):
    jcsr, tcsr = _operators(size, merged)
    ns = size[0]
    j = jgridop.GridOperator.build(jcsr, ns, dtype=jnp.float64, rest_target=rest_target)
    t = tgridop.GridOperator.build(tcsr, ns, dtype=torch.float64, rest_target=rest_target)
    assert t.offsets == j.offsets
    np.testing.assert_array_equal(t.diags.numpy(), np.asarray(j.diags))
    assert t.n_rest == j.n_rest
    assert t.coverage == j.coverage
    got = np.stack([t.rest_tgt.numpy(), t.rest_src.numpy(), t.rest_vals.numpy()], axis=1)
    np.testing.assert_array_equal(got[np.lexsort((got[:, 1], got[:, 0]))], _remainder(j))
    rng = np.random.default_rng(ns)
    x = rng.standard_normal(ns * ns)
    np.testing.assert_allclose(t.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(j.matvec(jnp.asarray(x))), rtol=0, atol=1e-13)
    np.testing.assert_allclose(t.diag().numpy(), np.asarray(j.diag()), rtol=0, atol=1e-13)
    # the decomposition is exact: it applies the CSR operator
    np.testing.assert_allclose(t.matvec(torch.as_tensor(x)).numpy(),
                               tcsr.matvec(torch.as_tensor(x)).numpy(), rtol=0, atol=1e-13)


def test_grid_operator_f32_rounds_like_tpufem():
    jcsr, tcsr = _operators((20, 24), merged=False)
    j = jgridop.GridOperator.build(jcsr, 20, dtype=jnp.float32)
    t = tgridop.GridOperator.build(tcsr, 20, dtype=torch.float32)
    np.testing.assert_array_equal(t.diags.numpy(), np.asarray(j.diags))
    assert t.rest_vals.dtype == torch.float32


def test_decomposition_refused_by_both_off_the_grid_numbering():
    """A pad_hole=False mesh has N ≠ ns²: both packages refuse it."""
    jcsr, tcsr = _operators((20, 24), merged=False, pad_hole=False)
    ns = int(np.ceil(np.sqrt(jcsr.shape[0])))
    with pytest.raises((jgridop.GridDecompositionError, AssertionError)):
        jgridop.GridOperator.build(jcsr, ns, dtype=jnp.float64)
    with pytest.raises(tgridop.GridDecompositionError):
        tgridop.GridOperator.build(tcsr, ns, dtype=torch.float64)


def test_decomposition_refused_by_both_on_a_scrambled_numbering():
    """A square-N operator whose numbering is not grid-structured: no plane
    selection fits the remainder cap, and both packages raise."""
    jcsr, tcsr = _operators((20, 24), merged=False)
    n = jcsr.shape[0]
    perm = np.random.default_rng(0).permutation(n)
    from tpufem.ops.sparse import csr_from_coo as jcoo
    from tpufem_torch.ops.sparse import csr_from_coo as tcoo

    rows, cols = perm[np.asarray(jcsr.row_ids)], perm[np.asarray(jcsr.indices)]
    jp = jcoo(rows, cols, np.asarray(jcsr.data), (n, n))
    tp = tcoo(rows, cols, tcsr.data.numpy(), (n, n))
    kw = dict(max_offsets=4, rest_target=16)
    with pytest.raises(jgridop.GridDecompositionError):
        jgridop.GridOperator.build(jp, 20, dtype=jnp.float64, **kw)
    with pytest.raises(tgridop.GridDecompositionError):
        tgridop.GridOperator.build(tp, 20, dtype=torch.float64, **kw)


@pytest.mark.parametrize("pad_hole", [True, False])
def test_grid_numbering_ok_matches_tpufem(pad_hole):
    jm, tm = meshes(20, 24, pad_hole=pad_hole)
    assert tgridify.grid_numbering_ok(tm) == jgridify.grid_numbering_ok(jm) == pad_hole
    if not pad_hole:
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            tgridify.ensure_grid_numbering(tm)
