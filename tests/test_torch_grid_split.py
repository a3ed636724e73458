"""The card kernels' grid split (``GridOperator.dense_split``) and their
remainder lookup, on the operators K2, K3 and K5 apply.

For each operator, counting an offset's fill by its stored entries (the
rule below 360,000 nodes) and by its nonzero entries (from there up):
(a) planes only for the offsets with fill ≥ 2 % of N and the diagonal;
(b) the split applies the CSR operator; (c) the remainder's lanes ascend
within each target row and one target's entries keep their input (CSR)
order; (d) a plain twin of the kernels' lookup (binary search for the
point's lane in its row, then the run of entries with that lane, summed in
list order with tpufem's float32 rounding) equals
``rest_apply(round32=True)`` bit for bit; (e) where tpufem's TPU caps do
not bind, the default split is tpufem's ``GridOperator.build``.

The operators: the merged periodic pressure operator of pad_hole meshes
(n_side 12, 20, 40 and 160), of the renumbered (40, 48, pad_hole=False)
mesh, and the Navier–Stokes pressure operator (unsigned stiffness, no
merge) at n_side 20.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.ops import assembly as jassembly
from tpufem.ops import gridop as jgridop
from tpufem_torch.bc import ChannelBoundary
from tpufem_torch.mesh import gridify as tgridify
from tpufem_torch.ops import assembly as tassembly
from tpufem_torch.ops.gridop import GridOperator
from tpufem_torch.solve.pressure import owner_map

from tests._torch_parity import meshes
from tests.test_torch_gridop import _remainder

torch.set_num_threads(2)

MIN_FILL = 0.02  # GridOperator.build's default, which dense_split keeps
CASES = ["pad 12", "pad 20", "pad 40", "pad 160", "renumbered 40", "ns pressure 20"]
SIZES = {"pad 12": (12, 16), "pad 20": (20, 24), "pad 40": (40, 48), "pad 160": (160, 192),
         "renumbered 40": (40, 48), "ns pressure 20": (20, 24)}
TPUFEM_CASES = ["pad 12", "pad 20", "pad 40", "ns pressure 20"]


def _merged(mesh):
    b = ChannelBoundary.build(mesh)
    owner = owner_map(mesh.n_nodes, b.masters, b.slaves)
    return dataclasses.replace(mesh, tris=owner[mesh.tris].astype(np.int32))


@functools.lru_cache(maxsize=None)
def operator(case: str):
    """(port CSR, ns, tpufem mesh and signed flag or None) of ``case``."""
    size = SIZES[case]
    if case == "renumbered 40":
        _, tm = meshes(*size, pad_hole=False)
        g = tgridify.gridify_mesh(tm)
        mesh = g.mesh
        return tassembly.assemble_csr(_merged(mesh), tassembly.element_stiffness(mesh)), g.ns, None
    jm, tm = meshes(*size, pad_hole=True)
    if case.startswith("ns"):
        ke = tassembly.element_stiffness(tm, signed=False)
        return tassembly.assemble_csr(tm, ke), size[0], (jm, False)
    return tassembly.assemble_csr(_merged(tm), tassembly.element_stiffness(tm)), size[0], (jm, True)


@functools.lru_cache(maxsize=None)
def split(case: str, dtype=torch.float64, nonzero: bool = False) -> GridOperator:
    """The card split of ``case``; ``nonzero``: its rule from 360,000 nodes up
    (these meshes are smaller, so it is asked of ``build`` directly)."""
    csr, ns, _ = operator(case)
    if nonzero:
        return GridOperator.build(csr, ns, dtype=dtype, rest_budget_bytes=None, nonzero=True)
    return GridOperator.dense_split(csr, ns, dtype=dtype)


def _keys(csr, ns, nonzero: bool):
    rows = np.asarray(csr.row_ids, dtype=np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    if nonzero:
        keep = csr.data.numpy() != 0
        rows, cols = rows[keep], cols[keep]
    iy, ix = np.divmod(rows, ns)
    jy, jx = np.divmod(cols, ns)
    return rows, cols, (jy - iy) * ns + (jx - ix) % ns


@pytest.mark.parametrize("nonzero", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_split_keeps_only_filled_offsets(case, nonzero):
    """(a) the planes are the diagonal and the offsets with fill ≥ 2 % of N;
    counted by nonzero entries, the remainder keeps the field's precision."""
    csr, ns, _ = operator(case)
    op = split(case, nonzero=nonzero)
    assert op.rest_round32 == (not nonzero)
    _, _, key = _keys(csr, ns, nonzero)
    uniq, counts = np.unique(key, return_counts=True)
    filled = {int(k) for k, c in zip(uniq, counts) if c >= max(1, int(MIN_FILL * ns * ns))}
    assert len(filled) <= 24  # the plane cap never binds on these operators
    want = sorted(filled | {0})
    assert [dy * ns + s for dy, s in op.offsets] == want
    assert op.n_rest == int(np.isin(key, want, invert=True).sum())


@pytest.mark.parametrize("nonzero", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_split_applies_the_csr_operator(case, nonzero):
    """(b) planes plus remainder are the CSR operator, at f64."""
    csr, ns, _ = operator(case)
    op = split(case, nonzero=nonzero)
    x = torch.as_tensor(np.random.default_rng(ns).standard_normal(ns * ns))
    np.testing.assert_allclose(op.matvec(x).numpy(), csr.matvec(x).numpy(), rtol=0, atol=1e-13)
    np.testing.assert_allclose(op.diag().numpy(), csr.diag().numpy(), rtol=0, atol=1e-13)


@pytest.mark.parametrize("nonzero", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_remainder_is_sorted_for_the_lane_search(case, nonzero):
    """(c) lanes ascend within each target row; one target's entries keep
    the CSR order (the order the kernels sum them in)."""
    csr, ns, _ = operator(case)
    op = split(case, nonzero=nonzero)
    rows, cols, key = _keys(csr, ns, nonzero)
    rest = np.isin(key, [dy * ns + s for dy, s in op.offsets], invert=True)
    np.testing.assert_array_equal(op.rest_tgt.numpy(), rows[rest])  # CSR order is target order
    np.testing.assert_array_equal(op.rest_src.numpy(), cols[rest])
    ptr, lane = op.rest_rowptr.numpy(), op.rest_lane.numpy()
    for iy in range(ns):
        assert (np.diff(lane[ptr[iy]:ptr[iy + 1]]) >= 0).all(), f"row {iy}"
    np.testing.assert_array_equal(op.rest_tgt.numpy() // ns,
                                  np.repeat(np.arange(ns), np.diff(ptr)))


def lane_search_rest(op: GridOperator, X: torch.Tensor) -> torch.Tensor:
    """The kernels' remainder lookup (``apply_yx`` in csrc/grid_common.cuh),
    for every point at once: in the point's target row, a binary search for
    the first entry whose lane is not below the point's, then the entries
    with its lane in list order, each source and the sum rounded to float32
    where the operator has ``rest_round32``; a point of a row with entries
    gets the sum (0 without a match)."""
    ns = op.ns
    ptr = op.rest_rowptr.to(torch.int64)
    lane = op.rest_lane.to(torch.int64)
    iy, ix = torch.meshgrid(torch.arange(ns), torch.arange(ns), indexing="ij")
    k0, k1 = ptr[iy], ptr[iy + 1]
    lo, hi = k0.clone(), k1.clone()
    lane_at = torch.cat([lane, lane.new_full((1,), -1)])  # index m: past the end
    while bool((lo < hi).any()):
        live = lo < hi
        mid = torch.where(live, (lo + hi) // 2, lo)
        below = lane_at[mid] < ix
        lo = torch.where(live & below, mid + 1, lo)
        hi = torch.where(live & ~below, mid, hi)

    def round32(v):
        return v.to(torch.float32).to(v.dtype) if op.rest_round32 else v

    m = len(op.rest_vals)
    flat = X.reshape(-1)
    rest = torch.zeros_like(X)
    src = torch.cat([op.rest_src.to(torch.int64), op.rest_src.new_zeros(1).to(torch.int64)])
    vals = torch.cat([op.rest_vals, op.rest_vals.new_zeros(1)])
    k, run = lo, lo < k1
    while True:
        run = run & (k < k1) & (lane_at[torch.clamp(k, max=m)] == ix)
        if not bool(run.any()):
            break
        kk = torch.where(run, k, m)
        rest = torch.where(run, rest + vals[kk] * round32(flat[src[kk]]), rest)
        k = torch.where(run, k + 1, k)
    return torch.where(k0 < k1, round32(rest), torch.zeros_like(rest))


@pytest.mark.parametrize("nonzero", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", CASES)
def test_lane_search_equals_the_scatter_bit_for_bit(case, dtype, nonzero):
    """(d) the twin of the kernels' lookup against ``rest_apply(round32)``."""
    op = split(case, dtype, nonzero)
    assert op.n_rest > 0
    ns = op.ns
    X = torch.as_tensor(np.random.default_rng(ns + 1).standard_normal((ns, ns)), dtype=dtype)
    got = lane_search_rest(op, X)
    want = op.rest_apply(X, round32=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", TPUFEM_CASES)
def test_split_is_tpufems_where_its_caps_do_not_bind(case):
    """(e) array-equal to tpufem's ``GridOperator.build`` at n_side 12, 20, 40."""
    csr, ns, (jm, merged) = operator(case)
    ke = jassembly.element_stiffness(jm, signed=False)
    if merged:
        b = ChannelBoundary.build(meshes(*SIZES[case], pad_hole=True)[1])
        owner = owner_map(jm.n_nodes, b.masters, b.slaves)
        jm = dataclasses.replace(jm, tris=owner[jm.tris].astype(np.int32))
    j = jgridop.GridOperator.build(jassembly.assemble_csr(jm, ke), ns, dtype=jnp.float64)
    t = split(case)
    assert t.offsets == j.offsets
    np.testing.assert_array_equal(t.diags.numpy(), np.asarray(j.diags))
    assert t.n_rest == j.n_rest
    assert t.coverage == j.coverage
    got = np.stack([t.rest_tgt.numpy(), t.rest_src.numpy(), t.rest_vals.numpy()], axis=1)
    np.testing.assert_array_equal(got[np.lexsort((got[:, 1], got[:, 0]))], _remainder(j))
