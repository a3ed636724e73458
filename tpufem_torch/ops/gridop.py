"""2-D grid-offset operator decomposition of a sparse operator.

The counterpart of ``tpufem.ops.gridop``.  Ring-in-grid pad_hole meshes
(``generate_annulus_mesh(pad_hole=True)``) number every node as a grid slot
(N = ns²), so each coupling row → col is a 2-D grid offset

    (dy, s):  iy, ix = divmod(row, ns);  jy, jx = divmod(col, ns)
              dy = jy − iy,   s = (jx − ix) mod ns

and the operator splits into a few dense offset planes plus a small
remainder R:

    A x = Σ_g  d_g ⊙ roll(roll(X, −dy_g, rows), −s_g, lanes)  +  R x

on the (ns, ns) grid image X of x, with both rolls cyclic (the plane is
zero wherever the neighbour does not exist; the lane wrap is the periodic-x
coupling).  The offset selection is tpufem's, argument for argument, so
offsets, planes and coverage are array-equal to it.

The remainder is a COO list sorted by target (row, lane) with CSR-style
row pointers over the target rows: the kernels (``csrc/grid_common.cuh``)
find a point's entries by a binary search for its lane in its row and sum
them in that order, with no atomics.  tpufem's one-hot remainder matrices
exist because Mosaic cannot scatter scalars; the port has no use for them.

:meth:`GridOperator.build` selects offsets as tpufem does, TPU memory caps
included; :meth:`GridOperator.dense_split` is the split the card kernels
apply, with those caps lifted.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


# tpufem streams its grid solvers from this many nodes (``stream_diags``),
# taking its plane split from its TPU budgets; below it, its split is the
# parity reference of the port's grid path
STREAMED_NODES = 360_000


class GridDecompositionError(ValueError):
    """The operator does not decompose onto dense grid offsets plus a small
    remainder (or its periodic pairs do not sit on opposite grid edges)."""


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, in x's dtype (from float64 through float32,
    as torch and XLA convert)."""
    return x.to(torch.bfloat16).to(x.dtype)


def _couplings(op, ns: int, nonzero: bool = False):
    """(rows, cols, values, offset key) of a CSR operator's stored entries
    on an ns×ns grid numbering, in CSR order (stored zeros dropped with
    ``nonzero``); the key (dy·ns + s) is unique per offset."""
    n = op.shape[0]
    if n != ns * ns:
        raise GridDecompositionError(f"{n} nodes is not a {ns}×{ns} grid")
    rows = np.asarray(op.row_ids, dtype=np.int64)
    cols = np.asarray(op.indices, dtype=np.int64)
    data = op.data.detach().cpu().to(torch.float64).numpy()
    if nonzero:
        keep = data != 0
        rows, cols, data = rows[keep], cols[keep], data[keep]
    iy, ix = np.divmod(rows, ns)
    jy, jx = np.divmod(cols, ns)
    return rows, cols, data, (jy - iy) * ns + (jx - ix) % ns


def _dense_keys(key: np.ndarray, n: int, ns: int, max_offsets: int = 24, min_fill: float = 0.02,
                rest_target: int | None = None,
                rest_budget_bytes: int | None = 16 << 20) -> list:
    """The offset keys :meth:`GridOperator.build` puts on planes (its
    selection rule and caps, documented there)."""
    uniq, counts = np.unique(key, return_counts=True)
    order = np.argsort(-counts)
    rest_cap = (float("inf") if rest_budget_bytes is None else
                min(max(4096, n // 8), max(512, int(rest_budget_bytes / (20 * ns)))))
    if rest_target is not None:
        rest_cap = min(rest_cap, int(rest_target))
        hard_max = 64
    else:
        hard_max = min(64, max(max_offsets, int(48 * 2**20 / (4 * n))))
    min_count = max(1, int(min_fill * n))
    total = len(key)
    dense_keys = []
    taken = 0
    for k in order:
        have = len(dense_keys)
        if have >= hard_max:
            break
        above = counts[k] >= min_count and have < max_offsets
        if uniq[k] == 0 or above or (total - taken) > rest_cap:
            dense_keys.append(uniq[k])
            taken += int(counts[k])
        elif (total - taken) <= rest_cap:
            break
    if 0 not in dense_keys:
        dense_keys.append(0)  # the main diagonal is always dense
    if total - taken > rest_cap:
        raise GridDecompositionError(
            f"{total - taken} couplings remain off the {len(dense_keys)} densest grid "
            f"offsets (caps: {hard_max} offsets, {rest_cap} remainder entries at "
            f"ns={ns}): the numbering is not grid-structured enough")
    return dense_keys


@dataclasses.dataclass(frozen=True)
class GridOperator:
    """A = Σ dense-offset planes (2-D cyclic rolls) + a COO remainder."""

    ns: int
    offsets: tuple  # ((dy, s), ...) python ints, s in [0, ns)
    diags: torch.Tensor  # (n_off, ns, ns): d[g, iy, ix] = A[row, row + offset g]
    rest_rowptr: torch.Tensor  # (ns+1,) int32: target row iy owns [ptr[iy], ptr[iy+1])
    rest_lane: torch.Tensor  # (m,) int32 target lane, ascending within a row
    rest_tgt: torch.Tensor  # (m,) int32 flat target index iy·ns + ix
    rest_src: torch.Tensor  # (m,) int32 flat source index jy·ns + jx
    rest_vals: torch.Tensor  # (m,)
    coverage: float  # share of the stored entries on the dense planes
    # round32 applies to the remainder (tpufem's kernels round its sources and
    # sums to float32); False for the card split from STREAMED_NODES up
    rest_round32: bool = True

    @property
    def n(self) -> int:
        return self.ns * self.ns

    @property
    def n_rest(self) -> int:
        return int(self.rest_vals.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.diags.dtype

    @property
    def device(self) -> torch.device:
        return self.diags.device

    @classmethod
    def from_parts(cls, ns: int, offsets, diags, tgt, src, vals, coverage: float,
                   dtype=None, device=None, rest_round32: bool = True) -> "GridOperator":
        """From planes and a remainder given as flat (target, source, value)
        host arrays in any order; entries are sorted stably by target."""
        tgt = np.asarray(tgt, dtype=np.int64)
        src = np.asarray(src, dtype=np.int64)
        vals = np.asarray(vals)
        order = np.argsort(tgt, kind="stable")
        tgt, src, vals = tgt[order], src[order], vals[order]
        rowptr = np.zeros(ns + 1, dtype=np.int32)
        np.add.at(rowptr, tgt // ns + 1, 1)
        rowptr = np.cumsum(rowptr).astype(np.int32)
        diags = torch.as_tensor(np.asarray(diags), dtype=dtype, device=device)
        dev = diags.device

        def it(a, dt):
            return torch.as_tensor(a, dtype=dt, device=dev)

        return cls(
            ns=int(ns),
            offsets=tuple((int(dy), int(s)) for dy, s in offsets),
            diags=diags,
            rest_rowptr=it(rowptr, torch.int32),
            rest_lane=it(tgt % ns, torch.int32),
            rest_tgt=it(tgt, torch.int32),
            rest_src=it(src, torch.int32),
            rest_vals=it(vals, diags.dtype),
            coverage=float(coverage),
            rest_round32=rest_round32,
        )

    @classmethod
    def build(cls, op, ns: int, dtype=torch.float32, max_offsets: int = 24,
              min_fill: float = 0.02, rest_target: int | None = None,
              rest_budget_bytes: int | None = 16 << 20, nonzero: bool = False,
              device=None) -> "GridOperator":
        """Decompose a CSR operator on an ns×ns grid numbering (host side).

        Offsets are taken in descending fill while above ``min_fill``·N,
        then until the remainder fits its cap, up to the plane cap; raises
        :class:`GridDecompositionError` when no selection fits.
        ``rest_target`` (tpufem passes 128 in its streamed regimes) keeps
        taking offsets, up to 64 planes, until the remainder is at most
        that.  The caps are tpufem's, including its TPU memory budgets, so
        that both packages pick the same split; ``rest_budget_bytes=None``
        lifts the remainder cap and ``nonzero=True`` drops the operator's
        stored zeros before anything is counted and applies the remainder
        in the field's precision (:meth:`dense_split`)."""
        n = op.shape[0]
        rows, cols, data, key = _couplings(op, ns, nonzero)
        iy, ix = np.divmod(rows, ns)
        dense_keys = _dense_keys(key, n, ns, max_offsets, min_fill, rest_target,
                                 rest_budget_bytes)

        offsets = []
        planes = []
        in_dense = np.zeros(len(rows), dtype=bool)
        for k in sorted(int(k) for k in dense_keys):
            sk = k % ns
            dyk = (k - sk) // ns
            sel = key == k
            d = np.zeros((ns, ns))
            d[iy[sel], ix[sel]] = data[sel]
            offsets.append((dyk, sk))
            planes.append(d)
            in_dense |= sel
        rest = ~in_dense
        return cls.from_parts(
            ns, offsets, np.stack(planes), rows[rest], cols[rest], data[rest],
            coverage=float(in_dense.mean()) if len(rows) else 1.0, dtype=dtype, device=device,
            rest_round32=not nonzero,
        )

    @classmethod
    def dense_split(cls, op, ns: int, dtype=torch.float32, device=None) -> "GridOperator":
        """The split the card kernels apply (K2–K5; K4's through the
        :class:`GridRefill` template): planes for the offsets whose fill is
        ≥ 2 % of N (at most 24) and the diagonal, everything else on the
        remainder.

        tpufem's streamed ``rest_target=128`` and its remainder cap (20 B
        an entry and row of a 16 MB VMEM budget) buy planes to shrink a
        remainder that its TPU kernels hold as one-hot matrices; on the card
        a remainder entry costs 12 bytes and a lane search, a plane 4·N
        bytes, so neither applies.

        From :data:`STREAMED_NODES` up it counts an offset's fill by its
        nonzero entries and drops the stored zeros (``build``'s ``nonzero``):
        the P1 stiffness stores a zero for each edge whose two opposite
        angles are right angles, which fills the (±1, ±1) offsets of a
        pad_hole mesh's raster, so counting entries makes four near-empty
        planes.  Below that size tpufem's split is the parity reference,
        and the split is tpufem's wherever its caps do not bind.

        At f64, where this split moves an entry from a plane onto the
        remainder below STREAMED_NODES (where tpufem's caps would have
        bought a plane for it), the entry is applied with tpufem's float32
        rounding of remainder sources and sums; from STREAMED_NODES up the
        remainder is applied in the field's precision (``rest_round32``
        False): tpufem's f64 runs CSR there, and rounding thousands of
        entries to float32 would make an f64 grid solve an f32-accurate
        one."""
        return cls.build(op, ns, dtype=dtype, rest_budget_bytes=None,
                         nonzero=op.shape[0] >= STREAMED_NODES, device=device)

    def bf16_preconditioner(self, op) -> "GridOperator":
        """K̃, the operator the preconditioner of tpufem's ``precond_bf16``
        applies (``cg_precond_bf16="on"``), on this operator's layout.

        ``op`` is the CSR operator this one splits.  Each of its entries
        that tpufem's streamed split puts on a plane (``build(...,
        rest_target=128)``, or the budgeted ``build`` where that raises,
        as tpufem's ``build_gridop``) is rounded to bfloat16 from this
        operator's dtype; every other entry keeps its value.  The rounding
        follows the entry, whichever plane or remainder this split gives
        it: the planes come back in bfloat16 and the remainder in this
        operator's dtype.  An entry that tpufem keeps at full width but
        this split puts on a plane goes to K̃'s remainder instead, so
        K̃'s ``n_rest`` exceeds this operator's by their count (none on the
        pad_hole meshes, whose card planes are among tpufem's)."""
        ns = self.ns
        rows, cols, data, key = _couplings(op, ns)
        try:
            streamed = _dense_keys(key, self.n, ns, rest_target=128)
        except GridDecompositionError:
            streamed = _dense_keys(key, self.n, ns)
        rounded = np.isin(key, streamed)
        field = torch.as_tensor(data, dtype=self.dtype)
        vals = torch.where(torch.as_tensor(rounded), _round_bf16(field), field).double().numpy()
        if not self.rest_round32:  # a split that dropped the stored zeros (build's nonzero)
            keep = data != 0
            rows, cols, vals, key, rounded = (a[keep] for a in (rows, cols, vals, key, rounded))
        iy, ix = np.divmod(rows, ns)
        planes = np.zeros((len(self.offsets), ns, ns))
        on_plane = np.zeros(len(rows), dtype=bool)
        for g, (dy, s) in enumerate(self.offsets):
            sel = (key == dy * ns + s) & rounded
            planes[g, iy[sel], ix[sel]] = vals[sel]
            on_plane |= sel
        rest = ~on_plane
        full = GridOperator.from_parts(ns, self.offsets, planes, rows[rest], cols[rest],
                                       vals[rest], self.coverage, dtype=self.dtype,
                                       device=self.device, rest_round32=self.rest_round32)
        return dataclasses.replace(full, diags=full.diags.to(torch.bfloat16))

    def astype(self, dtype) -> "GridOperator":
        return dataclasses.replace(self, diags=self.diags.to(dtype),
                                   rest_vals=self.rest_vals.to(dtype))

    def rest_apply(self, X: torch.Tensor, round32: bool = False) -> torch.Tensor:
        """R·x on (..., ns, ns) grid images, summed per target.

        ``round32``: round each source value and each target's sum to
        float32, as tpufem's whole-solve kernels do at every precision
        (their remainder products take ``preferred_element_type=float32``,
        ``pallas_cg.py:388-392``), where the operator has ``rest_round32``;
        the solvers' plain versions use it."""
        round32 = round32 and self.rest_round32
        flat = X.reshape(*X.shape[:-2], -1)
        xs = flat[..., self.rest_src]
        if round32:
            xs = xs.to(torch.float32).to(xs.dtype)
        vals = self.rest_vals * xs
        out = torch.zeros_like(flat, dtype=vals.dtype).index_add_(-1, self.rest_tgt, vals)
        if round32:
            out = out.to(torch.float32).to(out.dtype)
        return out.reshape(out.shape[:-1] + X.shape[-2:])

    def matvec_grid(self, X: torch.Tensor, round32: bool = False) -> torch.Tensor:
        """A·x on (..., ns, ns) grid images: planes in offset order, then the
        remainder (the order the kernels add them in; ``round32`` as in
        :meth:`rest_apply`)."""
        Y = None
        for g, (dy, s) in enumerate(self.offsets):
            term = self.diags[g] * torch.roll(X, shifts=(-dy, -s), dims=(-2, -1))
            Y = term if Y is None else Y + term
        if self.n_rest:
            Y = Y + self.rest_apply(X, round32)
        return Y

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec_grid(x.reshape(self.ns, self.ns)).reshape(-1)

    def diag(self) -> torch.Tensor:
        d = self.diags[self.offsets.index((0, 0))].reshape(-1)
        if self.n_rest:
            same = self.rest_src == self.rest_tgt
            d = d + torch.zeros_like(d).index_add_(
                0, self.rest_tgt[same], self.rest_vals[same])
        return d


class _PatternCSR:
    """The mesh's CSR pattern with unit values, as ``GridOperator.build``
    reads an operator (tpufem's ``ops/stencil._PatternCSR``)."""

    def __init__(self, pattern: dict, n: int):
        self.indptr = pattern["indptr"]
        self.indices = pattern["indices"]
        self.data = torch.ones(pattern["nnz"], dtype=torch.float64)
        self.shape = (n, n)

    @property
    def row_ids(self) -> np.ndarray:
        return np.repeat(np.arange(self.shape[0], dtype=np.int64),
                         np.diff(self.indptr).astype(np.int64))


@dataclasses.dataclass(frozen=True)
class GridRefill:
    """Per-step value refill of a :class:`GridOperator` with a static
    pattern: the element matrices of a state-dependent operator (the
    advection C(u), rebuilt every step) summed straight into the offset
    planes and remainder values with one ``index_add_``.

    Built on the host from the mesh's CSR pattern: each element entry's
    flat slot is ``g·N + row`` on plane g and ``n_off·N + k`` for remainder
    entry k, in the template's remainder order (sorted stably by target,
    which keeps the CSR order; :meth:`from_template` asserts it).
    :meth:`refill_flat` on CUDA runs kernel G (``ops/ns_refill.py``), which
    sums each slot's entries in entry order over :meth:`segments`: the
    order of the CPU's ``index_add_``, so the two are bit-equal and two
    refills of one state are too.  :meth:`refill`, run once at set-up,
    keeps ``index_add_`` on every device."""

    template: GridOperator  # pattern donor; its values are not used
    dest: torch.Tensor  # (E,) int64: ordered element entry → flat slot
    order: torch.Tensor  # (E,) int64: (T, 3, 3) flat index of each ordered entry
    order_k: torch.Tensor  # (E,) int64: the same entries in the k-major (9·T,) layout
    n_flat: int  # n_off·N + n_rest
    # kernel G's slot-sorted index, made at first use (:meth:`segments`)
    _segments: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                        compare=False)

    @classmethod
    def build(cls, mesh, ns: int, dtype=torch.float32, device=None) -> "GridRefill":
        """The refill on the card's split of the mesh pattern
        (:meth:`GridOperator.dense_split`), the split K4 applies.  Below
        :data:`STREAMED_NODES` it is tpufem's wherever tpufem's caps do not
        bind (the pad_hole meshes up to 160,000 nodes); at 1,048,576 nodes
        it keeps 9 planes (the diagonal, the four neighbours and the four
        (±1, ±1) offsets, which carry C(u) across the raster's diagonals)
        where tpufem's caps buy 13."""
        from tpufem_torch.ops import assembly

        pattern = assembly._csr_pattern(mesh)
        template = GridOperator.dense_split(_PatternCSR(pattern, mesh.n_nodes), ns, dtype=dtype,
                                            device=device)
        return cls.from_template(mesh, template, pattern)

    @classmethod
    def from_template(cls, mesh, template: GridOperator, pattern: dict | None = None) -> "GridRefill":
        """The refill of ``mesh``'s element entries onto the planes and
        remainder of ``template``, a split of the mesh's CSR pattern (e.g.
        tpufem's, ``GridOperator.build(_PatternCSR(pattern, n), ns)``)."""
        from tpufem_torch.ops import assembly

        if pattern is None:
            pattern = assembly._csr_pattern(mesh)
        n, ns = mesh.n_nodes, template.ns
        if n != ns * ns:
            raise GridDecompositionError(f"{n} nodes is not a {ns}×{ns} grid")
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(pattern["indptr"]).astype(np.int64))
        cols = pattern["indices"].astype(np.int64)
        iy, ix = np.divmod(rows, ns)
        jy, jx = np.divmod(cols, ns)
        key = (jy - iy) * ns + (jx - ix) % ns
        n_off = len(template.offsets)
        slot = np.empty(pattern["nnz"], dtype=np.int64)
        in_dense = np.zeros(pattern["nnz"], dtype=bool)
        for g, (dy, s) in enumerate(template.offsets):
            sel = key == dy * ns + s
            slot[sel] = g * n + rows[sel]  # plane slot (iy, ix) flattens to the row
            in_dense |= sel
        rest = np.nonzero(~in_dense)[0]
        if not (np.array_equal(template.rest_tgt.cpu().numpy(), rows[rest])
                and np.array_equal(template.rest_src.cpu().numpy(), cols[rest])):
            raise AssertionError("the template's remainder is not in CSR order")
        slot[rest] = n_off * n + np.arange(len(rest))
        order = pattern["order"].astype(np.int64)
        dev = template.device

        def it(a):
            return torch.as_tensor(a, dtype=torch.int64, device=dev)

        return cls(
            template=template,
            dest=it(slot[pattern["inverse"]]),
            order=it(order),
            order_k=it((order % 9) * mesh.n_tris + order // 9),
            n_flat=n_off * n + len(rest),
        )

    def refill(self, elem: torch.Tensor) -> GridOperator:
        """(T, 3, 3) element values → the filled operator."""
        return self._from_gathered(elem.reshape(-1)[self.order])

    def refill_flat(self, flat_k: torch.Tensor) -> GridOperator:
        """(9·T,) k-major element values (entry ``k·T + t``, the layout of
        ``assembly.element_convection_flat``) → the filled operator: kernel
        G on a CUDA tensor, :meth:`refill_flat_ref` elsewhere."""
        if flat_k.device.type == "cuda":
            from tpufem_torch.ops import ns_refill

            return self._from_flat(ns_refill.segment_sum(flat_k.contiguous(), *self.segments()))
        return self.refill_flat_ref(flat_k)

    def refill_flat_ref(self, flat_k: torch.Tensor) -> GridOperator:
        """The plain version of :meth:`refill_flat`, on any device: one
        ``index_add_`` (with atomics, in no fixed order, on CUDA)."""
        return self._from_gathered(flat_k[self.order_k])

    def segments(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(index (E,), ptr (n_flat + 1,)), int32 on ``dest``'s device: the
        k-major positions of the element entries, slot by slot and each
        slot's in entry order (``order_k`` through the stable sort of
        ``dest``), and each slot's run in it.  Made from ``dest`` and
        ``order_k`` alone at first call, and kept."""
        hit = self._segments.get("index")
        if hit is None:
            if len(self.dest) >= 2 ** 31:
                raise ValueError(f"{len(self.dest)} element entries: int32 indices take "
                                 "fewer than 2**31")
            perm = torch.sort(self.dest, stable=True).indices
            ptr = torch.zeros(self.n_flat + 1, dtype=torch.int32, device=self.dest.device)
            ptr[1:] = torch.cumsum(torch.bincount(self.dest, minlength=self.n_flat), 0)
            hit = self._segments["index"] = (self.order_k[perm].to(torch.int32), ptr)
        return hit

    def _from_gathered(self, vals: torch.Tensor) -> GridOperator:
        flat = torch.zeros(self.n_flat, dtype=vals.dtype, device=vals.device)
        flat.index_add_(0, self.dest, vals)
        return self._from_flat(flat)

    def _from_flat(self, flat: torch.Tensor) -> GridOperator:
        t = self.template
        split = len(t.offsets) * t.n
        return dataclasses.replace(t, diags=flat[:split].reshape(len(t.offsets), t.ns, t.ns),
                                   rest_vals=flat[split:])
