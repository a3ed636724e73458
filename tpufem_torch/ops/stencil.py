"""Stencil-offset sparse operators: A = Σ_k diag(d_k)·Shift(o_k) + R.

The counterpart of ``tpufem.ops.stencil``.  The ``s`` most frequent
column − row offsets of the operator become dense diagonals (``diags[k, r]
= A[r, r + offsets[k]]``); the few entries off them form a COO remainder R,
sorted by row.  On grid-numbered pad_hole meshes
(``generate_annulus_mesh(pad_hole=True)``) the nine grid-stencil offsets
carry nearly every entry; on any numbering the split is exact, with a longer
remainder (``coverage`` reports it).  The decomposition runs on the host in
float64, so offsets and remainder are array-equal to tpufem's.

tpufem's apply is a loop over the offsets that XLA fuses into one pass; an
eager loop would launch two kernels an offset.  :func:`shift_sum` instead
reads every shifted window of one zero-padded vector through a single
strided view (no copy) where the offsets form a lattice (``L`` consecutive
offsets in ``R`` equally spaced runs, as the nine grid offsets do), else
stacks the windows once, then multiplies and sums in one pass each.  The
remainder is one gather, one product and one ``index_add_`` (atomics on
CUDA, so that sum's order varies from run to run there).

:class:`StencilRefill` fills the template's diagonals and remainder with
the element matrices of a state-dependent operator (the convection C(u) of
Navier–Stokes) in one ``index_add_`` a step.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tpufem_torch import config as tconfig
from tpufem_torch.ops.gridop import _PatternCSR


def _host(a) -> np.ndarray:
    """``a`` as a host array (a copy unless a tensor's)."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.array(a)


@functools.lru_cache(maxsize=None)
def _lattice(offsets: tuple):
    """(base, runs, spacing, run) when the sorted ``offsets`` are
    base + spacing·i + j for i < runs, j < run; else None."""
    run = 1
    while run < len(offsets) and offsets[run] == offsets[0] + run:
        run += 1
    if len(offsets) % run:
        return None
    starts = offsets[::run]
    spacing = starts[1] - starts[0] if len(starts) > 1 else 0
    want = [starts[0] + spacing * i + j for i in range(len(starts)) for j in range(run)]
    if list(offsets) != want:
        return None
    return starts[0], len(starts), spacing, run


def windows(xp: torch.Tensor, start: int, n: int, counts: tuple, steps: tuple) -> torch.Tensor:
    """The view (*counts, n, ...) of contiguous ``xp`` whose entry [i, j, …, r]
    is xp[start + steps·(i, j, …) + r]: shifted windows without a copy."""
    st = xp.stride(0)
    shape = tuple(counts) + (n,) + tuple(xp.shape[1:])
    strides = tuple(s * st for s in steps) + (st,) + tuple(xp.stride()[1:])
    return xp.as_strided(shape, strides, xp.storage_offset() + start * st)


@functools.lru_cache(maxsize=64)
def _zeros(shape: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A zero block, made once (read only: the padding's ``torch.cat``)."""
    return torch.zeros(shape, dtype=dtype, device=device)


def pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``x`` with ``pad`` zero rows above and below (dimension 0), in one
    copy (``torch.nn.functional.pad`` fills and then copies)."""
    z = _zeros((pad,) + tuple(x.shape[1:]), x.dtype, x.device)
    return torch.cat((z, x, z))


def shift_sum(diags: torch.Tensor, xp: torch.Tensor, offsets: tuple, pad: int,
              n: int) -> torch.Tensor:
    """Σ_k diags[k] ⊙ xp[pad + o_k : pad + o_k + n] for ``diags`` (s, n, ...)
    and padded ``xp`` (n + 2·pad, ...), their trailing dimensions
    broadcast, in three launches (lattice) or four."""
    tail = tuple(diags.shape[2:]) + (1,) * max(0, xp.ndim - 1 - (diags.ndim - 2))
    lat = _lattice(offsets)
    if lat is not None:
        base, runs, spacing, run = lat
        view = windows(xp, pad + base, n, (runs, run), (spacing, 1))
        return (diags.reshape((runs, run, n) + tail) * view).sum((0, 1))
    view = torch.stack([xp[pad + o:pad + o + n] for o in offsets])
    return (diags.reshape((len(offsets), n) + tail) * view).sum(0)


@dataclasses.dataclass(frozen=True)
class StencilOperator:
    offsets: tuple  # (s,) python ints (column − row), ascending
    diags: torch.Tensor  # (s, N): diags[k, r] = A[r, r + offsets[k]]
    rest_rows: np.ndarray  # (m,) int32 host, ascending
    rest_cols: np.ndarray  # (m,) int32 host
    rest_rows_t: torch.Tensor  # (m,) int64 on the operator's device
    rest_cols_t: torch.Tensor  # (m,) int64
    rest_data: torch.Tensor  # (m,)
    coverage: float  # share of the stored entries on the stencil offsets

    @property
    def n(self) -> int:
        return self.diags.shape[1]

    @property
    def n_rest(self) -> int:
        return len(self.rest_rows)

    @functools.cached_property
    def pad(self) -> int:
        return max(max(abs(o) for o in self.offsets), 1)

    @classmethod
    def build(cls, op, dtype=torch.float32, max_offsets: int = 16, offsets=None,
              min_fill: float = 0.05, device=None) -> "StencilOperator":
        """Decompose a CSR operator (host side, O(nnz), tpufem's rule): the
        ``max_offsets`` most frequent offsets, less those holding fewer than
        ``min_fill·N`` entries (the diagonal always kept); explicit
        ``offsets`` bypass the trimming."""
        n = op.shape[0]
        rows = np.asarray(op.row_ids, dtype=np.int64)
        cols = np.asarray(op.indices, dtype=np.int64)
        data = _host(op.data).astype(np.float64)
        off = cols - rows
        if offsets is None:
            vals, counts = np.unique(off, return_counts=True)
            order = np.argsort(-counts)
            keep = order[:max_offsets]
            keep = [k for k in keep if counts[k] >= min_fill * n or vals[k] == 0]
            chosen = list(vals[keep])
            if 0 not in chosen:
                chosen.append(0)
            offsets = sorted(int(o) for o in chosen)
        else:
            offsets = sorted(int(o) for o in offsets)
            if 0 not in offsets:
                raise ValueError("offset 0 (the diagonal) is required")
        offsets = tuple(offsets)

        diags = np.zeros((len(offsets), n))
        in_stencil = np.zeros(len(off), dtype=bool)
        for k, o in enumerate(offsets):
            sel = off == o
            diags[k, rows[sel]] = data[sel]  # one entry a (row, col) in a CSR pattern
            in_stencil |= sel
        rest = ~in_stencil
        r_rows = rows[rest].astype(np.int32)
        r_cols = cols[rest].astype(np.int32)
        r_data = data[rest]
        o = np.argsort(r_rows, kind="stable")
        return cls.from_parts(offsets, diags, r_rows[o], r_cols[o], r_data[o],
                              coverage=float(in_stencil.mean()) if len(off) else 1.0,
                              dtype=dtype, device=device)

    @classmethod
    def from_parts(cls, offsets, diags, rest_rows, rest_cols, rest_data, coverage: float,
                   dtype=None, device=None) -> "StencilOperator":
        """From host (or tensor) diagonals and a row-sorted remainder."""
        dev = tconfig.device(device)
        diags = torch.as_tensor(_host(diags), dtype=dtype, device=dev)
        rows = _host(rest_rows).astype(np.int32)
        cols = _host(rest_cols).astype(np.int32)
        return cls(
            offsets=tuple(int(o) for o in offsets),
            diags=diags,
            rest_rows=rows,
            rest_cols=cols,
            rest_rows_t=torch.as_tensor(rows, dtype=torch.int64, device=dev),
            rest_cols_t=torch.as_tensor(cols, dtype=torch.int64, device=dev),
            rest_data=torch.as_tensor(_host(rest_data), dtype=diags.dtype, device=dev),
            coverage=float(coverage),
        )

    def astype(self, dtype, device=None) -> "StencilOperator":
        """Value-dtype cast (pattern unchanged), optionally onto ``device``,
        as ``CSROperator.astype``."""
        dev = device or self.diags.device
        return dataclasses.replace(
            self, diags=self.diags.to(dtype=dtype, device=dev),
            rest_data=self.rest_data.to(dtype=dtype, device=dev),
            rest_rows_t=self.rest_rows_t.to(dev), rest_cols_t=self.rest_cols_t.to(dev))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A x for x (N,) or (N, k), each column as its 1-D apply (tpufem
        vmaps over columns); the result takes the promoted dtype."""
        pad = self.pad
        y = shift_sum(self.diags, pad_rows(x, pad), self.offsets, pad, self.n)
        if self.n_rest:
            data = self.rest_data if x.ndim == 1 else self.rest_data[:, None]
            y.index_add_(0, self.rest_rows_t, data * x[self.rest_cols_t])
        return y

    def diag(self) -> torch.Tensor:
        d = self.diags[self.offsets.index(0)]
        same = np.nonzero(self.rest_rows == self.rest_cols)[0]  # normally none
        if len(same):
            idx = torch.as_tensor(same, device=d.device)
            d = d.index_add(0, self.rest_rows_t[idx], self.rest_data[idx])
        return d


# tpufem's rule, wherever it picks a storage: the stencil when its offsets
# carry this share of the stored entries
COVERAGE = 0.9


def stencil_or_csr(csr, dtype, device=None):
    """``csr`` on the stencil where that covers :data:`COVERAGE` of its
    entries, else ``csr`` itself in ``dtype`` on ``device``."""
    st = StencilOperator.build(csr, dtype=dtype, device=device)
    return st if st.coverage >= COVERAGE else csr.astype(dtype, st.diags.device)


@dataclasses.dataclass(frozen=True)
class StencilPair:
    """Two stencil operators A and B of one pattern (the divergence
    operators Dx and Dy) applied in one pass: ``combine(u)`` = A u₀ + B u₁
    (div) and ``split(p)`` = [A p, B p] (grad).  Their diagonals and
    remainder values are interleaved, so one shifted-window product and one
    remainder ``index_add_`` serve both: half the launches of two applies
    and an add or a stack."""

    offsets: tuple
    diags: torch.Tensor  # (s, N, 2): A's and B's diagonals
    rest_rows_t: torch.Tensor  # (m,) int64
    rest_cols_t: torch.Tensor  # (m,) int64
    rest_data: torch.Tensor  # (m, 2)

    @classmethod
    def of(cls, a, b) -> "StencilPair | None":
        """The pair of ``a`` and ``b``, or None unless both are stencil
        operators with one offset set and remainder pattern."""
        if not (isinstance(a, StencilOperator) and isinstance(b, StencilOperator)
                and a.offsets == b.offsets and np.array_equal(a.rest_rows, b.rest_rows)
                and np.array_equal(a.rest_cols, b.rest_cols)
                and a.diags.dtype == b.diags.dtype and a.diags.device == b.diags.device):
            return None
        return cls(offsets=a.offsets, diags=torch.stack([a.diags, b.diags], dim=-1),
                   rest_rows_t=a.rest_rows_t, rest_cols_t=a.rest_cols_t,
                   rest_data=torch.stack([a.rest_data, b.rest_data], dim=-1))

    @functools.cached_property
    def pad(self) -> int:
        return max(max(abs(o) for o in self.offsets), 1)

    def combine(self, u: torch.Tensor) -> torch.Tensor:
        """A u[:, 0] + B u[:, 1] for u (N, 2)."""
        n, pad = u.shape[0], self.pad
        y = shift_sum(self.diags, pad_rows(u, pad), self.offsets, pad, n).sum(-1)
        if len(self.rest_rows_t):
            y.index_add_(0, self.rest_rows_t, (self.rest_data * u[self.rest_cols_t]).sum(-1))
        return y

    def split(self, p: torch.Tensor) -> torch.Tensor:
        """[A p, B p] as (N, 2) for p (N,)."""
        n, pad = p.shape[0], self.pad
        y = shift_sum(self.diags, pad_rows(p, pad)[:, None], self.offsets, pad, n)
        if len(self.rest_rows_t):
            y.index_add_(0, self.rest_rows_t, self.rest_data * p[self.rest_cols_t][:, None])
        return y


@dataclasses.dataclass(frozen=True)
class StencilRefill:
    """Per-step value refill of a stencil operator with a static pattern.

    The element matrices (T, 3, 3) of a state-dependent operator (C(u),
    rebuilt every step) are summed into the template's diagonals and
    remainder once a step by one ``index_add_`` into ``n_flat`` slots:
    ``k·N + row`` on diagonal k, ``s·N + j`` for remainder entry j (the
    template's row-sorted order, so the refilled operator is the template's
    with new values).  On CUDA the sum takes atomics, so two refills of one
    state are not bit-equal there."""

    template: StencilOperator  # pattern donor; its values are not used
    dest: torch.Tensor  # (E,) int64: ordered element entry → flat slot
    order: torch.Tensor  # (E,) int64: (T, 3, 3) flat index of each ordered entry
    order_k: torch.Tensor  # (E,) int64: the same entries in the k-major (9·T,) layout
    n_flat: int  # s·N + m

    @classmethod
    def build(cls, mesh, dtype=torch.float32, max_offsets: int = 16, offsets=None,
              device=None) -> "StencilRefill":
        from tpufem_torch.ops import assembly

        dev = tconfig.device(device)
        pattern = assembly._csr_pattern(mesh)
        n = mesh.n_nodes
        # unit values on the adjacency pattern fix the offsets and remainder
        template = StencilOperator.build(_PatternCSR(pattern, n), dtype=dtype,
                                         max_offsets=max_offsets, offsets=offsets, device=dev)
        rows = np.repeat(np.arange(n, dtype=np.int64),
                         np.diff(pattern["indptr"]).astype(np.int64))
        cols = pattern["indices"].astype(np.int64)
        off = cols - rows
        s = len(template.offsets)
        slot = np.empty(pattern["nnz"], dtype=np.int64)
        in_stencil = np.zeros(pattern["nnz"], dtype=bool)
        for k, o in enumerate(template.offsets):
            sel = off == o
            slot[sel] = k * n + rows[sel]
            in_stencil |= sel
        rest = np.nonzero(~in_stencil)[0]
        # the remainder in StencilOperator.build's order: stable by row (CSR
        # slots are row-major already)
        slot[rest[np.argsort(rows[rest], kind="stable")]] = s * n + np.arange(len(rest))
        order = pattern["order"].astype(np.int64)

        def it(a):
            return torch.as_tensor(a, dtype=torch.int64, device=dev)

        return cls(template=template, dest=it(slot[pattern["inverse"]]), order=it(order),
                   order_k=it((order % 9) * mesh.n_tris + order // 9),
                   n_flat=s * n + len(rest))

    def refill(self, elem: torch.Tensor) -> StencilOperator:
        """(T, 3, 3) element values → the filled operator."""
        return self._from_gathered(elem.reshape(-1)[self.order])

    def refill_flat(self, flat_k: torch.Tensor) -> StencilOperator:
        """(9·T,) k-major element values (entry ``k·T + t``, the layout of
        ``assembly.element_convection_flat``) → the filled operator."""
        return self._from_gathered(flat_k[self.order_k])

    def _from_gathered(self, vals: torch.Tensor) -> StencilOperator:
        flat = torch.zeros(self.n_flat, dtype=vals.dtype, device=vals.device)
        flat.index_add_(0, self.dest, vals)
        s, n = self.template.diags.shape
        return dataclasses.replace(self.template, diags=flat[:s * n].reshape(s, n),
                                   rest_data=flat[s * n:])
