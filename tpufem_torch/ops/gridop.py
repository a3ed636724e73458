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
row pointers over the target rows: the kernels (``csrc/grid_cg.cu``) sum
each target's entries in that order, with no atomics.  tpufem's one-hot
remainder matrices exist because Mosaic cannot scatter scalars; the port
has no use for them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


class GridDecompositionError(ValueError):
    """The operator does not decompose onto dense grid offsets plus a small
    remainder (or its periodic pairs do not sit on opposite grid edges)."""


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
                   dtype=None, device=None) -> "GridOperator":
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
        )

    @classmethod
    def build(cls, op, ns: int, dtype=torch.float32, max_offsets: int = 24,
              min_fill: float = 0.02, rest_target: int | None = None,
              rest_budget_bytes: int = 16 << 20, device=None) -> "GridOperator":
        """Decompose a CSR operator on an ns×ns grid numbering (host side).

        Offsets are taken in descending fill while above ``min_fill``·N,
        then until the remainder fits its cap, up to the plane cap; raises
        :class:`GridDecompositionError` when no selection fits.
        ``rest_target`` (tpufem passes 128 in its streamed regimes) keeps
        taking offsets, up to 64 planes, until the remainder is at most
        that.  The caps are tpufem's, including its TPU memory budgets, so
        that both packages pick the same split."""
        n = op.shape[0]
        if n != ns * ns:
            raise GridDecompositionError(f"{n} nodes is not a {ns}×{ns} grid")
        rows = np.asarray(op.row_ids, dtype=np.int64)
        cols = np.asarray(op.indices, dtype=np.int64)
        data = op.data.detach().cpu().to(torch.float64).numpy()
        iy, ix = np.divmod(rows, ns)
        jy, jx = np.divmod(cols, ns)
        key = (jy - iy) * ns + (jx - ix) % ns  # unique per (dy, s)
        uniq, counts = np.unique(key, return_counts=True)
        order = np.argsort(-counts)
        rest_cap = min(max(4096, n // 8), max(512, int(rest_budget_bytes / (20 * ns))))
        if rest_target is not None:
            rest_cap = min(rest_cap, int(rest_target))
            hard_max = 64
        else:
            hard_max = min(64, max(max_offsets, int(48 * 2**20 / (4 * n))))
        min_count = max(1, int(min_fill * n))
        total = len(rows)
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
        )

    def astype(self, dtype) -> "GridOperator":
        return dataclasses.replace(self, diags=self.diags.to(dtype),
                                   rest_vals=self.rest_vals.to(dtype))

    def rest_apply(self, X: torch.Tensor, round32: bool = False) -> torch.Tensor:
        """R·x on (..., ns, ns) grid images, summed per target.

        ``round32``: round each source value and each target's sum to
        float32, as tpufem's whole-solve kernels do at every precision
        (their remainder products take ``preferred_element_type=float32``,
        ``pallas_cg.py:388-392``); the solvers' plain versions use it."""
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
