"""Banded sparse operators in reverse Cuthill–McKee order.

The counterpart of ``tpufem.ops.banded``.  RCM renumbering brings a P1
mesh operator to bandwidth b ~ O(√N); it is stored as its (2b + 1)
diagonals in the permuted order, ``diags[b + o, r] = A_p[r, r + o]``.  The
permutation stays inside the operator: ``matvec`` permutes in, applies the
band and permutes out.

The band apply reads the (2b + 1) shifted windows of one zero-padded vector
through a strided view (:func:`band_sum`, no copy) and multiplies and sums
them a chunk of diagonals at a time, so the temporary stays at ``chunk·N``
values and the apply takes three launches a chunk instead of two a
diagonal.  The whole envelope is read every apply: at 160,000 nodes RCM
gives b ≈ 2·n_side, 1,575 diagonals.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufem_torch import config as tconfig
from tpufem_torch.ops.stencil import _host, pad_rows, windows

# the band's temporary, in values: a chunk of diagonals times the rows
CHUNK_VALUES = 1 << 24


def band_sum(diags: torch.Tensor, xp: torch.Tensor, n: int) -> torch.Tensor:
    """Σ_j diags[j] ⊙ xp[j : j + n] for (nb, n) ``diags`` and contiguous
    ``xp`` of shape (n + nb − 1, ...)."""
    nb = diags.shape[0]
    extra = (1,) * (xp.ndim - 1)
    k = int(np.prod(xp.shape[1:], dtype=np.int64))
    chunk = max(1, min(nb, CHUNK_VALUES // max(n * k, 1)))
    y = None
    for c0 in range(0, nb, chunk):
        c1 = min(nb, c0 + chunk)
        part = (diags[c0:c1].reshape((c1 - c0, n) + extra)
                * windows(xp, c0, n, (c1 - c0,), (1,))).sum(0)
        y = part if y is None else y + part
    return y


@dataclasses.dataclass(frozen=True)
class BandedOperator:
    diags: torch.Tensor  # (2b+1, N) band diagonals, permuted order
    perm: np.ndarray  # global → banded order (host)
    inv_perm: np.ndarray
    bandwidth: int
    perm_t: torch.Tensor  # perm and inv_perm as int64 on the operator's device
    inv_perm_t: torch.Tensor

    @property
    def n(self) -> int:
        return self.diags.shape[1]

    @classmethod
    def build(cls, op, dtype=torch.float32, device=None) -> "BandedOperator":
        """RCM-renumber a CSR operator (SciPy, host float64) and store its
        band."""
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        n = op.shape[0]
        A = sp.csr_matrix((_host(op.data).astype(np.float64), np.asarray(op.indices),
                           np.asarray(op.indptr)), shape=(n, n))
        perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
        Ap = A[perm][:, perm].tocoo()
        bw = int(np.abs(Ap.row - Ap.col).max()) if Ap.nnz else 0
        diags = np.zeros((2 * bw + 1, n))
        diags[(Ap.col - Ap.row) + bw, Ap.row] = Ap.data
        inv_perm = np.empty(n, dtype=np.int64)
        inv_perm[perm] = np.arange(n)
        return cls.from_parts(diags, perm, inv_perm, bw, dtype=dtype, device=device)

    @classmethod
    def from_parts(cls, diags, perm, inv_perm, bandwidth: int, dtype=None,
                   device=None) -> "BandedOperator":
        dev = tconfig.device(device)
        perm = np.asarray(perm, dtype=np.int64)
        inv_perm = np.asarray(inv_perm, dtype=np.int64)
        return cls(diags=torch.as_tensor(_host(diags), dtype=dtype, device=dev), perm=perm,
                   inv_perm=inv_perm, bandwidth=int(bandwidth),
                   perm_t=torch.as_tensor(perm, device=dev),
                   inv_perm_t=torch.as_tensor(inv_perm, device=dev))

    def astype(self, dtype, device=None) -> "BandedOperator":
        dev = device or self.diags.device
        return dataclasses.replace(self, diags=self.diags.to(dtype=dtype, device=dev),
                                   perm_t=self.perm_t.to(dev), inv_perm_t=self.inv_perm_t.to(dev))

    def matvec_permuted(self, xp: torch.Tensor) -> torch.Tensor:
        """y = A x in the banded (permuted) order."""
        return band_sum(self.diags, pad_rows(xp, self.bandwidth), self.n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x in global node order, x (N,) or (N, k)."""
        return self.matvec_permuted(x[self.perm_t])[self.inv_perm_t]

    def diag(self) -> torch.Tensor:
        """The main diagonal in global order."""
        return self.diags[self.bandwidth][self.inv_perm_t]
