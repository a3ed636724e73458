"""Static-pattern CSR operators and their gather/scatter matvec.

The PyTorch counterpart of ``tpufem.ops.sparse``.  The pattern
(``indptr``, ``indices``) is host NumPy, computed once; ``data`` is a
tensor in the run's dtype on the run's device.  ``matvec`` gathers
``data * x[indices]`` and sums each row with ``index_add_``: on the CPU
that sums in CSR order, on CUDA with atomics, so a CUDA result is not
bit-reproducible from run to run (the order of the atomic adds varies).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSROperator:
    """Compressed-sparse-row matrix with a static pattern."""

    indptr: np.ndarray  # (N+1,) int32
    indices: np.ndarray  # (nnz,) int32
    data: torch.Tensor  # (nnz,)
    shape: tuple[int, int]

    @property
    def row_ids(self) -> np.ndarray:
        return np.repeat(np.arange(self.shape[0], dtype=np.int32), np.diff(self.indptr))

    @functools.cached_property
    def _index_tensors(self) -> tuple[torch.Tensor, torch.Tensor]:
        dev = self.data.device
        return (torch.as_tensor(self.row_ids, dtype=torch.int64, device=dev),
                torch.as_tensor(self.indices, dtype=torch.int64, device=dev))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return csr_matvec(self, x)

    def with_data(self, data: torch.Tensor) -> "CSROperator":
        return dataclasses.replace(self, data=data)

    def astype(self, dtype, device=None) -> "CSROperator":
        """Value-dtype cast (pattern unchanged), optionally onto ``device``."""
        return self.with_data(self.data.to(dtype=dtype, device=device or self.data.device))

    def diag(self) -> torch.Tensor:
        rows, cols = self._index_tensors
        vals = torch.where(rows == cols, self.data, torch.zeros_like(self.data))
        out = torch.zeros(self.shape[0], dtype=self.data.dtype, device=self.data.device)
        return out.index_add_(0, rows, vals)


def csr_matvec(op: CSROperator, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x via gather + row sum; the result takes the promoted dtype
    of ``op.data`` and ``x`` (as ``jnp`` promotes)."""
    rows, cols = op._index_tensors
    gathered = op.data * x[cols]
    out = torch.zeros(op.shape[0], dtype=gathered.dtype, device=gathered.device)
    return out.index_add_(0, rows, gathered)


def self_rows(op: CSROperator) -> np.ndarray:
    """The operator's row id of each stored entry (host NumPy)."""
    return op.row_ids


def csr_from_coo(rows, cols, data, shape, sum_duplicates: bool = False,
                 dtype=torch.float64, device=None) -> CSROperator:
    """CSR from host COO triplets.  Default assumes unique (row, col)
    pairs; ``sum_duplicates=True`` coalesces repeated pairs by summation."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    data = np.asarray(data)
    if sum_duplicates:
        keys = rows * int(shape[1]) + cols
        uniq, inv = np.unique(keys, return_inverse=True)
        summed = np.zeros(len(uniq), dtype=np.float64)
        np.add.at(summed, inv, data.astype(np.float64))
        rows = uniq // int(shape[1])
        cols = uniq % int(shape[1])
        data = summed
    order = np.lexsort((cols, rows))
    indptr = np.zeros(shape[0] + 1, dtype=np.int32)
    np.add.at(indptr, rows[order] + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return CSROperator(
        indptr=indptr,
        indices=cols[order].astype(np.int32),
        data=torch.as_tensor(data[order], dtype=dtype, device=device),
        shape=tuple(shape),
    )
