"""Dense solvers factored once on the host, applied on the device.

All system matrices are constant across a run, so they are factored once at
set-up in float64 (LAPACK), and each step only applies the factors:

* :class:`DenseInverse`: host ``np.linalg.inv``; ``solve`` is one matvec.
* :class:`DenseLU`: host ``scipy.linalg.lu_factor``; ``solve`` runs
  ``torch.linalg.lu_solve`` on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.linalg as sla
import torch


@dataclasses.dataclass(frozen=True)
class DenseLU:
    """Host-factored LU.  ``piv`` holds LAPACK's 1-based int32 pivots, the
    form ``torch.linalg.lu_solve`` wants (SciPy returns them 0-based)."""

    lu: torch.Tensor
    piv: torch.Tensor

    @classmethod
    def from_scipy(cls, lu: np.ndarray, piv: np.ndarray, dtype=torch.float64, device=None) -> "DenseLU":
        """Wrap SciPy's ``lu_factor`` output (0-based pivots)."""
        return cls(
            lu=torch.as_tensor(np.asarray(lu), dtype=dtype, device=device),
            piv=torch.as_tensor(np.asarray(piv) + 1, dtype=torch.int32, device=device),
        )

    @classmethod
    def factor(cls, A, dtype=torch.float64, device=None) -> "DenseLU":
        lu, piv = sla.lu_factor(np.asarray(A, dtype=np.float64))
        return cls.from_scipy(lu, piv, dtype=dtype, device=device)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        if b.ndim == 1:
            return torch.linalg.lu_solve(self.lu, self.piv, b[:, None])[:, 0]
        return torch.linalg.lu_solve(self.lu, self.piv, b)


@dataclasses.dataclass(frozen=True)
class DenseInverse:
    """Host-computed explicit inverse; ``solve`` is one matvec."""

    inv: torch.Tensor

    @classmethod
    def factor(cls, A, dtype=torch.float64, device=None) -> "DenseInverse":
        inv = np.linalg.inv(np.asarray(A, dtype=np.float64))
        return cls(inv=torch.as_tensor(inv, dtype=dtype, device=device))

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return self.inv @ b


def make_dense_solver(A, method: str = "lu", dtype=torch.float64, device=None):
    """Factor A once; returns an object with ``.solve(b)``.

    ``lu``: the exact (reference-parity) path; ``inverse``: one matvec."""
    if method == "lu":
        return DenseLU.factor(A, dtype=dtype, device=device)
    if method == "inverse":
        return DenseInverse.factor(A, dtype=dtype, device=device)
    raise ValueError(f"unknown dense solver method: {method}")
