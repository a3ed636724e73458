"""Two-level (aggregation) preconditioner for the pressure CG, plain PyTorch.

The counterpart of ``tpufem.solve.twolevel``.  Construction is host NumPy
float64, once per problem:

* geometric grid aggregation of the nodes (piecewise-constant prolongation:
  node i belongs to aggregate ``agg[i]``);
* the Galerkin coarse operator A_c = Pᵀ K P, straight from the fine COO
  entries, with its constant nullspace regularized by a rank-one shift;
* the damped-Jacobi weight ω = 1/λ̂max(D⁻¹K) by power iteration.

Per application:

    z₁ = ω D⁻¹ r;   z₂ = z₁ + P A_c⁻¹ Pᵀ (r − K z₁);   z = z₂ + ω D⁻¹ (r − K z₂)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TwoLevel:
    """Device-side pieces of the two-level preconditioner."""

    agg_sorted: torch.Tensor  # (N,) int64 aggregate id, sorted ascending
    order: torch.Tensor  # (N,) int64 node permutation making agg sorted
    agg: torch.Tensor  # (N,) int64 aggregate id in node order
    ac_inv: torch.Tensor  # (Nc, Nc) regularized coarse inverse
    omega: float  # damped-Jacobi weight = 1/λ̂max(D⁻¹K)

    @property
    def n_coarse(self) -> int:
        return self.ac_inv.shape[0]


def build_aggregates(coords: np.ndarray, target_coarse: int = 2048):
    """Geometric grid aggregation: (agg ids (N,), n_coarse).  Empty cells
    are compressed away, so the count lands near ``target_coarse``."""
    n = coords.shape[0]
    nc_goal = int(min(target_coarse, max(1, n // 4)))
    g = max(1, int(round(np.sqrt(nc_goal / 0.8))))  # ~80 % cell occupancy

    def norm(v):
        lo, hi = float(v.min()), float(v.max())
        return np.clip((v - lo) / max(hi - lo, 1e-30), 0.0, 1.0 - 1e-12)

    ix = np.minimum((norm(coords[:, 0]) * g).astype(np.int64), g - 1)
    iy = np.minimum((norm(coords[:, 1]) * g).astype(np.int64), g - 1)
    uniq, agg = np.unique(ix * g + iy, return_inverse=True)
    return agg.astype(np.int32), len(uniq)


def galerkin_coarse(csr_op, agg: np.ndarray, n_coarse: int) -> np.ndarray:
    """A_c = Pᵀ A P for piecewise-constant P, straight from COO entries."""
    rows = np.asarray(csr_op.row_ids, dtype=np.int64)
    cols = np.asarray(csr_op.indices, dtype=np.int64)
    data = csr_op.data.detach().cpu().to(torch.float64).numpy()
    ac = np.zeros((n_coarse, n_coarse))
    np.add.at(ac, (agg[rows], agg[cols]), data)
    return ac


def coarse_inverse(ac: np.ndarray) -> np.ndarray:
    """Regularized inverse of the (singular, Neumann) coarse operator:
    inv(A_c + α·𝟙𝟙ᵀ/n).  Aggregates with an empty row are decoupled with a
    unit diagonal."""
    nc = ac.shape[0]
    d = np.diag(ac).copy()
    dead = d <= 0
    if dead.any():
        ac = ac.copy()
        ac[dead, :] = 0.0
        ac[:, dead] = 0.0
        ac[dead, dead] = 1.0
        d = np.diag(ac)
    alpha = float(d.mean())
    return np.linalg.inv(ac + alpha * np.ones((nc, nc)) / nc)


def build_twolevel(csr_op, coords: np.ndarray, matvec, inv_diag: torch.Tensor, *,
                   target_coarse: int = 2048, dtype=torch.float64, coarse_dtype=None,
                   lmax: float | None = None) -> TwoLevel:
    """Host-side construction from the (merged) fine CSR operator; the
    device pieces go to ``inv_diag``'s device.  ``coarse_dtype`` (e.g.
    ``torch.bfloat16``) overrides the storage dtype of the coarse inverse."""
    from tpufem_torch.solve.cg import estimate_lmax

    dev = inv_diag.device
    agg, nc = build_aggregates(np.asarray(coords), target_coarse)
    ac_inv = coarse_inverse(galerkin_coarse(csr_op, agg, nc))
    if lmax is None:
        lmax = estimate_lmax(matvec, inv_diag, coords.shape[0])
    order = np.argsort(agg, kind="stable")

    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    return TwoLevel(
        agg_sorted=idx(agg[order]),
        order=idx(order),
        agg=idx(agg),
        ac_inv=torch.as_tensor(ac_inv, dtype=coarse_dtype or dtype, device=dev),
        omega=1.0 / float(lmax),
    )


def twolevel_preconditioner(matvec, inv_diag, tl: TwoLevel, active_mask=None):
    """M(r) closure for CG (SPD on the active subspace), for r (N,) or
    (N, k) columns (``inv_diag`` and ``active_mask`` shaped to broadcast)."""
    nc = tl.n_coarse

    def smooth(r):
        return tl.omega * (inv_diag * r)

    def coarse(r):
        rc = torch.zeros((nc,) + tuple(r.shape[1:]), dtype=r.dtype, device=r.device).index_add_(
            0, tl.agg_sorted, r[tl.order])
        # the coarse product in the coarse storage dtype, back in the field's
        z = (tl.ac_inv @ rc.to(tl.ac_inv.dtype)).to(r.dtype)[tl.agg]
        return z if active_mask is None else z * active_mask

    def M(r):
        z1 = smooth(r)
        z2 = z1 + coarse(r - matvec(z1))
        return z2 + smooth(r - matvec(z2))

    return M
