"""Matrix-free CG solvers over CSR operators (``cg_storage="csr"``).

The counterpart of ``tpufem.solve.matfree``, plain PyTorch throughout (no
kernel: this is the scale regime's CPU path and its fallback off the grid
numbering).

* :class:`ViscousCG`: (I + Δt·ν·K) with the Dirichlet row+column surgery
  as masking, A(x) = m ∘ (x + Δt·ν·K(m ∘ x)) + (1−m) ∘ x.
* :class:`PressureCG`: the periodic pressure Poisson in merged symmetric
  weak form, K_merged p = merge(M_L ∘ b), constant nullspace deflated, or
  gauge-pinned at one dof (``pin``, the Navier–Stokes CSR path).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tpufem_torch.solve.cg import _ratio, cg, cg_fixed


def _solve_columns(matvec, b, x0=None, tol: float = 0.0, block: bool = False, **kw):
    """Batched CG: one iteration stream drives all columns of b (N, k)
    with per-column step lengths.  ``tol > 0`` loops until EVERY column's
    residual is below tol·‖b_col‖ (``iters`` is then the cap).  ``block``:
    ``matvec`` takes the (N, k) block and gives each column what it gives
    that column alone (as tpufem's vmap of it), in one call instead of k."""
    if b.ndim == 1:
        if tol > 0:
            x, _ = cg(matvec, b, x0=x0, tol=tol, maxiter=kw.pop("iters"),
                      precond=kw.pop("precond", None))
            return x
        x, _ = cg_fixed(matvec, b, x0=x0, **kw)
        return x
    iters = kw.pop("iters")
    precond = kw.pop("precond", None)
    M = precond if precond is not None else (lambda r: r)

    def colsum(a, c):
        return torch.sum(a * c, dim=0)  # (k,)

    def mv(x):
        if block:
            return matvec(x)
        return torch.stack([matvec(x[:, c]) for c in range(x.shape[1])], dim=1)

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - mv(x)
    z = M(r)
    p, rz = z, colsum(r, z)
    atol2 = (tol * torch.clamp(torch.sqrt(colsum(b, b)), min=1e-30)) ** 2
    k = 0
    while k < iters and (tol <= 0 or bool(torch.any(colsum(r, r) > atol2))):
        ap = mv(p)
        alpha = _ratio(rz, colsum(p, ap))
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        rz_new = colsum(r, z)
        beta = _ratio(rz_new, rz)
        p = z + beta * p
        rz = rz_new
        k += 1
    return x


@dataclasses.dataclass(frozen=True)
class ViscousCG:
    K: object  # an operator with .matvec(x) and .diag(): CSROperator or GridOperator
    interior_mask: torch.Tensor  # (N,) 1.0 interior / 0.0 Dirichlet
    dt_nu: float
    iters: int
    tol: float = 0.0  # > 0: early exit (relative); ``iters`` is then the cap

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        m = self.interior_mask
        return m * (x + self.dt_nu * self.K.matvec(m * x)) + (1.0 - m) * x

    def solve(self, b: torch.Tensor, x0: torch.Tensor | None = None) -> torch.Tensor:
        diag = 1.0 + self.dt_nu * self.K.diag()
        inv_diag = torch.where(self.interior_mask > 0, 1.0 / diag, torch.ones_like(diag))
        precond = lambda r: inv_diag * r if r.ndim == 1 else inv_diag[:, None] * r
        return _solve_columns(self.matvec, b, x0=x0, tol=self.tol, iters=self.iters,
                              precond=precond)


@dataclasses.dataclass(frozen=True)
class PressureCG:
    K_merged: object  # stiffness on slave→master relabeled connectivity
    m_lumped: torch.Tensor
    masters: np.ndarray
    slaves: np.ndarray
    active_mask: torch.Tensor  # 0.0 at slave dofs
    iters: int
    precond: str = "jacobi"  # "jacobi" | "chebyshev" | "twolevel"
    cheby_degree: int = 4
    lmax: float = 0.0  # power-iteration estimate (set-up time)
    twolevel: object = None  # solve.twolevel.TwoLevel (precond="twolevel")
    tol: float = 0.0  # > 0: early exit (relative); ``iters`` is then the cap
    pin: int = -1  # ≥ 0: gauge pin at this dof, masked out of the operator
    # symmetrically (row and column), its rhs and diagonal zeroed, and no
    # constant-nullspace deflation (the pin fixes the gauge: p[pin] = 0)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.pin >= 0:
            mp = self._pin_mask
            return mp * self.K_merged.matvec(mp * x) + (1.0 - mp) * x
        return self.K_merged.matvec(x)

    @functools.cached_property
    def _pin_mask(self) -> torch.Tensor:
        """The active mask with the pinned dof zeroed."""
        mask = self.active_mask.clone()
        mask[self.pin] = 0.0
        return mask

    @property
    def _index(self):
        dev = self.active_mask.device
        return (torch.as_tensor(np.asarray(self.masters, dtype=np.int64), device=dev),
                torch.as_tensor(np.asarray(self.slaves, dtype=np.int64), device=dev))

    def solve(self, b: torch.Tensor, x0: torch.Tensor | None = None) -> torch.Tensor:
        """K_merged p = merge(M_L ∘ b), warm-started from ``x0``."""
        rhs = self.m_lumped * b
        has_pairs = len(self.masters) > 0
        if has_pairs:
            m, s = self._index
            rhs = rhs.index_add(0, m, rhs[s])
            rhs = rhs * self.active_mask
        diag = self.K_merged.diag()
        if self.pin >= 0:
            rhs = rhs * self._pin_mask  # identity row at the pin
            diag = torch.where(self._pin_mask > 0, diag, torch.zeros_like(diag))
        inv_diag = torch.where(diag > 0, 1.0 / torch.where(diag > 0, diag, torch.ones_like(diag)),
                               torch.ones_like(diag))
        if self.precond == "chebyshev":
            from tpufem_torch.solve.cg import chebyshev_preconditioner

            M = chebyshev_preconditioner(self.matvec, inv_diag, self.lmax,
                                         degree=self.cheby_degree)
        elif self.precond == "twolevel":
            from tpufem_torch.solve.twolevel import twolevel_preconditioner

            M = twolevel_preconditioner(self.matvec, inv_diag, self.twolevel,
                                        active_mask=self.active_mask)
        else:
            M = lambda r: inv_diag * r
        if x0 is not None:
            x0 = x0 * (self._pin_mask if self.pin >= 0 else self.active_mask)
        deflate = self.pin < 0
        if self.tol > 0:
            p, _ = cg(self.matvec, rhs, x0=x0, tol=self.tol, maxiter=self.iters, precond=M,
                      deflate=deflate, deflate_weights=self.active_mask)
        else:
            p, _ = cg_fixed(self.matvec, rhs, x0=x0, iters=self.iters, precond=M,
                            deflate=deflate, deflate_weights=self.active_mask)
        if has_pairs:
            m, s = self._index
            p = p.index_put((s,), p[m])
        return p
