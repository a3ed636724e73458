"""Conjugate-gradient solvers (matrix-free), plain PyTorch.

The counterpart of ``tpufem.solve.cg``, with the same algorithms and
guards:

* :func:`cg`: tolerance-controlled loop (early exit),
* :func:`cg_fixed`: a fixed iteration count,
* :func:`bicgstab_fixed`: right-preconditioned BiCGStab for nonsymmetric
  systems, fixed count or tolerance exit, with finite-or-zero guards.

PyTorch runs eagerly, so a tolerance loop's condition is read on the host
each iteration: a device synchronisation per iteration on CUDA.  The scale
regime's hot path does not use these (its whole solves are kernels K2 and
K3 in ``solve/grid_cg.py``, which decide their early exit on the device).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def _deflate(x: torch.Tensor, weights: torch.Tensor | None) -> torch.Tensor:
    """Project out the nullspace component along ``weights`` (default: the
    constant vector): the orthogonal projection x − (v·x / v·v) v."""
    if weights is None:
        return x - torch.mean(x)
    return x - (_dot(weights, x) / _dot(weights, weights)) * weights


def _ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, or 0 where den == 0 (the CG denominator guard)."""
    return torch.where(den != 0, num / den, torch.zeros_like(den))


def cg(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    tol: float = 1e-10,
    maxiter: int = 1000,
    precond: Callable | None = None,
    deflate: bool = False,
    deflate_weights: torch.Tensor | None = None,
):
    """Preconditioned CG; returns (x, (iters, resnorm))."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    M = precond if precond is not None else (lambda r: r)

    def project(v):
        return _deflate(v, deflate_weights) if deflate else v

    b = project(b)
    r = project(b - matvec(x0))
    z = project(M(r))
    x, p, rz = x0, z, _dot(r, z)
    atol2 = (tol * torch.clamp(torch.linalg.norm(b), min=1e-30)) ** 2
    k = 0
    while k < maxiter and bool(_dot(r, r) > atol2):
        Ap = project(matvec(p))
        alpha = rz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        # the preconditioned direction is deflated too, as in cg_fixed
        z = project(M(r))
        rz_new = _dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        x = project(x) if deflate else x
        k += 1
    return x, (k, torch.linalg.norm(r))


def cg_fixed(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    iters: int = 100,
    precond: Callable | None = None,
    deflate: bool = False,
    deflate_weights: torch.Tensor | None = None,
):
    """CG with a static iteration count.  Returns (x, resnorm)."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    M = precond if precond is not None else (lambda r: r)

    def project(v):
        return _deflate(v, deflate_weights) if deflate else v

    b = project(b)
    r = project(b - matvec(x0))
    z = project(M(r))
    x, p, rz = x0, z, _dot(r, z)
    for _ in range(iters):
        Ap = project(matvec(p))
        alpha = _ratio(rz, _dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = project(M(r))
        rz_new = _dot(r, z)
        beta = _ratio(rz_new, rz)
        p = z + beta * p
        rz = rz_new
    return (project(x) if deflate else x), torch.linalg.norm(r)


def _finite(v: torch.Tensor) -> torch.Tensor:
    """v where finite, else 0: a BiCGStab ratio at breakdown (ρ or ω zero,
    denormal or overflowing) then makes no progress instead of poisoning
    every later iterate."""
    return torch.where(torch.isfinite(v), v, torch.zeros_like(v))


def bicgstab_fixed(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    iters: int = 100,
    precond: Callable | None = None,
    tol: float = 0.0,
):
    """Right-preconditioned BiCGStab for nonsymmetric systems; returns
    (x, ‖r‖).  ``tol = 0`` runs exactly ``iters`` iterations; ``tol > 0``
    stops once ‖r‖ ≤ tol·‖b‖ (``iters`` is then the cap), reading the test
    on the host each iteration."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    atol2 = (tol * torch.clamp(torch.linalg.norm(b), min=1e-30)) ** 2
    x, r, _ = bicgstab_core(matvec, b, x0, iters=iters, precond=precond, tol=tol,
                            atol2=atol2, dot=_dot)
    return x, torch.linalg.norm(r)


def bicgstab_core(matvec: Callable, b: torch.Tensor, x0: torch.Tensor, *, iters: int,
                  precond: Callable | None, tol: float, atol2: torch.Tensor, dot: Callable):
    """The BiCGStab loop of :func:`bicgstab_fixed` and of the plain grid
    solve (``grid_cg.ns_bicgstab_ref``), which runs several columns in
    lockstep: ``dot`` gives one scalar per column, shaped to broadcast
    against the vectors (a 0-d tensor for one column), and ``atol2`` is
    that shape too.  With ``tol > 0`` the loop runs while any column's
    ‖r‖² exceeds its ``atol2``.  Returns (x, r, iterations run)."""
    M = precond if precond is not None else (lambda r: r)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    x, r = x0, b - matvec(x0)
    rhat = r
    p = v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones_like(atol2)
    k = 0
    while k < iters and (tol <= 0 or bool(torch.any(dot(r, r) > atol2))):
        rho_new = dot(rhat, r)
        beta = _finite(torch.where((rho != 0) & (omega != 0), (rho_new / rho) * (alpha / omega), zero))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = matvec(phat)
        denom = dot(rhat, v)
        alpha = _finite(torch.where(denom != 0, rho_new / denom, zero))
        s = r - alpha * v
        shat = M(s)
        t = matvec(shat)
        tt = dot(t, t)
        omega = _finite(torch.where(tt != 0, dot(t, s) / tt, zero))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
    return x, r, k


def jacobi_pcg(matvec, diag, b, **kwargs):
    """CG preconditioned with the operator diagonal."""
    inv_diag = torch.where(diag != 0, 1.0 / diag, torch.ones_like(diag))
    return cg(matvec, b, precond=lambda r: inv_diag * r, **kwargs)


def chebyshev_preconditioner(matvec, inv_diag, lmax: float, degree: int = 4,
                             lmin_frac: float = 0.06):
    """Fixed-degree Chebyshev approximate inverse of the Jacobi-scaled
    operator over [lmin_frac·λmax, λmax]: a linear SPD preconditioner that
    costs ``degree`` matvecs per application."""
    lmax = float(lmax)
    lmin = lmin_frac * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)

    def scaled_mv(v):
        return inv_diag * matvec(v)

    def M(r):
        rs = inv_diag * r
        z = rs / theta
        if degree == 1:
            return z
        d = z
        sigma = theta / delta
        rho_old = 1.0 / sigma
        resid = rs - scaled_mv(z)
        for _ in range(degree - 1):
            rho = 1.0 / (2.0 * sigma - rho_old)
            d = rho * rho_old * d + (2.0 * rho / delta) * resid
            z = z + d
            resid = resid - scaled_mv(d)
            rho_old = rho
        return z

    return M


def estimate_lmax(matvec, inv_diag: torch.Tensor, n: int, iters: int = 25, seed: int = 0) -> float:
    """Power-iteration estimate of λmax of the Jacobi-scaled operator, with
    a 5 % safety margin (set-up time).

    The start vector is float64 from ``np.random.default_rng(seed)``, and
    the operator's values stay in their own dtype: the products promote to
    float64, exactly as in tpufem under x64, so ω agrees with it."""
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.standard_normal(n), dtype=torch.float64, device=inv_diag.device)
    lam = torch.ones((), dtype=torch.float64)
    for _ in range(iters):
        w = inv_diag * matvec(v)
        lam = torch.linalg.norm(w)
        v = w / (lam + 1e-30)
    lam = float(lam)
    if not (np.isfinite(lam) and lam > 0):
        # a NaN ω would poison every later preconditioner application
        raise FloatingPointError(f"power iteration returned λmax={lam}: operator fault")
    return lam * 1.05
