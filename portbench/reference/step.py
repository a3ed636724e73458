"""The squirmer Stokes double-projection step, plain PyTorch, any dtype.

One step (the "color" variant with both projections):

  1. viscous solve on the interior, Dirichlet nodes kept:
       X_i + Δt·ν·Σ_j K_ij m_j X_j = u_i + Δt·f   (m: 1 off the Dirichlet nodes)
  2. boundary values: periodic copy master → slave, walls, squirmer ring
  3. pressure: K̃ p = merge(M_L ∘ (−div u*/Δt)) on the merged periodic
     dofs, the constant taken out; u = BC(u* − Δt·∇p)
  4. second projection, applied to the interior nodes only
  5. with dye: semi-Lagrangian advection through the new velocity

Every solve is conjugate gradients, run until the residual falls below
``rtol`` of the right-hand side (or ``4·eps`` of the dtype, where that is
larger), so the result depends neither on the warm start a solve is given
nor on its preconditioner: the diagonal for the viscous solve, and for the
pressure a symmetric two-level one (a damped Jacobi sweep, a correction on
32 × 32 boxes of nodes, another sweep), there only to keep the number of
iterations small at 10⁶ nodes.
"""

from __future__ import annotations

import torch

from portbench.reference import advect
from portbench.reference.fem import Problem


class NotConverged(RuntimeError):
    pass


def pcg(apply, b, precond, x0, rtol, max_iters, project=lambda v: v, strict=True):
    """Preconditioned CG on ``apply`` from ``x0`` → x with
    ‖b − apply(x)‖ ≤ rtol·‖b‖.  After ``max_iters`` iterations it raises
    :class:`NotConverged`, or without ``strict`` returns the iterate of the
    smallest residual it checked."""
    bnorm = torch.linalg.vector_norm(b)
    if float(bnorm) == 0.0:
        return torch.zeros_like(b)
    goal = float(rtol * bnorm)
    x = x0
    r = project(b - apply(x))
    z = project(precond(r))
    p, rz = z, torch.sum(r * z)
    best, best_x = float("inf"), x
    for k in range(max_iters + 1):
        if k % 8 == 0 or k == max_iters:
            res = float(torch.linalg.vector_norm(r))
            if res <= goal:
                return x
            if res < best:
                best, best_x = res, x
        if k == max_iters:
            break
        q = project(apply(p))
        pq = torch.sum(p * q)
        alpha = torch.where(pq != 0, rz / pq, 0.0)  # 0 once an exact solve has left r = 0
        x = x + alpha * p
        r = r - alpha * q
        z = project(precond(r))
        rz_new = torch.sum(r * z)
        p = z + torch.where(rz != 0, rz_new / rz, 0.0) * p
        rz = rz_new
    if not strict:
        return best_x
    raise NotConverged(f"CG left a residual of {best / float(bnorm):.3e} of the rhs after "
                       f"{max_iters} iterations (asked {rtol:.1e})")


class Stokes:
    """Steps of the reference on ``problem`` (the dtype of its values is
    the dtype of every step), with an optional dye locator."""

    def __init__(self, problem: Problem, rtol: float = 1e-10, max_iters=(5_000, 5_000),
                 locator: advect.Locator | None = None, strict: bool = True):
        self.pb = problem
        self.rtol = max(rtol, 4.0 * torch.finfo(problem.dtype).eps)
        self.visc_iters, self.pressure_iters = max_iters  # caps of the two kinds of solve
        self.strict = strict
        self.locator = locator
        pb = problem
        self.visc_inv_diag = (1.0 / (pb.interior * (1.0 + pb.dt_nu * pb.K_diag)
                                     + (1.0 - pb.interior)))[:, None]
        safe = torch.where(pb.Km_diag > 0, pb.Km_diag, torch.ones_like(pb.Km_diag))
        self.p_inv_diag = pb.active / safe
        self.act_sq = torch.sum(pb.active * pb.active)
        # the damping: 1 / the Gershgorin bound of D⁻¹K̃'s largest eigenvalue
        rows = pb.Km.vals.abs().sum(dim=1) * self.p_inv_diag
        self.omega = 1.0 / float(rows.max())

    # -- the pieces -------------------------------------------------------
    def bcs(self, u):
        pb = self.pb
        u = u.clone()
        u[pb.slaves] = u[pb.masters]
        u[pb.walls] = pb.outer_value
        u[pb.inner] = pb.inner_values
        return u

    def div(self, u):
        return self.pb.Dx @ u[:, 0] + self.pb.Dy @ u[:, 1]

    def grad(self, p):
        return torch.stack([self.pb.Dx @ p, self.pb.Dy @ p], dim=1)

    def viscous(self, b, x0):
        pb = self.pb
        m = pb.interior[:, None]

        def apply(X):
            return m * (X + pb.dt_nu * (pb.K @ (m * X))) + (1.0 - m) * X

        return pcg(apply, b, lambda r: self.visc_inv_diag * r, x0, self.rtol, self.visc_iters,
                   strict=self.strict)

    def _coarse(self, r):
        pb = self.pb
        act = pb.agg >= 0
        c = torch.zeros(pb.coarse_pinv.shape[0], dtype=r.dtype, device=r.device)
        c = c.index_add(0, pb.agg[act], r[act])
        return torch.where(act, (pb.coarse_pinv @ c)[pb.agg.clamp(min=0)], 0.0)

    def _pressure_precond(self, r):
        Km, w = self.pb.Km, self.omega * self.p_inv_diag
        z = w * r
        z = z + self._coarse(r - Km @ z)
        return z + w * (r - Km @ z)

    def pressure(self, b, x0):
        pb = self.pb
        act = pb.active

        def project(v):
            return v - (torch.sum(act * v) / self.act_sq) * act

        rhs = pb.m_lumped * b
        rhs = rhs.index_add(0, pb.masters, rhs[pb.slaves]) * act
        x = pcg(lambda v: project(pb.Km @ v), project(rhs), self._pressure_precond,
                project(x0 * act), self.rtol, self.pressure_iters, project, self.strict)
        x = x.clone()
        x[pb.slaves] = x[pb.masters]
        return x

    # -- the step ---------------------------------------------------------
    def start(self, u, c=None) -> dict:
        """A state from host or device arrays, in the problem's dtype."""
        pb = self.pb
        state = {"u": torch.as_tensor(u, device=pb.device).to(pb.dtype)}
        zeros = torch.zeros(pb.n, dtype=pb.dtype, device=pb.device)
        state.update(us=state["u"], p=zeros, p2=zeros)
        if c is not None:
            state["c"] = torch.as_tensor(c, device=pb.device).to(pb.dtype)
        return state

    def step(self, state: dict) -> dict:
        pb = self.pb
        dt = pb.dt
        us_raw = self.viscous(state["u"] + dt * pb.body_force, state["us"])
        us = self.bcs(us_raw)
        p = self.pressure(-self.div(us) / dt, state["p"])
        u = self.bcs(us - dt * self.grad(p))
        p2 = self.pressure(-self.div(u) / dt, state["p2"])
        u = u - dt * self.grad(p2) * pb.interior[:, None]
        out = {"u": u, "us": us_raw, "p": p, "p2": p2}
        if "c" in state:
            out["c"] = advect.semilagrange(self.locator, state["c"], u, dt, pb.L, pb.H)
        return out

    def advance(self, state: dict, steps: int) -> dict:
        for _ in range(steps):
            state = self.step(state)
        return state

    def mixing_var(self, c):
        """The mass-weighted variance of c over the unmarked nodes (the
        numerator of the Danckwerts intensity of segregation)."""
        w = torch.where(self.pb.mix_mask, self.pb.m_lumped, 0.0)
        W = torch.sum(w)
        mu = torch.sum(w * c) / W
        return torch.sum(w * (c - mu) ** 2) / W
