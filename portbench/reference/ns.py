"""The forced Navier–Stokes box, plain PyTorch, any dtype: the operator-split
projection with implicit advection of the reference project's
``scripts/operator_spitting_ns.py`` (its "opsplit" advection form).

One step from the velocity uⁿ (N, 2):

  1. C(u): on each triangle e, C_ij^e = (ū_e·∇φ_j)·A_e/3, ū_e the mean of
     its corners' velocities, ∇φ_j the P1 gradient, A_e the signed area
     det/2, the row index i uniform;
  2. (I + Δt·C(u) + νΔt·K) u* = uⁿ + Δt·f on every node, K the P1
     stiffness (∇φ_i·∇φ_j)·A_e with the signed area, solved by BiCGStab
     with the diagonal as preconditioner;
  3. K̄ p = M_L ∘ (−ρ div u*/Δt), K̄ the stiffness with the area |det|/2,
     M_L the lumped mass, div the lumped nodal divergence, with the
     constant taken out on the active nodes (those in a valid triangle);
  4. u = u* − Δt ∇p (the lumped nodal gradient);
  5. u = 0 on the four walls, the body's ring and the inert nodes.

Every solve runs until its residual falls below ``rtol`` of its
right-hand side (or ``4·eps`` of the dtype, where that is larger), so the
answer depends neither on a warm start nor on a preconditioner.

Departures from the source, each also tpufem's:

* the pressure's right-hand side is weighed by the lumped mass (tpufem's
  ``pressure_scaling="mass_lumped"``); the source solves K p = −div u*/Δt
  with the nodal divergence unweighed, which tpufem records as unstable;
* the source pins p at node 0 with the unlumped K; here the constant is
  deflated on the active nodes, as the program's grid path does: u is the
  same, p differs by a constant;
* the source solves both systems directly in float64; here the solves are
  iterative, to 1e-10;
* the signed determinant in C and K, the unsigned in K̄: the source's
  choice; on a counter-clockwise mesh, as every mesh of the benchmark's
  generator is, the two agree.

The pressure solve's preconditioner (a damped Jacobi sweep, a correction
on 32 × 32 boxes of nodes, another sweep) is a solver aid only, as in
``step.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import fem
from portbench.reference.step import NotConverged, pcg


@dataclasses.dataclass(frozen=True)
class Problem:
    """The operators of one box, on the pattern of its triangles: every
    matrix is an ``fem.Ell`` on ``cols``, and ``slot`` places each
    element entry (t, i, j) in the padded rows."""

    n: int
    dt: float
    nu: float
    rho: float
    cols: torch.Tensor  # (N, W) int64
    slot: torch.Tensor  # (9·T,) int64: entry (t, i, j) → flat index into (N, W)
    nu_dt_K: fem.Ell  # νΔt·K, signed area
    K_bar: fem.Ell  # the pressure's stiffness, |det|/2
    Dx: fem.Ell  # lumped nodal ∂/∂x
    Dy: fem.Ell
    inv_diag: torch.Tensor  # (N, 1): 1 / (1 + νΔt·|K_ii|), the velocity solve's preconditioner
    Kbar_inv_diag: torch.Tensor  # (N,) 1/K̄_ii on the active nodes, 0 elsewhere
    m_lumped: torch.Tensor  # (N,)
    active: torch.Tensor  # (N,) 1 on the nodes of a valid triangle
    zero: torch.Tensor  # (N,) bool: walls, ring and inert nodes, u = 0 after a step
    body_force: torch.Tensor  # (2,)
    tris: torch.Tensor  # (T, 3) int64
    grads: torch.Tensor  # (T, 3, 2)
    row: torch.Tensor  # (T,) det/6 on valid triangles, 0 on degenerate ones
    agg: torch.Tensor  # (N,) each active node's coarse box, -1 elsewhere
    coarse_pinv: torch.Tensor  # (C, C)

    @property
    def dtype(self):
        return self.m_lumped.dtype

    @property
    def device(self):
        return self.m_lumped.device

    def to(self, dtype) -> "Problem":
        """The same problem with its values in ``dtype``."""
        kw = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for name in ("nu_dt_K", "K_bar", "Dx", "Dy"):
            kw[name] = kw[name].to(dtype)
        for name in ("inv_diag", "Kbar_inv_diag", "m_lumped", "active", "body_force", "grads",
                     "row", "coarse_pinv"):
            kw[name] = kw[name].to(dtype)
        return Problem(**kw)


def _degree(tris, valid, n: int) -> np.ndarray:
    """(N,) the number of valid triangles at each node."""
    return np.bincount(tris.reshape(-1), weights=np.repeat(valid.astype(np.float64), 3),
                       minlength=n)


def zero_nodes(coords, tris, markers, ns: dict) -> np.ndarray:
    """(N,) bool: the nodes a step leaves at u = 0, the four walls (within
    ``tol`` of x = 0, x = L, y = 0, y = H), the body's ring
    (``inner_marker``) and the inert nodes (in no valid triangle)."""
    coords = np.asarray(coords, dtype=np.float64)
    tris = np.asarray(tris, dtype=np.int64)
    _, _, valid = fem.geometry(coords, tris)
    x, y = coords[:, 0], coords[:, 1]
    L, H, tol = ns["L"], ns["H"], ns["tol"]
    walls = (np.abs(x) < tol) | (np.abs(x - L) < tol) | (np.abs(y) < tol) | (np.abs(y - H) < tol)
    return (walls | (np.asarray(markers) == ns["inner_marker"])
            | (_degree(tris, valid, len(coords)) == 0))


def build(coords, tris, markers, ns: dict, dtype=torch.float64, device="cpu") -> Problem:
    """The box of the configuration fields ``ns`` (``dt``, ``nu``, ``rho``,
    ``body_force``, ``L``, ``H``, ``tol``, ``inner_marker``) on the mesh
    arrays, assembled in float64 on the host."""
    coords = np.asarray(coords, dtype=np.float64)
    tris = np.asarray(tris, dtype=np.int64)
    markers = np.asarray(markers)
    n = len(coords)
    area, grads, valid = fem.geometry(coords, tris)
    p = coords[tris]
    det = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
           - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1]))

    rows = np.repeat(tris, 3, axis=1).reshape(-1)  # i of each (t, i, j) entry
    cols = np.tile(tris, (1, 3)).reshape(-1)  # j
    key = rows * n + cols
    uniq, inv = np.unique(key, return_inverse=True)
    r = uniq // n
    counts = np.bincount(r, minlength=n)
    width = max(1, int(counts.max()))
    pos = np.arange(len(uniq)) - np.repeat(np.cumsum(counts) - counts, counts)
    C = np.zeros((n, width), dtype=np.int64)
    C[r, pos] = uniq % n
    slot = (r * width + pos)[inv.reshape(-1)]

    def ell(vals):
        flat = np.bincount(slot, weights=vals, minlength=n * width)
        return fem.Ell(torch.as_tensor(C, device=device),
                       torch.as_tensor(flat.reshape(n, width), dtype=dtype, device=device))

    gg = np.einsum("tid,tjd->tij", grads, grads)
    k_signed = np.where(valid[:, None, None], gg * (0.5 * det)[:, None, None], 0.0).reshape(-1)
    k_bar = np.where(valid[:, None, None], gg * area[:, None, None], 0.0).reshape(-1)
    m_lumped = np.bincount(tris.reshape(-1), weights=np.repeat(area / 3.0, 3), minlength=n)
    w = np.where(valid, area / 3.0, 0.0)
    node_area = np.bincount(tris.reshape(-1), weights=np.repeat(w, 3), minlength=n)
    inv_area = 1.0 / (node_area + fem.EPS_AREA)
    dx = (w[:, None, None] * grads[:, None, :, 0]).repeat(3, axis=1).reshape(-1)
    dy = (w[:, None, None] * grads[:, None, :, 1]).repeat(3, axis=1).reshape(-1)
    on_diag = rows == cols
    k_diag = np.bincount(rows[on_diag], weights=k_signed[on_diag], minlength=n)
    kbar_diag = np.bincount(rows[on_diag], weights=k_bar[on_diag], minlength=n)

    active = (_degree(tris, valid, n) > 0).astype(np.float64)
    zero = zero_nodes(coords, tris, markers, ns)
    L, H = ns["L"], ns["H"]

    box = np.minimum((coords / np.array([L, H]) * fem.COARSE).astype(np.int64), fem.COARSE - 1)
    agg = np.where(active > 0, box[:, 0] * fem.COARSE + box[:, 1], -1)
    ra, ca = agg[rows], agg[cols]
    both = (ra >= 0) & (ca >= 0)
    galerkin = np.bincount(ra[both] * fem.COARSE**2 + ca[both], weights=k_bar[both],
                           minlength=fem.COARSE**4).reshape(fem.COARSE**2, fem.COARSE**2)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    nu_dt = float(ns["nu"]) * float(ns["dt"])
    safe = np.where(kbar_diag > 0, kbar_diag, 1.0)
    return Problem(
        n=n, dt=float(ns["dt"]), nu=float(ns["nu"]), rho=float(ns["rho"]),
        cols=torch.as_tensor(C, device=device), slot=torch.as_tensor(slot, device=device),
        nu_dt_K=ell(nu_dt * k_signed), K_bar=ell(k_bar),
        Dx=ell(dx * inv_area[rows]), Dy=ell(dy * inv_area[rows]),
        inv_diag=t(1.0 / (1.0 + nu_dt * np.abs(k_diag)))[:, None],
        Kbar_inv_diag=t(active / safe), m_lumped=t(m_lumped), active=t(active),
        zero=torch.as_tensor(zero, device=device), body_force=t(ns["body_force"]),
        tris=torch.as_tensor(tris, device=device), grads=t(grads),
        row=t(np.where(valid, det / 6.0, 0.0)),
        agg=torch.as_tensor(agg, device=device),
        coarse_pinv=t(np.linalg.pinv(galerkin, rcond=1e-12, hermitian=True)),
    )


def bicgstab(apply, b, precond, x0, rtol, max_iters, strict=True):
    """Right-preconditioned BiCGStab on ``apply`` for the columns of ``b``
    (N, C) at once, each with its own scalars → x with ‖b_c − apply(x)_c‖ ≤
    rtol·‖b_c‖ for every column.  After ``max_iters`` iterations it raises
    :class:`NotConverged`, or without ``strict`` returns the iterate of the
    smallest residual it checked."""

    def dot(a, c):
        return torch.sum(a * c, dim=0)

    def ratio(num, den):
        return torch.where(den != 0, num / torch.where(den != 0, den, 1.0), 0.0)

    goal = rtol * torch.linalg.vector_norm(b, dim=0)
    x = x0
    r = b - apply(x)
    r_hat = r
    rho = alpha = omega = torch.ones(b.shape[1], dtype=b.dtype, device=b.device)
    v = p = torch.zeros_like(b)
    best, best_x = float("inf"), x
    for k in range(max_iters + 1):
        if k % 4 == 0 or k == max_iters:
            res = torch.linalg.vector_norm(r, dim=0)
            if bool(torch.all(res <= goal)):
                return x
            worst = float(torch.max(res / torch.clamp(goal, min=torch.finfo(b.dtype).tiny)))
            if worst < best:
                best, best_x = worst, x
        if k == max_iters:
            break
        rho_new = dot(r_hat, r)
        beta = ratio(rho_new, rho) * ratio(alpha, omega)
        p = r + beta * (p - omega * v)
        ph = precond(p)
        v = apply(ph)
        alpha = ratio(rho_new, dot(r_hat, v))
        s = r - alpha * v
        sh = precond(s)
        t = apply(sh)
        omega = ratio(dot(t, s), dot(t, t))
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rho = rho_new
    if not strict:
        return best_x
    raise NotConverged(f"BiCGStab left a residual of {best * rtol:.3e} of the rhs after "
                       f"{max_iters} iterations (asked {rtol:.1e})")


class NS:
    """Steps of the reference on ``problem``, in the dtype of its values.
    ``max_iters`` caps the velocity and the pressure solve; without
    ``strict`` a solve that reaches its cap keeps its best iterate."""

    def __init__(self, problem: Problem, rtol: float = 1e-10, max_iters=(5_000, 5_000),
                 strict: bool = True):
        torch.backends.cuda.matmul.allow_tf32 = False  # the coarse product in full float32
        self.pb = problem
        self.rtol = max(rtol, 4.0 * torch.finfo(problem.dtype).eps)
        self.vel_iters, self.pressure_iters = max_iters
        self.strict = strict
        self.act_sq = torch.sum(problem.active * problem.active)
        # the damping: 1 / the Gershgorin bound of D⁻¹K̄'s largest eigenvalue
        rows = problem.K_bar.vals.abs().sum(dim=1) * problem.Kbar_inv_diag
        self.omega = 1.0 / float(rows.max())

    def convection(self, u) -> fem.Ell:
        """C(u) on the problem's pattern."""
        pb = self.pb
        ubar = u[pb.tris].mean(dim=1)  # (T, 2)
        udotg = torch.sum(ubar[:, None, :] * pb.grads, dim=2)  # (T, 3): ū·∇φ_j
        ce = (pb.row[:, None, None] * udotg[:, None, :]).expand(-1, 3, 3).reshape(-1)
        vals = torch.zeros(pb.cols.numel(), dtype=u.dtype, device=u.device)
        return fem.Ell(pb.cols, vals.index_add_(0, pb.slot, ce).reshape(pb.cols.shape))

    def velocity(self, u):
        pb = self.pb
        C = self.convection(u)
        A = fem.Ell(pb.cols, pb.dt * C.vals + pb.nu_dt_K.vals)

        def apply(X):
            return X + A @ X

        return bicgstab(apply, u + pb.dt * pb.body_force, lambda r: pb.inv_diag * r, u,
                        self.rtol, self.vel_iters, strict=self.strict)

    def div(self, u):
        return self.pb.Dx @ u[:, 0] + self.pb.Dy @ u[:, 1]

    def grad(self, p):
        return torch.stack([self.pb.Dx @ p, self.pb.Dy @ p], dim=1)

    def _coarse(self, r):
        pb = self.pb
        act = pb.agg >= 0
        c = torch.zeros(pb.coarse_pinv.shape[0], dtype=r.dtype, device=r.device)
        c = c.index_add(0, pb.agg[act], r[act])
        return torch.where(act, (pb.coarse_pinv @ c)[pb.agg.clamp(min=0)], 0.0)

    def _pressure_precond(self, r):
        K, w = self.pb.K_bar, self.omega * self.pb.Kbar_inv_diag
        z = w * r
        z = z + self._coarse(r - K @ z)
        return z + w * (r - K @ z)

    def pressure(self, b, x0):
        pb = self.pb
        act = pb.active

        def project(v):
            return v - (torch.sum(act * v) / self.act_sq) * act

        rhs = project(pb.m_lumped * b * act)
        return pcg(lambda v: project(pb.K_bar @ v), rhs, self._pressure_precond,
                   project(x0 * act), self.rtol, self.pressure_iters, project, self.strict)

    def start(self, u, p=None) -> dict:
        """A state from host or device arrays, in the problem's dtype."""
        pb = self.pb
        u = torch.as_tensor(u, device=pb.device).to(pb.dtype)
        p = (torch.zeros(pb.n, dtype=pb.dtype, device=pb.device) if p is None
             else torch.as_tensor(p, device=pb.device).to(pb.dtype))
        return {"u": u, "p": p}

    def step(self, state: dict) -> dict:
        pb = self.pb
        us = self.velocity(state["u"])
        p = self.pressure(-(pb.rho / pb.dt) * self.div(us), state["p"])
        u = us - pb.dt * self.grad(p)
        u = torch.where(pb.zero[:, None], 0.0, u)
        return {"u": u, "p": p}

    def advance(self, state: dict, steps: int) -> dict:
        for _ in range(steps):
            state = self.step(state)
        return state
