"""Plain P1 finite elements for the reference: geometry, assembly, boundary
sets and the squirmer boundary values, from the mesh arrays alone.

Everything is assembled on the host in float64 and handed to the device as
ELL matrices (every row padded to the widest row's length), so one matrix
product is one gather, one multiply and one row sum in any dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEGENERATE = 1e-14  # |det| below this: a degenerate triangle, left out
EPS_AREA = 1e-12  # added to a node's area before the lumped div/grad divide by it
COARSE = 32  # aggregates a side of the pressure solve's coarse space (a solver aid only)


@dataclasses.dataclass(frozen=True)
class Ell:
    """A square sparse matrix, rows padded to ``cols.shape[1]`` entries."""

    cols: torch.Tensor  # (N, W) int64, padding points at column 0
    vals: torch.Tensor  # (N, W), padding 0

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        g = x[self.cols]  # (N, W) or (N, W, D)
        v = self.vals if x.ndim == 1 else self.vals[..., None]
        return (v * g).sum(dim=1)

    def to(self, dtype) -> "Ell":
        return Ell(self.cols, self.vals.to(dtype))


def ell(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n: int, dtype, device) -> Ell:
    """Sum the COO entries (duplicates added) into an ELL matrix."""
    key = rows.astype(np.int64) * n + cols.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    summed = np.bincount(inv.reshape(-1), weights=vals, minlength=len(uniq))
    r, c = np.divmod(uniq, n)
    counts = np.bincount(r, minlength=n)
    width = max(1, int(counts.max()))
    slot = np.arange(len(uniq)) - np.repeat(np.cumsum(counts) - counts, counts)
    C = np.zeros((n, width), dtype=np.int64)
    V = np.zeros((n, width))
    C[r, slot] = c
    V[r, slot] = summed
    return Ell(torch.as_tensor(C, device=device), torch.as_tensor(V, dtype=dtype, device=device))


def geometry(coords: np.ndarray, tris: np.ndarray):
    """(area (T,), grads (T, 3, 2) of the P1 basis, valid (T,))."""
    p = coords[tris]
    x, y = p[..., 0], p[..., 1]
    det = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
    valid = np.abs(det) >= DEGENERATE
    safe = np.where(valid, det, 1.0)
    # ∇φ_i = (y_{i+1} − y_{i+2}, x_{i+2} − x_{i+1}) / det
    gx = np.stack([y[:, 1] - y[:, 2], y[:, 2] - y[:, 0], y[:, 0] - y[:, 1]], axis=1) / safe[:, None]
    gy = np.stack([x[:, 2] - x[:, 1], x[:, 0] - x[:, 2], x[:, 1] - x[:, 0]], axis=1) / safe[:, None]
    return 0.5 * np.abs(det), np.stack([gx, gy], axis=2), valid


def periodic_pairs(coords: np.ndarray, L: float, H: float, tol: float):
    """(masters, slaves): each x≈0 node paired with the x≈L node of nearest
    y; pairs whose x≈0 node lies on a wall (y≈0 or y≈H) are left out."""
    left = np.nonzero(np.abs(coords[:, 0]) < tol)[0]
    right = np.nonzero(np.abs(coords[:, 0] - L) < tol)[0]
    if len(left) == 0 or len(right) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(coords[right, 1], kind="stable")
    ry = coords[right[order], 1]
    pos = np.clip(np.searchsorted(ry, coords[left, 1]), 1, len(ry) - 1)
    lo, hi = order[pos - 1], order[pos]
    nearer_lo = np.abs(coords[right[lo], 1] - coords[left, 1]) <= np.abs(
        coords[right[hi], 1] - coords[left, 1])
    slaves = right[np.where(nearer_lo, lo, hi)]
    y = coords[left, 1]
    keep = ~((np.abs(y) < tol) | (np.abs(y - H) < tol))
    return left[keep].astype(np.int64), slaves[keep].astype(np.int64)


def squirmer(coords: np.ndarray, center, B1: float, B2: float) -> np.ndarray:
    """(k, 2) squirmer surface velocities: tangential speed B1 sinθ + B2 sin2θ
    along (−sinθ, cosθ)."""
    th = np.arctan2(coords[:, 1] - center[1], coords[:, 0] - center[0])
    vt = B1 * np.sin(th) + B2 * np.sin(2.0 * th)
    return np.stack([-vt * np.sin(th), vt * np.cos(th)], axis=1)


def boundary_sets(coords: np.ndarray, markers: np.ndarray, stokes: dict):
    """(walls, inner, masters, slaves): the nodes at y≈0 or y≈H, the ring's
    nodes, and the periodic pairs."""
    H, tol = stokes["H"], stokes["tol"]
    walls = np.nonzero(np.isclose(coords[:, 1], 0.0, atol=tol)
                       | np.isclose(coords[:, 1], H, atol=tol))[0]
    inner = np.nonzero(np.asarray(markers) == stokes["inner_marker"])[0]
    return (walls, inner) + periodic_pairs(coords, stokes["L"], H, tol)


@dataclasses.dataclass(frozen=True)
class Problem:
    """The reference's operators and index sets of one squirmer channel."""

    n: int
    dt: float
    dt_nu: float
    L: float
    H: float
    K: Ell  # stiffness
    Km: Ell  # stiffness with every slave's rows and columns merged into its master's
    Dx: Ell  # lumped nodal ∂/∂x: div u = Dx uₓ + Dy u_y, ∇p = (Dx p, Dy p)
    Dy: Ell
    K_diag: torch.Tensor  # (N,) the stiffness's diagonal
    Km_diag: torch.Tensor
    m_lumped: torch.Tensor  # (N,)
    interior: torch.Tensor  # (N,) 1 off the Dirichlet nodes (walls and ring)
    active: torch.Tensor  # (N,) 1 where a node owns its pressure dof and has area
    walls: torch.Tensor
    inner: torch.Tensor
    inner_values: torch.Tensor  # (k, 2)
    outer_value: torch.Tensor  # (2,) the walls' velocity
    body_force: torch.Tensor  # (2,)
    masters: torch.Tensor
    slaves: torch.Tensor
    mix_mask: torch.Tensor  # (N,) bool: unmarked nodes, weighed by the mixing index
    agg: torch.Tensor  # (N,) int64: each active node's coarse aggregate, -1 elsewhere
    coarse_pinv: torch.Tensor  # (C, C) pseudo-inverse of the aggregates' Galerkin matrix
    coords: torch.Tensor  # (N, 2)
    tris: torch.Tensor  # (T, 3) int64
    tri_valid: np.ndarray  # (T,) host

    @property
    def dtype(self):
        return self.m_lumped.dtype

    @property
    def device(self):
        return self.m_lumped.device

    def to(self, dtype) -> "Problem":
        """The same problem with its operators and values in ``dtype``."""
        kw = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for name in ("K", "Km", "Dx", "Dy"):
            kw[name] = kw[name].to(dtype)
        for name in ("K_diag", "Km_diag", "m_lumped", "interior", "active", "inner_values",
                     "outer_value", "body_force", "coarse_pinv", "coords"):
            kw[name] = kw[name].to(dtype)
        return Problem(**kw)


def build(coords, tris, markers, stokes: dict, dtype=torch.float64, device="cpu") -> Problem:
    """Assemble the squirmer channel of the configuration ``stokes`` (the
    program's configuration fields) on the mesh arrays, in float64 on the
    host, and place it on ``device`` in ``dtype``."""
    coords = np.asarray(coords, dtype=np.float64)
    tris = np.asarray(tris, dtype=np.int64)
    markers = np.asarray(markers)
    n = len(coords)
    L, H, tol = stokes["L"], stokes["H"], stokes["tol"]
    area, grads, valid = geometry(coords, tris)
    m_lumped = np.bincount(tris.reshape(-1), weights=np.repeat(area / 3.0, 3), minlength=n)

    rows = np.repeat(tris, 3, axis=1).reshape(-1)  # i: the row of each (i, j) element entry
    cols = np.tile(tris, (1, 3)).reshape(-1)  # j
    ke = np.einsum("tid,tjd->tij", grads, grads) * area[:, None, None]
    ke = np.where(valid[:, None, None], ke, 0.0).reshape(-1)

    walls, inner, masters, slaves = boundary_sets(coords, markers, stokes)
    dirichlet = np.union1d(walls, inner)
    owner = np.arange(n)
    owner[slaves] = masters
    interior = np.ones(n)
    interior[dirichlet] = 0.0
    active = ((owner == np.arange(n)) & (m_lumped > 0)).astype(np.float64)

    w = np.where(valid, area / 3.0, 0.0)
    node_area = np.bincount(tris.reshape(-1), weights=np.repeat(w, 3), minlength=n)
    inv_area = 1.0 / (node_area + EPS_AREA)
    dx = (w[:, None, None] * grads[:, None, :, 0]).repeat(3, axis=1).reshape(-1)
    dy = (w[:, None, None] * grads[:, None, :, 1]).repeat(3, axis=1).reshape(-1)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    center = tuple(stokes["center"])
    diag = rows == cols
    k_diag = np.bincount(rows[diag], weights=ke[diag], minlength=n)
    mdiag = owner[rows] == owner[cols]
    km_diag = np.bincount(owner[rows[mdiag]], weights=ke[mdiag], minlength=n)
    # aggregates: a COARSE × COARSE grid of boxes over the domain
    box = np.minimum((coords / np.array([L, H]) * COARSE).astype(np.int64), COARSE - 1)
    agg = np.where(active > 0, box[:, 0] * COARSE + box[:, 1], -1)
    ra, ca = agg[owner[rows]], agg[owner[cols]]
    both = (ra >= 0) & (ca >= 0)
    galerkin = np.bincount(ra[both] * COARSE**2 + ca[both], weights=ke[both],
                           minlength=COARSE**4).reshape(COARSE**2, COARSE**2)
    coarse_pinv = np.linalg.pinv(galerkin, rcond=1e-12, hermitian=True)
    return Problem(
        n=n, dt=float(stokes["dt"]), dt_nu=float(stokes["dt"] * stokes["nu"]), L=L, H=H,
        K=ell(rows, cols, ke, n, dtype, device),
        Km=ell(owner[rows], owner[cols], ke, n, dtype, device),
        K_diag=t(k_diag), Km_diag=t(km_diag),
        Dx=ell(rows, cols, dx * inv_area[rows], n, dtype, device),
        Dy=ell(rows, cols, dy * inv_area[rows], n, dtype, device),
        m_lumped=t(m_lumped), interior=t(interior), active=t(active),
        walls=idx(walls), inner=idx(inner),
        inner_values=t(squirmer(coords[inner], center, stokes["B1"], stokes["B2"])),
        outer_value=t(stokes["outer_value"]), body_force=t(stokes["body_force"]),
        masters=idx(masters), slaves=idx(slaves),
        mix_mask=torch.as_tensor(markers == 0, device=device),
        agg=idx(agg), coarse_pinv=t(coarse_pinv),
        coords=t(coords), tris=idx(tris), tri_valid=valid,
    )
