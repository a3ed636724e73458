"""Transport on the flow: point location, dye advection, tracers, mixing.

Same semantics as ``tpufem.transport``:

* a uniform-grid binned point locator whose per-cell candidate lists are
  packed on the host into ONE flat row per cell, so a locate is one row
  gather plus elementwise containment tests (first containing candidate
  wins, as in the reference's ``PointLocator.find``),
* semi-Lagrangian dye advection with periodic-x barycentric weights,
* passive tracer advection (Euler or RK2) with food-capture statistics,
* the Danckwerts mixing index.

The locator's tables live on the device; every per-step function here is
a few gathers and elementwise tensor ops with no host synchronisation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufem_torch.mesh.core import Mesh

_DEG_TOL = 1e-14


def _barycentric(tri_xy: torch.Tensor, p: torch.Tensor):
    """Barycentric weights of points p (..., 2) in triangles (..., 3, 2).

        det = (x2−x1)(y3−y1) − (x3−x1)(y2−y1)
        w1  = ((x2−x)(y3−y) − (x3−x)(y2−y)) / det, etc.
    Returns (w (..., 3), det (...,))."""
    x1, y1 = tri_xy[..., 0, 0], tri_xy[..., 0, 1]
    x2, y2 = tri_xy[..., 1, 0], tri_xy[..., 1, 1]
    x3, y3 = tri_xy[..., 2, 0], tri_xy[..., 2, 1]
    x, y = p[..., 0], p[..., 1]
    det = (x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1)
    safe = torch.where(torch.abs(det) < _DEG_TOL, 1.0, det)
    w1 = ((x2 - x) * (y3 - y) - (x3 - x) * (y2 - y)) / safe
    w2 = ((x3 - x) * (y1 - y) - (x1 - x) * (y3 - y)) / safe
    w3 = 1.0 - w1 - w2
    return torch.stack([w1, w2, w3], dim=-1), det


def _tri_xy_table(mesh: Mesh) -> np.ndarray:
    """(T, 3, 2) corner coordinates of every triangle."""
    return mesh.coords[mesh.tris]


def _tri_aabb_overlap_batch(tri: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """Batched 2D separating-axis test: triangles (B,3,2) vs boxes (B,2).

    Returns (B,) bool.  Axes tested: x, y, and the 3 edge normals of each
    triangle; a pair overlaps iff no axis separates the projections."""
    b = tri.shape[0]
    box = np.stack(
        [
            np.stack([lo[:, 0], lo[:, 1]], axis=1),
            np.stack([hi[:, 0], lo[:, 1]], axis=1),
            np.stack([hi[:, 0], hi[:, 1]], axis=1),
            np.stack([lo[:, 0], hi[:, 1]], axis=1),
        ],
        axis=1,
    )  # (B,4,2)
    edges = tri[:, [1, 2, 0]] - tri  # (B,3,2)
    normals = np.stack([-edges[..., 1], edges[..., 0]], axis=2)  # (B,3,2)
    xy = np.broadcast_to(np.eye(2), (b, 2, 2))
    axes = np.concatenate([xy, normals], axis=1)  # (B,5,2)
    t_proj = np.einsum("bvd,bad->bav", tri, axes)  # (B,5,3)
    b_proj = np.einsum("bvd,bad->bav", box, axes)  # (B,5,4)
    sep = (t_proj.max(axis=2) < b_proj.min(axis=2) - 1e-15) | (
        b_proj.max(axis=2) < t_proj.min(axis=2) - 1e-15
    )
    return ~sep.any(axis=1)


def _bin_triangles(mesh: Mesh, g: int, exact: bool = True):
    """Host binning of triangles into a g×g grid over the bounding box →
    (cells (g², C_max) int32 −1 padded, ascending triangle id per cell;
    origin (2,); extent (2,)).  ``exact=True`` prunes bounding-box
    candidates with a triangle-vs-cell separating-axis test."""
    lo = mesh.coords.min(axis=0)
    hi = mesh.coords.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    pc = _tri_xy_table(mesh)  # (T,3,2)
    tmin = ((pc.min(axis=1) - lo) / extent * g).astype(int).clip(0, g - 1)
    tmax = ((pc.max(axis=1) - lo) / extent * g).astype(int).clip(0, g - 1)
    cell_w = extent / g

    pair_cells = []
    pair_tris = []
    max_dx = int((tmax[:, 0] - tmin[:, 0]).max()) + 1
    max_dy = int((tmax[:, 1] - tmin[:, 1]).max()) + 1
    tri_ids = np.arange(mesh.n_tris)
    for dx in range(max_dx):
        for dy in range(max_dy):
            cx = tmin[:, 0] + dx
            cy = tmin[:, 1] + dy
            sel = (cx <= tmax[:, 0]) & (cy <= tmax[:, 1])
            if not sel.any():
                continue
            t_sel = tri_ids[sel]
            if exact:
                c0 = lo + np.stack([cx[sel], cy[sel]], axis=1) * cell_w
                keep = _tri_aabb_overlap_batch(pc[t_sel], c0, c0 + cell_w)
                t_sel = t_sel[keep]
                cx_k, cy_k = cx[sel][keep], cy[sel][keep]
            else:
                cx_k, cy_k = cx[sel], cy[sel]
            pair_cells.append(cx_k * g + cy_k)
            pair_tris.append(t_sel)
    cell_ids = np.concatenate(pair_cells)
    tri_of = np.concatenate(pair_tris)
    order = np.lexsort((tri_of, cell_ids))  # ascending tri within cell
    cell_ids, tri_of = cell_ids[order], tri_of[order]
    counts = np.bincount(cell_ids, minlength=g * g)
    cmax = max(1, int(counts.max()))
    cells = np.full((g * g, cmax), -1, dtype=np.int32)
    slot = np.arange(len(cell_ids)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    cells[cell_ids, slot] = tri_of
    return cells, lo, extent


def _pack_candidate_rows(mesh: Mesh, cells: np.ndarray) -> np.ndarray:
    """Pack per-cell candidate data into flat float64 rows (G², 10·C),
    section-major: [x1|y1|x2|y2|x3|y3|tri ids|c1|c2|c3], each section C
    wide.  Ids ride as floats, exact below 2²⁴ in float32."""
    n_cells, cmax = cells.shape
    if max(mesh.n_tris, mesh.n_nodes) >= 2**24:
        raise ValueError(
            f"packed locator rows store ids as floats: n_tris={mesh.n_tris}, "
            f"n_nodes={mesh.n_nodes} exceed the 2^24 float32-exact integer range"
        )
    pc = _tri_xy_table(mesh)  # (T,3,2)
    cell_xy = np.zeros((n_cells, cmax, 3, 2))
    valid = cells >= 0
    cell_xy[valid] = pc[cells[valid]]
    corners = np.zeros((n_cells, cmax, 3))
    corners[valid] = mesh.tris[cells[valid]]
    sections = [cell_xy[:, :, j, d] for j in range(3) for d in range(2)]
    sections.append(cells.astype(np.float64))
    sections.extend(corners[:, :, j] for j in range(3))
    return np.concatenate(sections, axis=1)


@dataclasses.dataclass(frozen=True)
class GridLocator:
    """Uniform-grid binned locator with padded candidate lists.

    ``cells`` stays on the host; ``rows`` (the packed candidate table),
    ``origin``, ``extent`` and the node ``coords`` live on the device in
    the run's dtype.  O(P·C_max) per locate."""

    mesh: Mesh
    cells: np.ndarray  # (G*G, C_max) int32, -1 padded
    rows: torch.Tensor  # (G*G, 10*C_max): [6C coords | C tri ids | 3C corners]
    origin: torch.Tensor  # (2,)
    extent: torch.Tensor  # (2,)
    g: int
    coords: torch.Tensor  # (N, 2) node coordinates

    @classmethod
    def build(cls, mesh: Mesh, g: int = 16, exact: bool = True,
              dtype=torch.float64, device=None) -> "GridLocator":
        cells, origin, extent = _bin_triangles(mesh, g, exact)
        return cls.from_tables(mesh, cells, origin, extent, g, dtype=dtype, device=device)

    @classmethod
    def from_tables(cls, mesh: Mesh, cells, origin, extent, g: int, rows=None,
                    dtype=torch.float64, device=None) -> "GridLocator":
        """A locator from host tables; ``rows`` defaults to packing ``cells``."""
        cells = np.asarray(cells, dtype=np.int32)
        if rows is None:
            rows = _pack_candidate_rows(mesh, cells)

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

        return cls(mesh=mesh, cells=cells, rows=t(rows), origin=t(origin),
                   extent=t(extent), g=int(g), coords=t(mesh.coords))

    def find(self, points: torch.Tensor, return_weights: bool = False):
        """→ (tri_ids (P,), found (P,) bool[, weights (P, 3)])."""
        row, c = _gather_flat_rows(self.rows, self.origin, self.extent, self.g, points)
        cand, found, w, first = _containment_flat(row, c, points)
        tri_ids = torch.where(found, cand.gather(1, first[:, None])[:, 0], 0)
        if return_weights:
            return tri_ids, found, w
        return tri_ids, found

    def find_full(self, points: torch.Tensor):
        """→ (tri_ids, found, weights, corner node ids (P, 3))."""
        row, c = _gather_flat_rows(self.rows, self.origin, self.extent, self.g, points)
        cand, found, w, first = _containment_flat(row, c, points)
        tri_ids = torch.where(found, cand.gather(1, first[:, None])[:, 0], 0)
        return tri_ids, found, w, _select_corners_flat(row, c, first)


def _section(row: torch.Tensor, k: int, cmax: int) -> torch.Tensor:
    """Section ``k`` of a section-major packed row → (P, C) view."""
    return row[:, k * cmax : (k + 1) * cmax]


def _gather_flat_rows(rows, origin, extent, g: int, points):
    """ONE flat row gather per query batch → ((P, 10·C) rows, C).

    Cell indices truncate toward zero, then clip, as in tpufem."""
    c = rows.shape[1] // 10
    ij = torch.clamp(((points - origin) / extent * g).to(torch.int64), 0, g - 1)
    cell = ij[:, 0] * g + ij[:, 1]
    return rows[cell], c


def _containment_flat(row: torch.Tensor, cmax: int, points: torch.Tensor):
    """Containment test of every candidate in the packed rows.

    Returns (cand (P,C) int64, found (P,), w_sel (P,3), first (P,)):
    ``first`` is the slot of the FIRST containing candidate (0 if none)."""
    p = row.shape[0]
    tri_xy = row[:, : 6 * cmax].reshape(p, 3, 2, cmax).permute(0, 3, 1, 2)  # (P,C,3,2) view
    w, det = _barycentric(tri_xy, points[:, None, :])
    cand = _section(row, 6, cmax).to(torch.int64)
    inside = (w >= 0.0).all(dim=-1) & (torch.abs(det) >= _DEG_TOL) & (cand >= 0)
    # argmax returns the first maximal index; a bool tensor is cast first
    first = inside.to(torch.int32).argmax(dim=1)
    found = inside.any(dim=1)
    w_sel = w.gather(1, first[:, None, None].expand(p, 1, 3))[:, 0]
    return cand, found, w_sel, first


def _select_corners_flat(row: torch.Tensor, cmax: int, first: torch.Tensor) -> torch.Tensor:
    """Winning candidate's corner node ids (P, 3) from the flat row."""
    p = row.shape[0]
    corners = row[:, 7 * cmax : 10 * cmax].reshape(p, 3, cmax)
    return corners.gather(2, first[:, None, None].expand(p, 3, 1))[..., 0].to(torch.int64)


def _locate_winner(rows, origin, extent, g: int, pts):
    """Locate pts in packed tables → (found (P,), w (P,3), win_xy (P,3,2),
    corner node ids (P,3)), the winner's data straight from its row."""
    row, c = _gather_flat_rows(rows, origin, extent, g, pts)
    _, found, w, first = _containment_flat(row, c, pts)
    p = row.shape[0]
    xy = row[:, : 6 * c].reshape(p, 6, c)
    win_xy = xy.gather(2, first[:, None, None].expand(p, 6, 1))[..., 0].reshape(p, 3, 2)
    return found, w, win_xy, _select_corners_flat(row, c, first)


def interpolate(mesh: Mesh, field: torch.Tensor, points: torch.Tensor, locator: GridLocator):
    """Linear (P1) interpolation of a nodal field (N,) or (N, D) at points.

    Returns (values, found); values are 0 for points outside the mesh."""
    _, found, w, corners = locator.find_full(points)
    f2 = field if field.ndim > 1 else field[:, None]
    vals = (
        w[:, 0:1] * f2[corners[:, 0]]
        + w[:, 1:2] * f2[corners[:, 1]]
        + w[:, 2:3] * f2[corners[:, 2]]
    )
    vals = vals if field.ndim > 1 else vals[:, 0]
    mask = found if vals.ndim == 1 else found[:, None]
    return torch.where(mask, vals, 0.0), found


def _periodic_dx(a, b, L=1.0):
    """Shortest periodic x-distance."""
    d = a - b
    d = torch.where(d > 0.5 * L, d - L, d)
    d = torch.where(d < -0.5 * L, d + L, d)
    return d


def advect_semilagrange(
    mesh: Mesh,
    locator: GridLocator,
    c: torch.Tensor,
    u: torch.Tensor,
    dt: float,
    L: float = 1.0,
    H: float = 1.0,
) -> torch.Tensor:
    """One semi-Lagrangian step of nodal dye c under velocity u.

    Single Euler back-trace, x wrapped mod L (``torch.remainder``, the sign
    of the divisor), y clamped to (0, H); host triangle located with the
    non-periodic containment test; interpolation weights from periodic x
    distances; nodes whose departure point is not found keep their value."""
    eps = 1e-12
    coords = locator.coords
    xb = torch.remainder(coords[:, 0] - dt * u[:, 0], L)
    yb = coords[:, 1] - dt * u[:, 1]
    yb = torch.where(yb < 0.0, eps, yb)
    yb = torch.where(yb > H, H - eps, yb)
    pts = torch.stack([xb, yb], dim=1)
    found, _, pxy, corner = _locate_winner(
        locator.rows, locator.origin, locator.extent, locator.g, pts
    )
    x1, y1 = pxy[:, 0, 0], pxy[:, 0, 1]
    x2, y2 = pxy[:, 1, 0], pxy[:, 1, 1]
    x3, y3 = pxy[:, 2, 0], pxy[:, 2, 1]
    det = _periodic_dx(x2, x1, L) * (y3 - y1) - _periodic_dx(x3, x1, L) * (y2 - y1)
    safe = torch.where(torch.abs(det) < _DEG_TOL, 1.0, det)
    w1 = (_periodic_dx(x2, xb, L) * (y3 - yb) - _periodic_dx(x3, xb, L) * (y2 - yb)) / safe
    w2 = (_periodic_dx(x3, xb, L) * (y1 - yb) - _periodic_dx(x1, xb, L) * (y3 - yb)) / safe
    w3 = 1.0 - w1 - w2
    c_new = w1 * c[corner[:, 0]] + w2 * c[corner[:, 1]] + w3 * c[corner[:, 2]]
    return torch.where(found, c_new, c)


def init_tracer_grid(
    grid_density: int = 25,
    L: float = 1.0,
    H: float = 1.0,
    margin: float = 0.05,
    exclude_center=(0.5, 0.5),
    exclude_radius: float = 0.25,
) -> np.ndarray:
    """(P, 2) host tracer seed lattice minus the cylinder interior."""
    xx = np.linspace(margin, L - margin, grid_density)
    yy = np.linspace(margin, H - margin, grid_density)
    gx, gy = np.meshgrid(xx, yy)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
    d = np.hypot(pts[:, 0] - exclude_center[0], pts[:, 1] - exclude_center[1])
    return pts[d > exclude_radius]


def tracer_step(
    mesh: Mesh,
    locator: GridLocator,
    points: torch.Tensor,
    u: torch.Tensor,
    dt: float,
    L: float = 1.0,
    method: str = "euler",
) -> torch.Tensor:
    """Advance tracer points one step through nodal velocity u.

    ``euler`` samples u at the point, steps explicitly and wraps x (as the
    reference); ``rk2`` is the midpoint upgrade."""
    vel, _ = interpolate(mesh, u, points, locator)
    if method == "rk2":
        mid = points + 0.5 * dt * vel
        mid = torch.stack([torch.remainder(mid[:, 0], L), mid[:, 1]], dim=1)
        vel, _ = interpolate(mesh, u, mid, locator)
    new = points + dt * vel
    return torch.stack([torch.remainder(new[:, 0], L), new[:, 1]], dim=1)


def capture_update(
    points: torch.Tensor,
    status: torch.Tensor,
    center=(0.5, 0.5),
    radius: float = 0.28,
) -> torch.Tensor:
    """Mark tracers within ``radius`` of ``center`` as eaten (status=1)."""
    dx = points[:, 0] - center[0]
    dy = points[:, 1] - center[1]
    d = torch.sqrt(dx * dx + dy * dy)
    return torch.where(d <= radius, 1, status).to(status.dtype)


def mixing_index(c: torch.Tensor, mass: torch.Tensor, mask: torch.Tensor | None = None):
    """Danckwerts intensity of segregation I = Var_w(c) / (μ(1−μ)).

    ``mask`` is an optional boolean (N,) tensor; excluded nodes get weight 0.
    Returns (I, μ, var) as 0-d tensors."""
    if mask is not None:
        mass = torch.where(mask, mass, 0.0)
    W = torch.sum(mass)
    mu = torch.sum(mass * c) / W
    var = torch.sum(mass * (c - mu) ** 2) / W
    I = var / (mu * (1.0 - mu) + 1e-16)
    return I, mu, var
