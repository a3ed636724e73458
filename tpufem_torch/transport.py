"""Transport on the flow: point location, dye advection, tracers, mixing.

Same semantics as ``tpufem.transport``:

* two point locators, both "first containing candidate wins" as in the
  reference's ``PointLocator.find``: :class:`TopKLocator` tests the k
  triangles with the nearest centroids, nearest first; :class:`GridLocator`
  bins triangles into a uniform grid whose per-cell candidate lists are
  packed on the host into ONE flat row per cell, so a locate is one row
  gather plus elementwise containment tests;
* :class:`BatchedGridLocator`: per-simulation grid tables stacked on a
  leading batch axis (one mesh a simulation), padded to a common width;
* semi-Lagrangian dye advection with periodic-x barycentric weights;
* passive tracer advection (Euler or RK2) with food-capture statistics;
* the Danckwerts mixing index.

Every locate takes points with leading batch axes: (P, 2) or (B, P, 2).
A locator's tables serve every batch entry alike; the stacked tables of a
:class:`BatchedGridLocator` serve one entry each.  So the batched transport
(:func:`advect_semilagrange_batched`, :func:`tracer_step_batched`) is the
single-simulation code on (B, ...) tensors: one launch serves the batch.

The tables live on the device; every per-step function here is a few
gathers and elementwise tensor ops with no host synchronisation.
"""

from __future__ import annotations

import copy
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


def _take(field: torch.Tensor, idx: torch.Tensor, batched: bool) -> torch.Tensor:
    """``field[idx]`` along the node axis: ``field`` (N, ...) shared by every
    leading index of ``idx``, or (B, N, ...) with ``idx`` (B, ...), one gather."""
    if not batched:
        return field[idx]
    rest = field.shape[2:]
    flat = idx.reshape(idx.shape[0], -1)
    index = flat.reshape(flat.shape + (1,) * len(rest)).expand(flat.shape + rest)
    return torch.gather(field, 1, index).reshape(idx.shape + rest)


def _first_containing(tri_xy: torch.Tensor, points: torch.Tensor, valid: torch.Tensor):
    """The first containing candidate of each point: ``tri_xy`` (..., P, C,
    3, 2) candidate corners in order, ``valid`` (..., P, C) the real slots.

    A candidate contains a point where all three barycentric weights are ≥ 0
    and |det| ≥ 1e-14.  Returns (found (..., P), first (..., P) the slot of
    the first containing candidate, 0 if none, w (..., P, 3) its weights)."""
    w, det = _barycentric(tri_xy, points[..., None, :])
    inside = (w >= 0.0).all(dim=-1) & (torch.abs(det) >= _DEG_TOL) & valid
    # argmax returns the first maximal index; a bool tensor is cast first
    first = inside.to(torch.int32).argmax(dim=-1)
    found = inside.any(dim=-1)
    w_sel = torch.gather(w, -2, first[..., None, None].expand(*first.shape, 1, 3))[..., 0, :]
    return found, first, w_sel


class _Finds:
    """``find``/``find_full`` on a locator's ``locate``."""

    def find(self, points: torch.Tensor, return_weights: bool = False):
        """→ (tri_ids (P,), found (P,) bool[, weights (P, 3)])."""
        found, w, _, _, tri = self.locate(points)
        return (tri, found, w) if return_weights else (tri, found)

    def find_full(self, points: torch.Tensor):
        """→ (tri_ids, found, weights, corner node ids (P, 3))."""
        found, w, _, corners, tri = self.locate(points)
        return tri, found, w, corners


class TopKLocator(_Finds):
    """The reference's locator: the k triangles with the nearest centroids,
    tested nearest first; the first containing one wins.

    ``TopKLocator(mesh, k)`` as in tpufem; keyword-only ``dtype`` and
    ``device`` place its tables (float64, the default device).  The k
    candidates are taken in ``jax.lax.top_k``'s order, as tpufem takes
    them: a stable sort of the squared centroid distances, so equal
    distances keep the lower triangle id first (``torch.topk`` orders ties
    otherwise).  A point whose host triangle is not among the k is not
    found, as in the reference.  O(P·T) work and memory: meant for meshes
    below ~10k triangles (refused above 50,000, as tpufem refuses)."""

    def __init__(self, mesh: Mesh, k: int = 10, *, dtype=torch.float64, device=None):
        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

        self.mesh = mesh
        self.k = int(k)
        self.coords = t(mesh.coords)  # (N, 2) node coordinates
        self._centroids = t(mesh.centroids())  # (T, 2)
        self.tri_xy = t(_tri_xy_table(mesh))  # (T, 3, 2) corner coordinates
        self.tris = torch.as_tensor(mesh.tris, dtype=torch.int64, device=device)  # (T, 3)

    @classmethod
    def build(cls, mesh: Mesh, k: int = 10, dtype=torch.float64, device=None) -> "TopKLocator":
        return cls(mesh, k, dtype=dtype, device=device)

    def centroids(self) -> np.ndarray:
        """The mesh's triangle centroids (host NumPy), as tpufem's."""
        return self.mesh.centroids()

    def to(self, device) -> "TopKLocator":
        out = copy.copy(self)
        for f in ("coords", "_centroids", "tri_xy", "tris"):
            setattr(out, f, getattr(self, f).to(device))
        return out

    def candidates(self, points: torch.Tensor) -> torch.Tensor:
        """(..., P, k) triangle ids, nearest centroid first, ties by id."""
        if self.mesh.n_tris > 50_000:
            raise ValueError(
                f"TopKLocator materializes a (P, {self.mesh.n_tris}) distance matrix: beyond "
                "~50k triangles use locator='grid' (GridLocator: same answers, O(P·C) work)")
        d2 = torch.sum((points[..., :, None, :] - self._centroids) ** 2, dim=-1)
        return torch.sort(d2, dim=-1, stable=True).indices[..., : self.k]

    def locate(self, points: torch.Tensor):
        """→ (found, w (..., 3), winner corner xy (..., 3, 2), winner corner
        node ids (..., 3), tri ids (0 where not found))."""
        cand = self.candidates(points)
        found, first, w = _first_containing(self.tri_xy[cand], points,
                                            torch.ones_like(cand, dtype=torch.bool))
        tri = torch.where(found, torch.gather(cand, -1, first[..., None])[..., 0], 0)
        return found, w, self.tri_xy[tri], self.tris[tri], tri


@dataclasses.dataclass(frozen=True)
class GridLocator(_Finds):
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

    def with_cmax(self, c_max: int) -> "GridLocator":
        """The same locator with its candidate lists padded to ``c_max``
        slots of −1 (which never contain a point), so per-mesh tables of one
        width stack on a batch axis."""
        cur = self.cells.shape[1]
        if c_max < cur:
            raise ValueError(f"cannot pad {cur} candidate slots down to {c_max}")
        if c_max == cur:
            return self
        cells = np.concatenate(
            [self.cells, np.full((self.cells.shape[0], c_max - cur), -1, dtype=np.int32)], axis=1)
        rows = _pack_candidate_rows(self.mesh, cells)
        return dataclasses.replace(self, cells=cells, rows=torch.as_tensor(
            rows, dtype=self.rows.dtype, device=self.rows.device))

    def to(self, device) -> "GridLocator":
        return dataclasses.replace(self, rows=self.rows.to(device), origin=self.origin.to(device),
                                   extent=self.extent.to(device), coords=self.coords.to(device))

    def locate(self, points: torch.Tensor):
        """→ (found, w (..., 3), winner corner xy (..., 3, 2), winner corner
        node ids (..., 3), tri ids (0 where not found))."""
        return _locate_winner(self.rows, self.origin, self.extent, self.g, points)


@dataclasses.dataclass(frozen=True)
class BatchedGridLocator:
    """Per-simulation :class:`GridLocator` tables stacked on a batch axis.

    Ensembles with one mesh a simulation (``parallel.spmd.MultiMeshEnsemble``)
    locate each simulation's points in its own mesh.  ``build`` takes one
    grid resolution for the fleet and pads every candidate table to the
    fleet's widest (:meth:`GridLocator.with_cmax`), so the tables stack;
    the packed rows carry everything transport needs per candidate, so the
    meshes may differ in triangle count (node counts agree)."""

    rows: torch.Tensor  # (B, G², 10·C_max)
    origins: torch.Tensor  # (B, 2)
    extents: torch.Tensor  # (B, 2)
    coords: torch.Tensor  # (B, N, 2) per-simulation node coordinates
    g: int

    @classmethod
    def build(cls, meshes, g: int = 0, exact: bool = True, dtype=torch.float64,
              device=None) -> "BatchedGridLocator":
        """``g=0`` takes clip(2·√T_max, 8, 128) cells a side, as tpufem does."""
        if not g:
            g = int(np.clip(2 * np.sqrt(max(m.n_tris for m in meshes)), 8, 128))
        tables = [_bin_triangles(m, g, exact) for m in meshes]
        c_max = max(cells.shape[1] for cells, _, _ in tables)
        rows = [_pack_candidate_rows(m, np.concatenate(
            [cells, np.full((cells.shape[0], c_max - cells.shape[1]), -1, np.int32)], axis=1))
            for m, (cells, _, _) in zip(meshes, tables)]
        return cls.from_tables(np.stack(rows), np.stack([t[1] for t in tables]),
                               np.stack([t[2] for t in tables]),
                               np.stack([m.coords for m in meshes]), g, dtype=dtype, device=device)

    @classmethod
    def from_tables(cls, rows, origins, extents, coords, g: int, dtype=torch.float64,
                    device=None) -> "BatchedGridLocator":
        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

        return cls(rows=t(rows), origins=t(origins), extents=t(extents), coords=t(coords), g=int(g))

    def tables(self, dtype=None) -> tuple:
        """(rows, origins, extents, coords): the first arguments of the
        batched transport functions, cast to ``dtype`` where given (as
        tpufem's ``tables(dtype)``; the default keeps the built dtype)."""
        t = (self.rows, self.origins, self.extents, self.coords)
        return t if dtype is None else tuple(a.to(dtype) for a in t)

    def select(self, index: torch.Tensor, device) -> "BatchedGridLocator":
        """The tables of the simulations ``index`` on ``device``."""
        return dataclasses.replace(self, **{
            f: getattr(self, f)[index.to(getattr(self, f).device)].to(device)
            for f in ("rows", "origins", "extents", "coords")})

    def locate(self, points: torch.Tensor):
        """Points (B, P, 2), one simulation's in each batch entry → as
        :meth:`GridLocator.locate`."""
        return _locate_winner(self.rows, self.origins, self.extents, self.g, points)


def _gather_flat_rows(rows, origin, extent, g: int, points):
    """The packed row of each point's cell: (..., P, 10·C).

    ``rows`` (G², W) is one table for every leading index of ``points``;
    (B, G², W) with ``origin``/``extent`` (B, 2) holds one for each entry of
    points (B, P, 2).  Cell indices truncate toward zero, then clip, as in
    tpufem."""
    stacked = rows.ndim == 3
    if stacked:
        origin, extent = origin[:, None, :], extent[:, None, :]
    ij = torch.clamp(((points - origin) / extent * g).to(torch.int64), 0, g - 1)
    cell = ij[..., 0] * g + ij[..., 1]
    return _take(rows, cell, stacked)


def _locate_winner(rows, origin, extent, g: int, pts):
    """Locate ``pts`` in packed tables (see :func:`_gather_flat_rows`) →
    (found, w (..., 3), win_xy (..., 3, 2), corner node ids (..., 3), tri
    ids), the winner's data straight from its row (tri id and corners 0
    where nothing contains the point)."""
    row = _gather_flat_rows(rows, origin, extent, g, pts)
    c = row.shape[-1] // 10
    sections = row.unflatten(-1, (10, c))  # (..., P, 10, C): x1 y1 x2 y2 x3 y3 id c1 c2 c3
    tri_xy = sections[..., :6, :].unflatten(-2, (3, 2)).movedim(-1, -3)  # (..., P, C, 3, 2)
    found, first, w = _first_containing(tri_xy, pts, sections[..., 6, :] >= 0)
    win = torch.gather(sections, -1, first[..., None, None].expand(*first.shape, 10, 1))[..., 0]
    win_xy = win[..., :6].unflatten(-1, (3, 2))
    ids = win[..., 6:].to(torch.int64)
    return found, w, win_xy, ids[..., 1:], torch.where(found, ids[..., 0], 0)


def interpolate(mesh: Mesh, field: torch.Tensor, points: torch.Tensor, locator):
    """Linear (P1) interpolation of a nodal field (N,) or (N, D) at points.

    Returns (values, found); values are 0 for points outside the mesh."""
    found, w, _, corners, _ = locator.locate(points)
    return _interpolate_at(field, w, corners, found, batched=False)


def _interpolate_at(field, w, corners, found, batched: bool):
    """Σⱼ wⱼ·field[cornerⱼ], 0 where not found.  ``field`` is (N[, D]), or
    (B, N[, D]) with ``batched``."""
    vector = field.ndim > (2 if batched else 1)
    f = field if vector else field[..., None]
    vals = (w[..., 0:1] * _take(f, corners[..., 0], batched)
            + w[..., 1:2] * _take(f, corners[..., 1], batched)
            + w[..., 2:3] * _take(f, corners[..., 2], batched))
    vals = vals if vector else vals[..., 0]
    mask = found[..., None] if vector else found
    return torch.where(mask, vals, 0.0), found


def _periodic_dx(a, b, L=1.0):
    """Shortest periodic x-distance."""
    d = a - b
    d = torch.where(d > 0.5 * L, d - L, d)
    d = torch.where(d < -0.5 * L, d + L, d)
    return d


def advect_semilagrange(
    mesh: Mesh,
    locator,
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
    distances; nodes whose departure point is not found keep their value.
    A leading batch axis on ``c`` (B, N) and ``u`` (B, N, 2) advects B dyes
    through the one ``locator`` in one pass."""
    return _advect(locator.locate, locator.coords, c, u, dt, L, H)


def advect_semilagrange_batched(rows, origins, extents, coords, g: int, c, u, dt: float,
                                L: float = 1.0, H: float = 1.0):
    """:func:`advect_semilagrange` over per-simulation meshes: the tables
    (:meth:`BatchedGridLocator.tables`) carry a leading batch axis, ``c`` is
    (B, N) and ``u`` (B, N, 2).  One pass serves the whole batch."""
    return _advect(lambda p: _locate_winner(rows, origins, extents, g, p), coords, c, u, dt, L, H)


def _advect(locate, coords, c, u, dt, L, H):
    eps = 1e-12
    xb = torch.remainder(coords[..., 0] - dt * u[..., 0], L)
    yb = coords[..., 1] - dt * u[..., 1]
    yb = torch.where(yb < 0.0, eps, yb)
    yb = torch.where(yb > H, H - eps, yb)
    pts = torch.stack([xb, yb], dim=-1)
    found, _, pxy, corner, _ = locate(pts)
    x1, y1 = pxy[..., 0, 0], pxy[..., 0, 1]
    x2, y2 = pxy[..., 1, 0], pxy[..., 1, 1]
    x3, y3 = pxy[..., 2, 0], pxy[..., 2, 1]
    det = _periodic_dx(x2, x1, L) * (y3 - y1) - _periodic_dx(x3, x1, L) * (y2 - y1)
    safe = torch.where(torch.abs(det) < _DEG_TOL, 1.0, det)
    w1 = (_periodic_dx(x2, xb, L) * (y3 - yb) - _periodic_dx(x3, xb, L) * (y2 - yb)) / safe
    w2 = (_periodic_dx(x3, xb, L) * (y1 - yb) - _periodic_dx(x1, xb, L) * (y3 - yb)) / safe
    w3 = 1.0 - w1 - w2
    batched = c.ndim == 2
    c_new = (w1 * _take(c, corner[..., 0], batched) + w2 * _take(c, corner[..., 1], batched)
             + w3 * _take(c, corner[..., 2], batched))
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
    locator,
    points: torch.Tensor,
    u: torch.Tensor,
    dt: float,
    L: float = 1.0,
    method: str = "euler",
) -> torch.Tensor:
    """Advance tracer points one step through nodal velocity u.

    ``euler`` samples u at the point, steps explicitly and wraps x (as the
    reference); ``rk2`` is the midpoint upgrade.  A leading batch axis on
    ``points`` (B, P, 2) and ``u`` (B, N, 2) moves B tracer sets through
    the one ``locator`` in one pass."""
    return _tracers(locator.locate, points, u, dt, L, method)


def tracer_step_batched(rows, origins, extents, g: int, points, u, dt: float, L: float = 1.0,
                        method: str = "euler"):
    """:func:`tracer_step` over per-simulation meshes: ``points`` (B, P, 2),
    ``u`` (B, N, 2) → new points (B, P, 2), one pass for the batch."""
    return _tracers(lambda p: _locate_winner(rows, origins, extents, g, p), points, u, dt, L,
                    method)


def _tracers(locate, points, u, dt, L, method):
    batched = u.ndim == 3

    def velocity(p):
        found, w, _, corners, _ = locate(p)
        return _interpolate_at(u, w, corners, found, batched)[0]

    def wrap(p):
        return torch.stack([torch.remainder(p[..., 0], L), p[..., 1]], dim=-1)

    vel = velocity(points)
    if method == "rk2":
        vel = velocity(wrap(points + 0.5 * dt * vel))
    return wrap(points + dt * vel)


def capture_update(
    points: torch.Tensor,
    status: torch.Tensor,
    center=(0.5, 0.5),
    radius: float = 0.28,
) -> torch.Tensor:
    """Mark tracers within ``radius`` of ``center`` as eaten (status=1)."""
    dx = points[..., 0] - center[0]
    dy = points[..., 1] - center[1]
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
