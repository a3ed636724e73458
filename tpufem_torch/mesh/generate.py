"""Built-in mesh generation (no external Triangle binary required).

A unit square, optionally with a circular hole (the squirmer domain), with
left/right boundary nodes at matching y so periodic-in-x pairing is exact.
Same generators as ``tpufem.mesh.generate``.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay, cKDTree

from tpufem_torch.mesh.core import Mesh, mesh_from_arrays


def generate_rect_mesh(nx: int = 20, ny: int = 20, L: float = 1.0, H: float = 1.0) -> Mesh:
    """Structured triangulation of [0,L]×[0,H]; boundary nodes marker=1."""
    xs = np.linspace(0.0, L, nx)
    ys = np.linspace(0.0, H, ny)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    coords = np.stack([gx.ravel(), gy.ravel()], axis=1)

    def nid(i, j):
        return i * ny + j

    tris = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            a, b, c, d = nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)
            tris.append((a, b, c))
            tris.append((a, c, d))
    tris = np.asarray(tris, dtype=np.int32)

    on_boundary = (
        np.isclose(coords[:, 0], 0.0)
        | np.isclose(coords[:, 0], L)
        | np.isclose(coords[:, 1], 0.0)
        | np.isclose(coords[:, 1], H)
    )
    markers = np.where(on_boundary, 1, 0).astype(np.int32)
    return mesh_from_arrays(coords, tris, markers)


def _assign_ring_slots(
    dummy_pts: np.ndarray, ring: np.ndarray, dummy_ids: np.ndarray
) -> np.ndarray:
    """Injective nearest-dummy-slot assignment for the ring nodes.

    Greedy: each ring node claims its closest still-unused hole-interior
    grid slot (k-nearest fallback keeps it injective)."""
    if len(ring) > len(dummy_pts):
        raise ValueError(
            f"pad_hole ring-in-grid numbering needs one hole-interior grid "
            f"slot per ring node, but n_circle={len(ring)} > "
            f"{len(dummy_pts)} interior slots — increase n_side or reduce "
            f"n_circle (slots grow ~π·(r/h)² with h = L/(n_side−1))"
        )
    tree = cKDTree(dummy_pts)
    k = min(len(dummy_pts), 24)
    _, cand = tree.query(ring, k=k)
    cand = np.atleast_2d(cand)
    used = np.zeros(len(dummy_pts), dtype=bool)
    slots = np.empty(len(ring), dtype=np.int64)
    for i in range(len(ring)):
        for j in cand[i]:
            if not used[j]:
                used[j] = True
                slots[i] = j
                break
        else:  # extremely dense ring: fall back to global nearest unused
            free = np.nonzero(~used)[0]
            d = np.linalg.norm(dummy_pts[free] - ring[i], axis=1)
            j = free[np.argmin(d)]
            used[j] = True
            slots[i] = j
    return dummy_ids[slots]


def generate_annulus_mesh(
    n_side: int = 24,
    n_circle: int = 32,
    L: float = 1.0,
    H: float = 1.0,
    center: tuple[float, float] = (0.5, 0.5),
    radius: float = 0.25,
    outer_marker: int = 1,
    inner_marker: int = 2,
    jitter: float = 0.0,
    seed: int = 0,
    pad_hole: bool = False,
) -> Mesh:
    """Unit square with a circular hole: the squirmer domain.

    Outer marker 1, inner circle marker 2, hole at ``center``.  Left/right
    boundary nodes share identical y grids so periodic pairing is exact.

    ``pad_hole=True`` keeps the grid points inside the hole as inert dummy
    nodes (marker −1, no incident triangles) and renumbers the ring nodes
    into nearby dummy slots, so every node id is a grid id (N = n_side²)
    and every operator coupling is a bounded 2-D grid offset.
    """
    cx, cy = center
    xs = np.linspace(0.0, L, n_side)
    ys = np.linspace(0.0, H, n_side)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
    pts_ideal = pts.copy()

    if jitter > 0:
        rng = np.random.default_rng(seed)
        interior = (
            (pts[:, 0] > 0) & (pts[:, 0] < L) & (pts[:, 1] > 0) & (pts[:, 1] < H)
        )
        h = L / (n_side - 1)
        pts[interior] += rng.uniform(-jitter * h, jitter * h, size=(interior.sum(), 2))

    # drop grid points inside (or too close to) the hole, add an exact ring
    if pad_hole:
        # absolute exclusion margin of ~0.7 cells, from the IDEAL grid so
        # jittered meshes share identical boundary index sets
        h = L / (n_side - 1)
        d = np.hypot(pts_ideal[:, 0] - cx, pts_ideal[:, 1] - cy)
        keep = d > radius + 0.7 * h
    else:
        d = np.hypot(pts[:, 0] - cx, pts[:, 1] - cy)
        keep = d > radius * 1.18
    kept_ids = np.nonzero(keep)[0]
    theta = np.linspace(0.0, 2 * np.pi, n_circle, endpoint=False)
    ring = np.stack([cx + radius * np.cos(theta), cy + radius * np.sin(theta)], axis=1)

    if pad_hole:
        dummy_ids = np.nonzero(~keep)[0]
        ring_slots = _assign_ring_slots(pts_ideal[dummy_ids], ring, dummy_ids)
        coords = pts.copy()
        coords[ring_slots] = ring
        active = np.concatenate([kept_ids, ring_slots])
        tri = Delaunay(coords[active])
        simplices = active[tri.simplices].astype(np.int32)
        ring_ids = ring_slots
    else:
        pts = pts[keep]
        coords = np.concatenate([pts, ring], axis=0)
        tri = Delaunay(coords)
        simplices = tri.simplices.astype(np.int32)
        ring_ids = np.arange(len(pts), len(coords))

    # remove triangles whose centroid lies inside the hole
    cent = coords[simplices].mean(axis=1)
    outside = np.hypot(cent[:, 0] - cx, cent[:, 1] - cy) > radius
    simplices = simplices[outside]

    markers = np.zeros(coords.shape[0], dtype=np.int32)
    if pad_hole:
        markers[np.nonzero(~keep)[0]] = -1  # inert dummy nodes
    on_outer = (
        np.isclose(coords[:, 0], 0.0)
        | np.isclose(coords[:, 0], L)
        | np.isclose(coords[:, 1], 0.0)
        | np.isclose(coords[:, 1], H)
    )
    markers[on_outer] = outer_marker
    markers[ring_ids] = inner_marker
    holes = np.asarray([[cx, cy]])
    return mesh_from_arrays(coords, simplices, markers, holes=holes)
