"""The benchmark's frozen copy of the squirmer-domain mesh generator.

A unit square with a circular hole, Delaunay-triangulated from a regular
grid, with left/right boundary nodes at matching y so that periodic-in-x
pairing is exact.  With ``pad_hole=True`` the grid points inside the hole
stay as inert dummy nodes (marker -1, in no triangle) and the ring nodes
take nearby dummy slots, so N = n_side² and every node id is a grid id.

This copy is part of the yardstick: the benchmark makes its meshes here and
hands the same arrays to the program and to the plain reference, so a later
change to the program's own generator cannot change the inputs.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay, cKDTree


def _assign_ring_slots(dummy_pts: np.ndarray, ring: np.ndarray,
                       dummy_ids: np.ndarray) -> np.ndarray:
    """Injective nearest-dummy-slot assignment: each ring node in turn
    claims its closest still-unused hole-interior grid slot."""
    if len(ring) > len(dummy_pts):
        raise ValueError(f"n_circle={len(ring)} ring nodes need as many hole-interior grid "
                         f"slots; the grid has {len(dummy_pts)}")
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
        else:
            free = np.nonzero(~used)[0]
            d = np.linalg.norm(dummy_pts[free] - ring[i], axis=1)
            j = free[np.argmin(d)]
            used[j] = True
            slots[i] = j
    return dummy_ids[slots]


def annulus(n_side: int, n_circle: int, pad_hole: bool = True, L: float = 1.0,
            H: float = 1.0, center=(0.5, 0.5), radius: float = 0.25,
            outer_marker: int = 1, inner_marker: int = 2):
    """(coords (N, 2) float64, tris (T, 3) int32, markers (N,) int32) of the
    squirmer domain: outer marker on the square's sides, inner marker on the
    ring of ``n_circle`` nodes at ``radius`` about ``center``."""
    cx, cy = center
    xs = np.linspace(0.0, L, n_side)
    ys = np.linspace(0.0, H, n_side)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)

    if pad_hole:
        h = L / (n_side - 1)
        keep = np.hypot(pts[:, 0] - cx, pts[:, 1] - cy) > radius + 0.7 * h
    else:
        keep = np.hypot(pts[:, 0] - cx, pts[:, 1] - cy) > radius * 1.18
    kept_ids = np.nonzero(keep)[0]
    theta = np.linspace(0.0, 2 * np.pi, n_circle, endpoint=False)
    ring = np.stack([cx + radius * np.cos(theta), cy + radius * np.sin(theta)], axis=1)

    if pad_hole:
        dummy_ids = np.nonzero(~keep)[0]
        ring_ids = _assign_ring_slots(pts[dummy_ids], ring, dummy_ids)
        coords = pts.copy()
        coords[ring_ids] = ring
        active = np.concatenate([kept_ids, ring_ids])
        simplices = active[Delaunay(coords[active]).simplices].astype(np.int32)
    else:
        coords = np.concatenate([pts[keep], ring], axis=0)
        simplices = Delaunay(coords).simplices.astype(np.int32)
        ring_ids = np.arange(len(kept_ids), len(coords))

    cent = coords[simplices].mean(axis=1)
    simplices = simplices[np.hypot(cent[:, 0] - cx, cent[:, 1] - cy) > radius]

    markers = np.zeros(coords.shape[0], dtype=np.int32)
    if pad_hole:
        markers[~keep] = -1
    on_outer = (np.isclose(coords[:, 0], 0.0) | np.isclose(coords[:, 0], L)
                | np.isclose(coords[:, 1], 0.0) | np.isclose(coords[:, 1], H))
    markers[on_outer] = outer_marker
    markers[ring_ids] = inner_marker
    return coords, simplices, markers
