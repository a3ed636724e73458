"""P1 → P2 mesh refinement: edge-midpoint nodes for Taylor–Hood, the
counterpart of ``tpufem.mesh.p2`` (host NumPy, array-equal to it).

Triangle's P2 node order is kept: corners 1–3, then the midpoints
*opposite* each corner (midpoint k between corners k+1 and k+2), the order
the Taylor–Hood element matrices assume.

A midpoint takes marker m > 0 only when its edge is a boundary edge (in
exactly one triangle) and both endpoints carry m: chords between two
boundary nodes stay unmarked.  ``snap_center``/``snap_radius`` move the
inner-circle midpoints onto the circle (a chord's midpoint lies inside it).
"""

from __future__ import annotations

import numpy as np

from tpufem_torch.mesh.core import Mesh, mesh_from_arrays


def p2_refine(
    mesh: Mesh,
    inner_marker: int = 2,
    snap_center: tuple[float, float] | None = None,
    snap_radius: float = 0.0,
) -> Mesh:
    """A new Mesh whose ``tris_p2`` carries the corners and edge midpoints."""
    tris = np.asarray(mesh.tris, dtype=np.int64)
    n = mesh.n_nodes
    t = tris.shape[0]

    # canonical edge keys (min, max) of the 3 edges opposite each corner
    ea = tris[:, [1, 2, 0]]
    eb = tris[:, [2, 0, 1]]
    key = np.minimum(ea, eb) * np.int64(n) + np.maximum(ea, eb)  # (T, 3)
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    inv = inv.reshape(t, 3)
    elo, ehi = np.divmod(uniq, np.int64(n))

    mid = 0.5 * (mesh.coords[elo] + mesh.coords[ehi])
    m_lo = mesh.markers[elo]
    on_boundary = counts == 1
    mid_markers = np.where(on_boundary & (m_lo == mesh.markers[ehi]) & (m_lo > 0),
                           m_lo, 0).astype(np.int32)

    if snap_center is not None and snap_radius > 0:
        sel = mid_markers == inner_marker
        d = mid[sel] - np.asarray(snap_center)
        r = np.hypot(d[:, 0], d[:, 1])
        mid[sel] = np.asarray(snap_center) + d * (snap_radius / r)[:, None]

    coords = np.concatenate([mesh.coords, mid], axis=0)
    markers = np.concatenate([mesh.markers, mid_markers])
    tris6 = np.concatenate([tris, n + inv], axis=1).astype(np.int32)
    return mesh_from_arrays(coords, tris6, markers, holes=mesh.holes)
