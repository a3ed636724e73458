"""Grid-numbering check for the scale regime's grid storage.

The counterpart of ``tpufem.mesh.gridify`` as far as this port goes: the
check of whether a mesh's numbering is already grid-structured (true for
``generate_annulus_mesh(pad_hole=True)``).  Renumbering an arbitrary mesh
onto a raster (``gridify_mesh``) is not ported yet.
"""

from __future__ import annotations

import numpy as np

from tpufem_torch.mesh.core import Mesh


def grid_numbering_ok(mesh: Mesh, max_offsets: int = 24, rest_cap: int | None = None) -> bool:
    """True iff N = ns² and the top ``max_offsets`` (dy, s) grid offsets of
    the triangle adjacency leave at most ``rest_cap`` couplings uncovered
    (the criterion :class:`~tpufem_torch.ops.gridop.GridOperator` applies)."""
    n = mesh.n_nodes
    ns = int(round(np.sqrt(n)))
    if ns * ns != n:
        return False
    tris = np.asarray(mesh.tris, dtype=np.int64)
    a = np.repeat(tris, 3, axis=1).ravel()
    b = np.tile(tris, (1, 3)).ravel()
    pairs = np.unique(a * np.int64(n) + b)
    rows, cols = np.divmod(pairs, np.int64(n))
    iy, ix = np.divmod(rows, ns)
    jy, jx = np.divmod(cols, ns)
    key = (jy - iy) * ns + (jx - ix) % ns
    _, counts = np.unique(key, return_counts=True)
    counts = np.sort(counts)[::-1]
    rest = int(counts[max_offsets:].sum())
    cap = rest_cap if rest_cap is not None else max(4096, n // 8)
    return rest <= cap


def ensure_grid_numbering(mesh: Mesh, L: float = 1.0, H: float = 1.0, tol: float = 1e-6):
    """(mesh, None) when the numbering already fits the grid storage.  A
    mesh that would need renumbering raises: ``gridify_mesh`` is not
    ported yet."""
    if grid_numbering_ok(mesh):
        return mesh, None
    raise NotImplementedError(
        "renumbering a mesh onto a grid raster (gridify_mesh) is not ported to "
        "tpufem_torch yet (ROADMAP Queue 1 item 5); use a "
        "generate_annulus_mesh(pad_hole=True) mesh or cg_storage='csr'")
