"""Geometric grid renumbering: make any mesh ready for the grid kernels.

The counterpart of ``tpufem.mesh.gridify``, host NumPy, array-equal to it.
The grid storage (``ops/gridop.py``, kernels K2/K3/K5) needs a
grid-structured numbering: N = ns² node ids laid out so that node id =
row·ns + lane with (row, lane) tracking (x, y), which makes every operator
coupling a small 2-D grid offset.  ``generate_annulus_mesh(pad_hole=True)``
meshes have it; this module gives it to any other mesh by assigning every
node to a slot of an ns×ns raster:

* **rows** (grid axis 0 ↔ x): each node targets its geometric row
  ⌊x/L·ns⌋ and is displaced only as far as the ≤ ns-per-row capacity
  requires; x≈0 nodes are pinned to row 0 and x≈L nodes to row ns−1, so
  the periodic pairs sit on opposite grid edges, as the pressure kernels
  need (masters row 0, slaves row ns−1, matching lanes);
* **lanes** (grid axis 1 ↔ y): within each row, nodes sorted by y take the
  lane nearest ⌊y/H·ns⌋ under a strictly increasing constraint, so lanes
  stay aligned across rows and the lane offsets of mesh edges stay small;
* **slaves copy their master's lane**;
* unfilled slots become inert dummy nodes (marker −1, no incident
  triangles, zero operator rows) with coordinates clamped strictly inside
  the domain, so coordinate-based boundary discovery never picks them up.

A strongly graded mesh may spread its couplings over more offsets than
:class:`~tpufem_torch.ops.gridop.GridOperator` takes; its build then raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpufem_torch.mesh.core import Mesh, mesh_from_arrays


class GridifyError(ValueError):
    """The mesh cannot be given a grid-compatible numbering."""


@dataclasses.dataclass(frozen=True)
class Gridified:
    """A renumbered mesh plus the old → new node permutation."""

    mesh: Mesh  # N = ns² nodes (dummy-padded), grid-structured numbering
    perm: np.ndarray  # (N_old,) old node id → new node id
    ns: int

    def push(self, field: np.ndarray) -> np.ndarray:
        """Scatter an (N_old, ...) nodal field to the (ns², ...) layout."""
        out = np.zeros((self.ns * self.ns,) + field.shape[1:], field.dtype)
        out[self.perm] = field
        return out

    def pull(self, field: np.ndarray) -> np.ndarray:
        """Gather an (ns², ...) nodal field back to the original order."""
        return np.asarray(field)[self.perm]


def _monotone_lanes(t: np.ndarray, ns: int) -> np.ndarray:
    """Strictly increasing lanes nearest the (sorted) targets t.

    m_i = max_{j≤i}(t_j − j) is the smallest non-decreasing envelope that
    makes lanes = m + arange strictly increasing; capping m at ns−k keeps
    every lane < ns and the order."""
    k = len(t)
    if k == 0:
        return np.zeros(0, dtype=np.int64)
    idx = np.arange(k)
    m = np.maximum.accumulate(t - idx)
    return np.minimum(m, ns - k) + idx


def _capacity_rows(t: np.ndarray, cap: int, top: int) -> np.ndarray:
    """Monotone rows at least the targets ``t`` (sorted), at most ``cap``
    to a row and at most ``top``: a forward sweep r_i = max(t_i,
    r_{i−cap}+1) to its fixpoint, then a backward one r_i ≤ r_{i+cap}−1."""
    r = t.copy()
    while True:
        upd = np.maximum(r[cap:], r[:-cap] + 1)
        if (upd == r[cap:]).all():
            break
        r[cap:] = upd
        np.maximum.accumulate(r, out=r)  # keep monotone between passes
    r = np.minimum(r, top)
    while True:
        upd = np.minimum(r[:-cap], r[cap:] - 1)
        if (upd == r[:-cap]).all():
            break
        r[:-cap] = upd
        r = np.minimum.accumulate(r[::-1])[::-1]  # monotone from the back
    return r


def gridify_points(coords: np.ndarray, L: float = 1.0, H: float = 1.0,
                   ns: int | None = None) -> tuple[np.ndarray, int]:
    """(perm, ns): raster numbering for a bare point cloud, ``perm[old_id] =
    row·ns + lane``.

    The non-periodic core of :func:`gridify_mesh` (capacity-constrained
    geometric rows, monotone geometric lanes) without the edge pinning and
    the periodic pairs; for dof spaces that are not P1 mesh nodes (the
    Taylor–Hood P2 velocity and P1 pressure dofs)."""
    coords = np.asarray(coords)
    n = coords.shape[0]
    x, y = coords[:, 0], coords[:, 1]
    if ns is None:
        ns = int(np.ceil(np.sqrt(n)))
    if ns * ns < n:
        raise GridifyError(f"{n} points do not fit an {ns}×{ns} raster")

    order = np.lexsort((y, x))
    t = np.clip((x[order] / L * ns).astype(np.int64), 0, ns - 1)
    r = _capacity_rows(t, ns, ns - 1)
    if r[0] < 0 or (np.bincount(r, minlength=ns) > ns).any():
        raise GridifyError("infeasible capacity-constrained row assignment "
                           "(n > ns² should be impossible here)")
    row = np.empty(n, dtype=np.int64)
    row[order] = r

    lane = np.empty(n, dtype=np.int64)
    for rr in np.unique(row):
        ids = np.nonzero(row == rr)[0]
        o = ids[np.argsort(y[ids], kind="stable")]
        tgt = np.clip((y[o] / H * ns).astype(np.int64), 0, ns - 1)
        lane[o] = _monotone_lanes(tgt, ns)

    perm = row * ns + lane
    if len(np.unique(perm)) != n:
        raise GridifyError("internal error: non-injective slot assignment")
    return perm.astype(np.int64), ns


def gridify_mesh(mesh: Mesh, L: float = 1.0, H: float = 1.0, tol: float = 1e-6) -> Gridified:
    """Renumber ``mesh`` onto an ns×ns raster (see the module docstring)."""
    from tpufem_torch.bc import find_periodic_pairs

    coords = np.asarray(mesh.coords)
    n = mesh.n_nodes
    x, y = coords[:, 0], coords[:, 1]
    left = np.abs(x) < tol
    right = np.abs(x - L) < tol
    n_left, n_right = int(left.sum()), int(right.sum())

    ns = max(int(np.ceil(np.sqrt(n))), n_left, n_right)
    n_mid = n - n_left - n_right  # the middle rows hold them at ≤ ns a row
    while max(ns - 2, 1) * ns < n_mid:
        ns += 1

    row = np.empty(n, dtype=np.int64)
    lane = np.empty(n, dtype=np.int64)
    row[left] = 0
    row[right] = ns - 1
    mid = np.nonzero(~(left | right))[0]
    if len(mid):
        order = mid[np.lexsort((y[mid], x[mid]))]
        t = np.clip((x[order] / L * ns).astype(np.int64), 1, ns - 2)
        r = _capacity_rows(t, ns, ns - 2)
        if r[0] < 1 or (np.bincount(r, minlength=ns) > ns).any():
            raise GridifyError("internal error: infeasible capacity-constrained row "
                               "assignment (n_mid > (ns-2)*ns should be impossible)")
        row[order] = r

    def assign_row_lanes(ids: np.ndarray):
        o = ids[np.argsort(y[ids], kind="stable")]
        t = np.clip((y[o] / H * ns).astype(np.int64), 0, ns - 1)
        lane[o] = _monotone_lanes(t, ns)

    for r in range(1, ns - 1):
        assign_row_lanes(np.nonzero(row == r)[0])
    assign_row_lanes(np.nonzero(left)[0])

    # row ns−1: periodic slaves take their master's lane (the pressure
    # solve's roll-based merge needs it); unpaired x≈L nodes (wall corners)
    # take the nearest free lanes
    masters, slaves = find_periodic_pairs(coords, L=L, H=H, tol=tol)
    if len(slaves) != len(set(int(s) for s in slaves)):
        raise GridifyError(
            "periodic nearest-y matching is not injective on this mesh (two x≈0 nodes "
            "share an x≈L partner): the grid pressure solve cannot represent it; use "
            "cg_storage='csr'")
    right_ids = np.nonzero(right)[0]
    if n_right:
        taken = np.zeros(ns, dtype=bool)
        lane[slaves] = lane[masters]
        taken[lane[slaves]] = True
        unpaired = np.setdiff1d(right_ids, slaves)
        free = np.nonzero(~taken)[0]
        if len(unpaired):
            o = unpaired[np.argsort(y[unpaired], kind="stable")]
            t = np.clip((y[o] / H * ns).astype(np.int64), 0, ns - 1)
            for i, target in zip(o, t):  # greedy nearest free lane, y-ordered
                j = int(np.argmin(np.abs(free - target)))
                lane[i] = free[j]
                free = np.delete(free, j)

    new_id = row * ns + lane
    if len(np.unique(new_id)) != n:  # a broken invariant would corrupt the operator
        raise GridifyError("internal error: non-injective slot assignment")

    n_new = ns * ns
    new_coords = np.empty((n_new, 2))
    # dummy coordinates: nominal slot centres clamped strictly inside the domain
    rr, ll = np.divmod(np.arange(n_new), ns)
    pad = 1.0 / (2.0 * ns)
    new_coords[:, 0] = np.clip(rr / max(ns - 1, 1) * L, pad * L, (1 - pad) * L)
    new_coords[:, 1] = np.clip(ll / max(ns - 1, 1) * H, pad * H, (1 - pad) * H)
    new_coords[new_id] = coords
    new_markers = np.full(n_new, -1, dtype=np.int32)
    new_markers[new_id] = mesh.markers
    perm = new_id.astype(np.int64)
    new_mesh = mesh_from_arrays(new_coords, perm[mesh.tris].astype(np.int32), new_markers,
                                holes=mesh.holes)
    return Gridified(mesh=new_mesh, perm=perm, ns=ns)


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


def ensure_grid_numbering(mesh: Mesh, L: float = 1.0, H: float = 1.0,
                          tol: float = 1e-6) -> tuple[Mesh, Gridified | None]:
    """(mesh, gridified): the mesh unchanged and None when its numbering
    already fits the grid storage (``generate_annulus_mesh(pad_hole=True)``),
    else the renumbered mesh and its :class:`Gridified`."""
    if grid_numbering_ok(mesh):
        return mesh, None
    g = gridify_mesh(mesh, L=L, H=H, tol=tol)
    return g.mesh, g
