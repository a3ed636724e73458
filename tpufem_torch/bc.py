"""Boundary conditions as data: index maps, masks and value vectors.

Discovery and matrix surgery run once at set-up on host NumPy arrays;
application to fields on the device is an indexed copy.  Same semantics as
``tpufem.bc``:

* periodic pair discovery (left/right columns, nearest-y matching),
* periodic enforcement by ±1e10 penalty, field copy, master/slave row
  elimination (dense, and on CSR with Dirichlet rows in one pass) and
  DOF-merge relabeling,
* Dirichlet row-only and symmetric row+column surgery,
* squirmer tangential slip and rotating-cylinder surface velocities.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufem_torch.mesh.core import Mesh

PENALTY = 1.0e10  # the reference's periodic penalty


def find_periodic_pairs(
    coords: np.ndarray,
    L: float = 1.0,
    H: float = 1.0,
    tol: float = 1e-6,
    exclude_walls: bool = True,
):
    """(masters, slaves) index arrays pairing x≈0 nodes with x≈L nodes.

    For each left node, the right node with nearest y becomes its slave.
    ``exclude_walls`` drops pairs whose master sits on y≈0 or y≈H."""
    coords = np.asarray(coords)
    left = np.nonzero(np.abs(coords[:, 0]) < tol)[0]
    right = np.nonzero(np.abs(coords[:, 0] - L) < tol)[0]
    if len(left) == 0 or len(right) == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    dy = np.abs(coords[left, 1][:, None] - coords[right, 1][None, :])
    slaves = right[np.argmin(dy, axis=1)]
    masters = left
    if exclude_walls:
        my = coords[masters, 1]
        keep = ~((np.abs(my - 0.0) < tol) | (np.abs(my - H) < tol))
        masters, slaves = masters[keep], slaves[keep]
    return masters.astype(np.int32), slaves.astype(np.int32)


def apply_periodic_field(u: torch.Tensor, masters: torch.Tensor, slaves: torch.Tensor) -> torch.Tensor:
    """u[slave] ← u[master], out of place."""
    return u.index_put((slaves,), u[masters])


def apply_dirichlet_field(u: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """u[idx] ← values (a tensor broadcastable to ``u[idx]``), out of place."""
    return u.index_put((idx,), torch.as_tensor(values, dtype=u.dtype, device=u.device))


def dirichlet_rows(A: np.ndarray, idx) -> np.ndarray:
    """Zero rows, unit diagonal (the non-symmetric variant; host set-up)."""
    A = np.array(A, dtype=np.float64)
    idx = np.asarray(idx, dtype=np.int64)
    A[idx, :] = 0.0
    A[idx, idx] = 1.0
    return A


def dirichlet_rows_cols(A: np.ndarray, idx) -> np.ndarray:
    """Zero rows *and* columns, unit diagonal (host set-up).

    Like the reference, the eliminated column is NOT lifted into the RHS."""
    A = np.array(A, dtype=np.float64)
    idx = np.asarray(idx, dtype=np.int64)
    A[idx, :] = 0.0
    A[:, idx] = 0.0
    A[idx, idx] = 1.0
    return A


def periodic_penalty(A: np.ndarray, masters, slaves, penalty: float = PENALTY) -> np.ndarray:
    """Symmetric ±penalty coupling of each master/slave pair (host set-up);
    repeated indices accumulate."""
    A = np.array(A, dtype=np.float64)
    m = np.asarray(masters, dtype=np.int64)
    s = np.asarray(slaves, dtype=np.int64)
    np.add.at(A, (m, m), penalty)
    np.add.at(A, (s, s), penalty)
    np.add.at(A, (m, s), -penalty)
    np.add.at(A, (s, m), -penalty)
    return A


def periodic_penalty_device(A: torch.Tensor, masters: torch.Tensor, slaves: torch.Tensor,
                            penalty: float = PENALTY) -> torch.Tensor:
    """:func:`periodic_penalty` of a matrix that lives on the device (one
    rebuilt every step), out of place; ``masters``/``slaves`` are int64
    index tensors on its device, and repeated indices accumulate."""
    rows = torch.cat([masters, slaves, masters, slaves])
    cols = torch.cat([masters, slaves, slaves, masters])
    k = len(masters)
    vals = torch.full((4 * k,), penalty, dtype=A.dtype, device=A.device)
    vals[2 * k:] = -penalty
    return A.index_put((rows, cols), vals, accumulate=True)


def periodic_elimination(A: np.ndarray, b: np.ndarray, masters, slaves):
    """Master/slave row elimination (host set-up): each slave row is added
    into its master row, then replaced by the constraint x_s − x_m = 0.

    The pairs are processed one after the other: the nearest-y matching is
    not always injective, and a later pair then sees the slave row an
    earlier pair rewrote.  Returns float64 copies ``(A, b)``."""
    A = np.array(A, dtype=np.float64)
    b = np.array(b, dtype=np.float64)
    for m, s in zip(np.asarray(masters), np.asarray(slaves)):
        A[m, :] += A[s, :]
        b[m] += b[s]
        A[s, :] = 0.0
        A[s, s] = 1.0
        A[s, m] = -1.0
        b[s] = 0.0
    return A, b


def bc_surgery_csr(K, masters, slaves, dirichlet, b=None):
    """Row-only BC surgery on a ``CSROperator``: the operator
    :func:`periodic_elimination` then :func:`dirichlet_rows` make of the
    same matrix, in O(nnz) host work.

    Master rows are summed with their slave rows, slave rows replaced by the
    constraint x_s − x_m = 0, Dirichlet rows by identity (their values enter
    through the caller's right-hand side); Dirichlet wins where a row is
    both.  The periodic matching must be injective: a repeated slave needs
    the dense path's sequential semantics, and raises ``AssertionError``.

    Returns ``(K_mod, b_mod)``: ``K_mod`` float64 on ``K``'s device;
    ``b`` (optional, a tensor) gets the matching row treatment in its own
    dtype and device, repeated masters accumulating."""
    from tpufem_torch.ops.sparse import csr_from_coo

    masters = np.asarray(masters, dtype=np.int64)
    slaves = np.asarray(slaves, dtype=np.int64)
    dirichlet = np.asarray(dirichlet, dtype=np.int64)
    if len(np.unique(slaves)) != len(slaves):
        raise AssertionError("bc_surgery_csr requires injective periodic matching "
                             "(use the dense path for meshes with duplicated pairs)")
    n = K.shape[0]
    rows = np.asarray(K.row_ids, dtype=np.int64)
    cols = np.asarray(K.indices, dtype=np.int64)
    data = K.data.detach().cpu().to(torch.float64).numpy()

    master_of = np.full(n, -1, dtype=np.int64)
    master_of[slaves] = masters
    is_slave = np.zeros(n, dtype=bool)
    is_slave[slaves] = True
    is_diri = np.zeros(n, dtype=bool)
    is_diri[dirichlet] = True

    # A[m, :] += A[s, :], except into masters that are Dirichlet rows
    sel = is_slave[rows]
    add_rows = master_of[rows[sel]]
    keep_add = ~is_diri[add_rows]
    # original rows survive unless slave or Dirichlet
    keep = ~(is_slave[rows] | is_diri[rows])
    # constraint rows x_s − x_m = 0 where the slave is not a Dirichlet row
    cs = slaves[~is_diri[slaves]]
    cm = master_of[cs]
    ones = np.ones(len(cs))
    K_mod = csr_from_coo(
        np.concatenate([rows[keep], add_rows[keep_add], cs, cs, dirichlet]),
        np.concatenate([cols[keep], cols[sel][keep_add], cs, cm, dirichlet]),
        np.concatenate([data[keep], data[sel][keep_add], ones, -ones, np.ones(len(dirichlet))]),
        (n, n), sum_duplicates=True, device=K.data.device,
    )
    if b is None:
        return K_mod, None
    b_np = b.detach().cpu().numpy().copy()
    np.add.at(b_np, masters, b_np[slaves])  # repeated masters accumulate
    b_np[slaves] = 0.0
    return K_mod, torch.as_tensor(b_np, dtype=b.dtype, device=b.device)


def periodic_relabel_tris(tris: np.ndarray, masters, slaves) -> np.ndarray:
    """DOF merge: slave node ids rewritten to their masters in the
    connectivity, so assembly yields an exactly periodic, symmetric
    operator."""
    remap = np.arange(tris.max() + 1, dtype=np.int32)
    remap[np.asarray(slaves)] = np.asarray(masters)
    return remap[tris]


def squirmer_values(
    coords: np.ndarray,
    idx: np.ndarray,
    center=(0.5, 0.5),
    B1: float = -2.0,
    B2: float = 0.0,
) -> np.ndarray:
    """(k, 2) squirmer surface velocities for nodes ``idx``.

    v_t(θ) = B1 sinθ + B2 sin2θ along the unit tangent (−sinθ, cosθ).
    B2 < 0 pusher, > 0 puller, 0 neutral."""
    p = np.asarray(coords)[np.asarray(idx)]
    theta = np.arctan2(p[:, 1] - center[1], p[:, 0] - center[0])
    v_t = B1 * np.sin(theta) + B2 * np.sin(2.0 * theta)
    return np.stack([v_t * -np.sin(theta), v_t * np.cos(theta)], axis=1)


def rotating_cylinder_values(
    coords: np.ndarray, idx: np.ndarray, center=(0.5, 0.5), omega: float = 5.0
) -> np.ndarray:
    """(k, 2) solid-rotation surface velocities ω·(−r_y, r_x)."""
    p = np.asarray(coords)[np.asarray(idx)]
    rx = p[:, 0] - center[0]
    ry = p[:, 1] - center[1]
    return omega * np.stack([-ry, rx], axis=1)


@dataclasses.dataclass(frozen=True)
class ChannelBoundary:
    """Host index sets of the periodic channel with an inner body.

    walls:      nodes with y≈0 or y≈H   (Dirichlet)
    inner:      nodes with the inner-body marker (Dirichlet, e.g. squirmer)
    dirichlet:  union of the above
    interior:   complement of dirichlet
    masters / slaves: periodic x-pairs (wall pairs excluded)
    """

    walls: np.ndarray
    inner: np.ndarray
    dirichlet: np.ndarray
    interior: np.ndarray
    masters: np.ndarray
    slaves: np.ndarray

    @classmethod
    def build(
        cls,
        mesh: Mesh,
        inner_marker: int = 2,
        L: float = 1.0,
        H: float = 1.0,
        tol: float = 1e-6,
        periodic: bool = True,
        all_walls: bool = False,
    ) -> "ChannelBoundary":
        """``all_walls=True`` makes every non-inner marked node a Dirichlet
        wall and disables periodicity (the enclosed box)."""
        coords = mesh.coords
        walls = np.nonzero(
            np.isclose(coords[:, 1], 0.0, atol=tol) | np.isclose(coords[:, 1], H, atol=tol)
        )[0].astype(np.int32)
        inner = np.nonzero(mesh.markers == inner_marker)[0].astype(np.int32)
        if all_walls:
            periodic = False
            marked = np.nonzero(mesh.markers != 0)[0].astype(np.int32)
            walls = np.setdiff1d(marked, inner).astype(np.int32)
        dirichlet = np.union1d(walls, inner).astype(np.int32)
        interior = np.setdiff1d(np.arange(mesh.n_nodes, dtype=np.int32), dirichlet)
        if periodic:
            masters, slaves = find_periodic_pairs(coords, L=L, H=H, tol=tol)
        else:
            masters = np.zeros(0, np.int32)
            slaves = np.zeros(0, np.int32)
        return cls(walls, inner, dirichlet, interior, masters, slaves)

    def index_tensors(self, device) -> dict[str, torch.Tensor]:
        """The index sets as int64 tensors on ``device``, made once so a
        step never copies indices from the host."""
        return {
            f.name: torch.as_tensor(getattr(self, f.name), dtype=torch.int64, device=device)
            for f in dataclasses.fields(self)
        }
