"""Boundary conditions as data: index maps, masks and value vectors.

Discovery and matrix surgery run once at set-up on host NumPy arrays;
application to fields on the device is an indexed copy.  Same semantics as
``tpufem.bc``:

* periodic pair discovery (left/right columns, nearest-y matching),
* periodic enforcement by ±1e10 penalty or by field copy,
* symmetric Dirichlet row+column surgery,
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
