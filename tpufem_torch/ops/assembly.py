"""FEM operator assembly: per-element matrices for all T elements at once,
scattered into a dense (N, N) matrix with one accumulating ``index_put_``.

The dense form serves the dense regime (N up to ~4k), where each step is a
handful of (N, N) matvecs; the COO/CSR forms serve the scale regime, where
only the static sparsity pattern (host NumPy, computed once per mesh) and
its values exist.

Every function takes an explicit ``dtype`` and ``device``; set-up calls them
in float64 on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.mesh.core import Mesh


def _t(arr, dtype, device) -> torch.Tensor:
    return torch.as_tensor(arr, dtype=dtype, device=device)


def element_stiffness(
    mesh: Mesh, signed: bool = False, dtype=torch.float64, device=None
) -> torch.Tensor:
    """(T, 3, 3) P1 stiffness element matrices.

    K^e_ij = (∇φ_i · ∇φ_j) · area.  ``signed=True`` divides by the signed
    determinant instead of its absolute value (the early Poisson variant)."""
    grads = _t(mesh.grads, dtype, device)  # (T,3,2), already /det (signed)
    det = _t(mesh.det, dtype, device)
    # ∇φ_i·∇φ_j (carries 1/det²) as x·x fused-multiply-added onto y·y: the
    # rounding of tpufem's einsum on the CPU, so the two agree bit for bit
    gx, gy = grads[..., 0], grads[..., 1]
    gg = torch.addcmul(gx[:, :, None] * gx[:, None, :], gy[:, :, None], gy[:, None, :])
    scale = det * det / (2.0 * (det if signed else torch.abs(det)))
    ke = gg * scale[:, None, None]
    valid = _t(mesh.valid, torch.bool, device)
    return torch.where(valid[:, None, None], ke, torch.zeros((), dtype=dtype, device=device))


def element_mass(mesh: Mesh, dtype=torch.float64, device=None) -> torch.Tensor:
    """(T, 3, 3) consistent P1 mass: M^e = (area/12)·[[2,1,1],[1,2,1],[1,1,2]]."""
    area = _t(mesh.area, dtype, device)
    base = torch.ones((3, 3), dtype=dtype, device=device) + torch.eye(3, dtype=dtype, device=device)
    me = area[:, None, None] / 12.0 * base
    valid = _t(mesh.valid, torch.bool, device)
    return torch.where(valid[:, None, None], me, torch.zeros((), dtype=dtype, device=device))


def assemble_coo(mesh: Mesh, elem: torch.Tensor):
    """Flatten (T, 3, 3) element matrices to COO triplets (rows, cols, vals)."""
    tris = torch.as_tensor(mesh.tris, dtype=torch.int64, device=elem.device)
    rows = tris.repeat_interleave(3, dim=1).reshape(-1)  # i varies slower
    cols = tris.repeat(1, 3).reshape(-1)
    return rows, cols, elem.reshape(-1)


def assemble_dense(mesh: Mesh, elem: torch.Tensor) -> torch.Tensor:
    """Scatter (T, 3, 3) element matrices into a dense (N, N) matrix."""
    tris = torch.as_tensor(mesh.tris, dtype=torch.int64, device=elem.device)
    rows = tris.repeat_interleave(3, dim=1).reshape(-1)  # i varies slower
    cols = tris.repeat(1, 3).reshape(-1)
    n = mesh.n_nodes
    out = torch.zeros((n, n), dtype=elem.dtype, device=elem.device)
    return out.index_put_((rows, cols), elem.reshape(-1), accumulate=True)


def lumped_mass(mesh: Mesh, dtype=torch.float64, device=None) -> torch.Tensor:
    """(N,) lumped mass: M_L[i] = Σ_incident area/3.  Degenerate triangles
    are not skipped here (their area is 0)."""
    area = _t(mesh.area, dtype, device)
    contrib = (area / 3.0)[:, None].expand(mesh.n_tris, 3).reshape(-1)
    seg = torch.as_tensor(mesh.tris, dtype=torch.int64, device=device).reshape(-1)
    out = torch.zeros(mesh.n_nodes, dtype=dtype, device=device)
    return out.index_add_(0, seg, contrib)


def assemble_csr(mesh: Mesh, elem: torch.Tensor):
    """Materialize (T, 3, 3) element matrices as a static-pattern CSR
    operator; the values keep ``elem``'s dtype and device."""
    from tpufem_torch.ops.sparse import CSROperator

    pattern = _csr_pattern(mesh)
    return CSROperator(
        indptr=pattern["indptr"],
        indices=pattern["indices"],
        data=_coo_to_csr_values(pattern, elem),
        shape=(mesh.n_nodes, mesh.n_nodes),
    )


_PATTERN_CACHE: dict[int, tuple] = {}


def _csr_pattern(mesh: Mesh) -> dict:
    """The CSR pattern of the mesh's P1 connectivity (host NumPy): unique
    sorted (row, col) pairs and each COO entry's slot.  Cached per mesh;
    the cache holds the mesh itself, since a bare ``id()`` can be reused."""
    key = id(mesh)
    hit = _PATTERN_CACHE.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    tris = np.asarray(mesh.tris)
    rows = np.repeat(tris, 3, axis=1).reshape(-1)
    cols = np.tile(tris, (1, 3)).reshape(-1)
    order = np.lexsort((cols, rows))
    rs, cs = rows[order], cols[order]
    keys = rs.astype(np.int64) * mesh.n_nodes + cs
    uniq, inverse = np.unique(keys, return_inverse=True)
    urows = (uniq // mesh.n_nodes).astype(np.int32)
    ucols = (uniq % mesh.n_nodes).astype(np.int32)
    indptr = np.zeros(mesh.n_nodes + 1, dtype=np.int32)
    np.add.at(indptr, urows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    pattern = {
        "indptr": indptr,
        "indices": ucols,
        "order": order,
        "inverse": inverse.astype(np.int32),
        "nnz": uniq.shape[0],
    }
    _PATTERN_CACHE[key] = (mesh, pattern)
    return pattern


def _coo_to_csr_values(pattern: dict, elem: torch.Tensor) -> torch.Tensor:
    """Sum the COO entries (in the pattern's sorted order) into their slots."""
    dev = elem.device
    vals = elem.reshape(-1)[torch.as_tensor(pattern["order"], device=dev)]
    out = torch.zeros(pattern["nnz"], dtype=elem.dtype, device=dev)
    return out.index_add_(0, torch.as_tensor(pattern["inverse"], dtype=torch.int64, device=dev),
                          vals)
