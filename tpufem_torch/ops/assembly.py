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


def _convection_scaling(mesh: Mesh, variant: str, dtype, device):
    """(scale, row): ∇̃φ = grads·scale and the row weight of the two
    reference scalings, ``"stokescolor"`` (diffs/(2|det|), unsigned area/3)
    and ``"opsplit"`` (diffs/det, signed area/3)."""
    geo = mesh.tensors(dtype, device)
    det = geo["det"]
    if variant == "stokescolor":
        return det / (2.0 * torch.abs(det)), geo["area"] / 3.0
    if variant == "opsplit":
        return torch.ones_like(det), 0.5 * det / 3.0
    raise ValueError(f"unknown convection variant: {variant}")


def _centroid_velocity(mesh: Mesh, u: torch.Tensor, mean: bool = True):
    """(ūx, ūy) per element: the corner sum times 1/3 (the rounding of
    tpufem's ``mean``), or with ``mean=False`` divided by 3 (the rounding of
    tpufem's flat convection form; the two differ by an ulp at times)."""
    tris = mesh.tensors(u.dtype, u.device)["tris"]
    total = u[tris[:, 0]] + u[tris[:, 1]] + u[tris[:, 2]]
    uc = total * (1.0 / 3.0) if mean else total / 3.0
    return uc[:, 0], uc[:, 1]


def element_convection(mesh: Mesh, u: torch.Tensor, variant: str = "stokescolor") -> torch.Tensor:
    """(T, 3, 3) convection element matrices C(u), in ``u``'s dtype and device.

    C^e_ij = row_e · (ū_e · ∇̃φ_j), ū the element-centroid velocity, the row
    index uniform (test-function lumping); ``variant`` picks the scaling
    (:func:`_convection_scaling`).  ū·∇̃φ is y·y fused-multiply-added onto
    x·x, the rounding of tpufem's einsum on the CPU."""
    dtype, dev = u.dtype, u.device
    geo = mesh.tensors(dtype, dev)
    scale, row = _convection_scaling(mesh, variant, dtype, dev)
    g = geo["grads"] * scale[:, None, None]
    ucx, ucy = _centroid_velocity(mesh, u)
    udotg = torch.addcmul(ucx[:, None] * g[..., 0], ucy[:, None], g[..., 1])  # (T, 3)
    ce = row[:, None, None] * udotg[:, None, :].expand(mesh.n_tris, 3, 3)
    return torch.where(geo["valid"][:, None, None], ce, torch.zeros((), dtype=dtype, device=dev))


def element_convection_flat(mesh: Mesh, u: torch.Tensor, variant: str = "stokescolor") -> torch.Tensor:
    """(9·T,) k-major convection values: entry ``k·T + t`` equals
    ``element_convection(mesh, u, variant)[t, k // 3, k % 3]`` up to
    rounding: the centroid is divided by 3 and no multiply-add is fused,
    both as in tpufem's flat form outside a compiled program."""
    dtype, dev = u.dtype, u.device
    geo = mesh.tensors(dtype, dev)
    scale, row = _convection_scaling(mesh, variant, dtype, dev)
    row = torch.where(geo["valid"], row, torch.zeros((), dtype=dtype, device=dev))
    grads = geo["grads"]
    ucx, ucy = _centroid_velocity(mesh, u, mean=False)
    w = [row * (ucx * (grads[:, j, 0] * scale) + ucy * (grads[:, j, 1] * scale)) for j in range(3)]
    return torch.cat(w * 3)  # k = 3i + j, the row index i uniform


def assemble_coo(mesh: Mesh, elem: torch.Tensor):
    """Flatten (T, 3, 3) element matrices to COO triplets (rows, cols, vals)."""
    tris = torch.as_tensor(mesh.tris, dtype=torch.int64, device=elem.device)
    rows = tris.repeat_interleave(3, dim=1).reshape(-1)  # i varies slower
    cols = tris.repeat(1, 3).reshape(-1)
    return rows, cols, elem.reshape(-1)


def assemble_dense(mesh: Mesh, elem: torch.Tensor) -> torch.Tensor:
    """Scatter (T, 3, 3) element matrices into a dense (N, N) matrix."""
    tris = mesh.tensors(elem.dtype, elem.device)["tris"]
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


def load_vector(mesh: Mesh, g_source, signed_area: bool = False, negate: bool = True,
                dtype=torch.float64, device=None) -> torch.Tensor:
    """(N,) load vector of source g: b_j += g(centroid)·area/3 at each corner
    of each valid triangle.

    ``g_source`` is a number or a callable ``g(x, y)`` of the centroid
    coordinates as tensors in ``dtype`` on ``device``.  ``signed_area=True``
    takes the signed area (det/2), the early Poisson variant;
    ``negate=True`` returns −b."""
    area = _t(0.5 * mesh.det if signed_area else mesh.area, dtype, device)
    if callable(g_source):
        cent = _t(mesh.centroids(), dtype, device)
        g = torch.as_tensor(g_source(cent[:, 0], cent[:, 1]), dtype=dtype, device=device)
    else:
        g = torch.full((mesh.n_tris,), float(g_source), dtype=dtype, device=device)
    contrib = g * area / 3.0
    contrib = torch.where(_t(mesh.valid, torch.bool, device), contrib,
                          torch.zeros((), dtype=dtype, device=device))
    seg = torch.as_tensor(mesh.tris, dtype=torch.int64, device=device).reshape(-1)
    b = torch.zeros(mesh.n_nodes, dtype=dtype, device=device).index_add_(
        0, seg, contrib[:, None].expand(mesh.n_tris, 3).reshape(-1))
    return -b if negate else b


def load_vector_nodal(mesh: Mesh, g_nodal: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """Consistent-mass load of a nodal source: b_i += (A/12)(2g_i + g_j + g_k)
    over the triangles at i.  The area is in ``dtype``; the result takes the
    promoted dtype of it and ``g_nodal``, on ``g_nodal``'s device."""
    dev = g_nodal.device
    area = _t(mesh.area, dtype, dev)
    tris = torch.as_tensor(mesh.tris, dtype=torch.int64, device=dev)
    g_loc = g_nodal[tris]  # (T, 3)
    total = g_loc.sum(dim=1, keepdim=True)
    contrib = (area[:, None] / 12.0) * (g_loc + total)  # 2g_i + g_j + g_k
    out = torch.zeros(mesh.n_nodes, dtype=contrib.dtype, device=dev)
    return out.index_add_(0, tris.reshape(-1), contrib.reshape(-1))


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
