"""Discrete nodal vector calculus: divergence and gradient.

Same semantics as ``tpufem.ops.calculus``:

* element-constant derivative via the signed determinant,
* ⅓-area lumping to nodes,
* normalization by the accumulated ⅓-areas (+1e-12),
* degenerate triangles (|det| < 1e-14) contribute nothing, including to
  the accumulated area.

The gather → segment-sum pipelines are torch functions of the field's dtype
and device (the segment sum is ``index_add_``); :func:`divergence_matrices`
materializes the same linear map as dense host NumPy matrices, the form
the dense regime applies on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.mesh.core import Mesh

_EPS_AREA = 1e-12


def _lump(mesh: Mesh, per_element: torch.Tensor) -> torch.Tensor:
    """Scatter a per-element quantity (T,) or (T, k) to nodes with ⅓-area
    lumping and normalize by the accumulated area."""
    dtype, device = per_element.dtype, per_element.device
    area = torch.as_tensor(mesh.area, dtype=dtype, device=device)
    valid = torch.as_tensor(mesh.valid, dtype=torch.bool, device=device)
    w = torch.where(valid, area / 3.0, torch.zeros((), dtype=dtype, device=device))
    seg = torch.as_tensor(mesh.tris, dtype=torch.int64, device=device).reshape(-1)
    n, t = mesh.n_nodes, mesh.n_tris

    def scatter(q):
        contrib = (q * w)[:, None].expand(t, 3).reshape(-1)
        return torch.zeros(n, dtype=dtype, device=device).index_add_(0, seg, contrib)

    area_sum = scatter(torch.ones_like(w))
    if per_element.ndim == 1:
        return scatter(per_element) / (area_sum + _EPS_AREA)
    cols = [scatter(per_element[:, k]) for k in range(per_element.shape[1])]
    return torch.stack(cols, dim=1) / (area_sum + _EPS_AREA)[:, None]


def element_gradient(mesh: Mesh, p: torch.Tensor) -> torch.Tensor:
    """(T, 2) element-constant gradient of a nodal scalar p."""
    grads = torch.as_tensor(mesh.grads, dtype=p.dtype, device=p.device)  # (T,3,2)
    tris = torch.as_tensor(mesh.tris, dtype=torch.int64, device=p.device)
    return torch.einsum("ti,tid->td", p[tris], grads)


def gradient(mesh: Mesh, p: torch.Tensor) -> torch.Tensor:
    """(N, 2) lumped nodal gradient."""
    return _lump(mesh, element_gradient(mesh, p))


def element_divergence(mesh: Mesh, u: torch.Tensor) -> torch.Tensor:
    """(T,) element-constant divergence of nodal velocity u (N, 2)."""
    grads = torch.as_tensor(mesh.grads, dtype=u.dtype, device=u.device)
    tris = torch.as_tensor(mesh.tris, dtype=torch.int64, device=u.device)
    u_loc = u[tris]  # (T,3,2)
    dudx = torch.einsum("ti,ti->t", u_loc[..., 0], grads[..., 0])
    dvdy = torch.einsum("ti,ti->t", u_loc[..., 1], grads[..., 1])
    return dudx + dvdy


def divergence(mesh: Mesh, u: torch.Tensor) -> torch.Tensor:
    """(N,) lumped nodal divergence."""
    return _lump(mesh, element_divergence(mesh, u))


def divergence_matrices(mesh: Mesh):
    """(Dx, Dy) host NumPy (N, N) float64 matrices with
    div(u) = Dx uₓ + Dy u_y, and likewise ∇p = (Dx p, Dy p).  Equal to
    :func:`divergence` / :func:`gradient` up to summation order."""
    n, t = mesh.n_nodes, mesh.n_tris
    w = np.where(mesh.valid, mesh.area / 3.0, 0.0)  # (T,)
    area_sum = np.zeros(n)
    np.add.at(area_sum, mesh.tris.reshape(-1), np.repeat(w, 3))
    inv_area = 1.0 / (area_sum + _EPS_AREA)
    Dx = np.zeros((n, n))
    Dy = np.zeros((n, n))
    rows = np.repeat(mesh.tris, 3, axis=1).reshape(-1)  # i (receiver)
    cols = np.tile(mesh.tris, (1, 3)).reshape(-1)  # j (source dof)
    gx = np.broadcast_to(mesh.grads[:, None, :, 0], (t, 3, 3)).reshape(-1)
    gy = np.broadcast_to(mesh.grads[:, None, :, 1], (t, 3, 3)).reshape(-1)
    w9 = np.broadcast_to(w[:, None, None], (t, 3, 3)).reshape(-1)
    np.add.at(Dx, (rows, cols), w9 * gx)
    np.add.at(Dy, (rows, cols), w9 * gy)
    return inv_area[:, None] * Dx, inv_area[:, None] * Dy


def divergence_csr_operators(mesh: Mesh):
    """(Dx, Dy) as static CSR operators (float64, on the CPU): the sparse
    form of :func:`divergence_matrices`, on the stiffness pattern.
    div(u) = Dx uₓ + Dy u_y and ∇p = (Dx p, Dy p)."""
    from tpufem_torch.ops import assembly

    t, n = mesh.n_tris, mesh.n_nodes
    w = np.where(mesh.valid, mesh.area / 3.0, 0.0)
    ex = np.broadcast_to((w[:, None] * mesh.grads[:, :, 0])[:, None, :], (t, 3, 3))
    ey = np.broadcast_to((w[:, None] * mesh.grads[:, :, 1])[:, None, :], (t, 3, 3))
    area_sum = np.zeros(n)
    np.add.at(area_sum, mesh.tris.reshape(-1), np.repeat(w, 3))
    inv_area = 1.0 / (area_sum + _EPS_AREA)
    dx = assembly.assemble_csr(mesh, torch.as_tensor(np.ascontiguousarray(ex)))
    dy = assembly.assemble_csr(mesh, torch.as_tensor(np.ascontiguousarray(ey)))
    scale = torch.as_tensor(inv_area[dx.row_ids])
    return dx.with_data(dx.data * scale), dy.with_data(dy.data * scale)
