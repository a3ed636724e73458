"""Discrete nodal vector calculus: divergence, gradient, vorticity.

Same semantics as ``tpufem.ops.calculus``:

* element-constant derivative via the signed determinant,
* ⅓-area lumping to nodes,
* normalization by the accumulated ⅓-areas (+1e-12),
* degenerate triangles (|det| < 1e-14) contribute nothing, including to
  the accumulated area.

The gather → segment-sum pipelines are torch functions of the field's dtype
and device (the segment sum is ``index_add_``; the per-element sums are
elementwise products and sums, not ``einsum``, which CUDA runs as batched
GEMVs split into many launches at 10⁶ elements); :func:`divergence_matrices`
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
    geo = mesh.tensors(dtype, device)
    w = torch.where(geo["valid"], geo["area"] / 3.0, torch.zeros((), dtype=dtype, device=device))
    seg = geo["tris"].reshape(-1)
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
    geo = mesh.tensors(p.dtype, p.device)
    return torch.sum(p[geo["tris"]][:, :, None] * geo["grads"], dim=1)


def gradient(mesh: Mesh, p: torch.Tensor) -> torch.Tensor:
    """(N, 2) lumped nodal gradient."""
    return _lump(mesh, element_gradient(mesh, p))


def element_divergence(mesh: Mesh, u: torch.Tensor) -> torch.Tensor:
    """(T,) element-constant divergence of nodal velocity u (N, 2)."""
    geo = mesh.tensors(u.dtype, u.device)
    d = torch.sum(u[geo["tris"]] * geo["grads"], dim=1)  # (T, 2): ∂uₓ/∂x, ∂u_y/∂y
    return d[:, 0] + d[:, 1]


def divergence(mesh: Mesh, u: torch.Tensor) -> torch.Tensor:
    """(N,) lumped nodal divergence."""
    return _lump(mesh, element_divergence(mesh, u))


def vorticity(mesh: Mesh, u: torch.Tensor) -> torch.Tensor:
    """(N,) lumped nodal vorticity ω = ∂u_y/∂x − ∂u_x/∂y."""
    geo = mesh.tensors(u.dtype, u.device)
    u_loc, grads = u[geo["tris"]], geo["grads"]  # (T, 3, 2) each
    duy_dx = torch.sum(u_loc[..., 1] * grads[..., 0], dim=1)
    dux_dy = torch.sum(u_loc[..., 0] * grads[..., 1], dim=1)
    return _lump(mesh, duy_dx - dux_dy)


def mass_apply(mesh: Mesh, c: torch.Tensor) -> torch.Tensor:
    """Matrix-free consistent-mass product M·c, never materialized: per
    element (M^e c)_i = (A/12)(2c_i + c_j + c_k), the local mass of
    ``assembly.element_mass``."""
    dtype, dev = c.dtype, c.device
    geo = mesh.tensors(dtype, dev)
    tris = geo["tris"]
    c_loc = c[tris]  # (T, 3)
    tot = c_loc.sum(dim=1, keepdim=True)
    w = geo["valid"].to(dtype) * geo["area"] / 12.0
    contrib = w[:, None] * (tot + c_loc)
    return torch.zeros(mesh.n_nodes, dtype=dtype, device=dev).index_add_(
        0, tris.reshape(-1), contrib.reshape(-1))


def convection_apply(mesh: Mesh, u: torch.Tensor, c: torch.Tensor,
                     variant: str = "stokescolor") -> torch.Tensor:
    """Matrix-free convection product C(u)·c, never materialized:
    (C c)_i = Σ_{e∋i} row_e · ū_e · (Σ_j ∇̃φ_j c_j), with the scalings of
    ``assembly.element_convection`` (``variant`` "stokescolor" or "opsplit")."""
    from tpufem_torch.ops.assembly import _centroid_velocity, _convection_scaling

    dtype, dev = c.dtype, c.device
    geo = mesh.tensors(dtype, dev)
    scale, row = _convection_scaling(mesh, variant, dtype, dev)
    grads = geo["grads"] * scale[:, None, None]
    valid = geo["valid"].to(dtype)
    tris = geo["tris"]
    ucx, ucy = _centroid_velocity(mesh, u)
    gradc = torch.sum(c[tris][:, :, None] * grads, dim=1)
    val = valid * row * (ucx * gradc[:, 0] + ucy * gradc[:, 1])
    contrib = val[:, None].expand(mesh.n_tris, 3).reshape(-1)
    return torch.zeros(mesh.n_nodes, dtype=dtype, device=dev).index_add_(0, tris.reshape(-1), contrib)


def consistent_divergence_rhs(mesh: Mesh, u: torch.Tensor) -> torch.Tensor:
    """(N,) consistent pressure right-hand side b_i = −∫ ∇φ_i · ū with the
    element-averaged velocity ū (the weak divergence against the P1 test
    space), in ``u``'s dtype and on its device."""
    dtype, dev = u.dtype, u.device
    geo = mesh.tensors(dtype, dev)
    tris = geo["tris"]
    u_avg = u[tris].mean(dim=1)  # (T, 2)
    grads = geo["grads"]
    contrib = -(u_avg[:, None, 0] * grads[:, :, 0] + u_avg[:, None, 1] * grads[:, :, 1])
    contrib = contrib * geo["area"][:, None]
    contrib = torch.where(geo["valid"][:, None], contrib, torch.zeros((), dtype=dtype, device=dev))
    return torch.zeros(mesh.n_nodes, dtype=dtype, device=dev).index_add_(
        0, tris.reshape(-1), contrib.reshape(-1))


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


def gradient_matrices(mesh: Mesh):
    """(Gx, Gy) host NumPy (N, N) with ∇p = (Gx p, Gy p): the lumped nodal
    gradient as dense operators.  The same per-dof coefficients as
    :func:`divergence_matrices` (∂x from ``grads[..., 0]``, ∂y from
    ``grads[..., 1]``), so the same matrices."""
    return divergence_matrices(mesh)
