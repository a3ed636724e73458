"""FEM operator assembly: per-element matrices for all T elements at once,
scattered into a dense (N, N) matrix with one accumulating ``index_put_``.

The dense form serves the dense regime (N up to ~4k), where each step is a
handful of (N, N) matvecs.  The COO/CSR forms of ``tpufem.ops.assembly``
belong to the scale regime and are not ported yet.

Every function takes an explicit ``dtype`` and ``device``; set-up calls them
in float64 on the CPU.
"""

from __future__ import annotations

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
    gg = torch.einsum("tid,tjd->tij", grads, grads)  # carries 1/det²
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
