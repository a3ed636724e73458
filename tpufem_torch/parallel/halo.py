"""Halo-exchange distributed CG over RCM-banded operators.

The counterpart of ``tpufem.parallel.halo`` on the port's single-controller
device mesh (``spmd.DeviceMesh``: one tensor a shard, no
``torch.distributed``).  After RCM renumbering the operator has bandwidth
b, so a contiguous block of rows reads x only within b rows of itself.  The
rows are cut into equal blocks (more rows than b) over one axis; each apply
extends a block by the left neighbour's last b rows and the right
neighbour's first b rows (``.to`` and ``torch.cat``, as
``grid_sharded._halo_exchange``; zeros past shards 0 and s − 1) and
multiplies the band (:func:`~tpufem_torch.ops.banded.band_sum`).  Dot
products are :func:`~tpufem_torch.parallel.spmd.psum`'d per column.

Both solvers run tpufem's fixed-length Jacobi-PCG, every column with its
own step lengths, from a zero initial guess.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.ops.banded import BandedOperator, band_sum
from tpufem_torch.parallel.spmd import psum
from tpufem_torch.solve.cg import _ratio


def _block_layout(band: BandedOperator, s: int):
    """(rows a block, padded length, diagonals, (s, nb, rows) host blocks)."""
    n, bw = band.n, band.bandwidth
    rows = -(-n // s)
    if rows <= bw:
        raise ValueError(f"block rows ({rows}) must exceed bandwidth ({bw}) for nearest-"
                         "neighbour halos: use fewer shards or a finer mesh")
    n_pad = rows * s
    nb = 2 * bw + 1
    diags = np.zeros((nb, n_pad))
    diags[:, :n] = band.diags.detach().cpu().numpy().astype(np.float64)
    return rows, n_pad, nb, diags.reshape(nb, s, rows).transpose(1, 0, 2)


def halo_extend(x_blocks: list[torch.Tensor], bw: int) -> list[torch.Tensor]:
    """Each (rows, k) block → (rows + 2·bw, k): the left neighbour's last
    ``bw`` rows above, the right neighbour's first below, zeros at the
    chain's ends (the blocks are not a ring)."""
    if bw == 0:
        return list(x_blocks)
    s = len(x_blocks)
    out = []
    for i, x in enumerate(x_blocks):
        left = x_blocks[i - 1][-bw:].to(x.device) if i > 0 else x.new_zeros((bw,) + x.shape[1:])
        right = (x_blocks[i + 1][:bw].to(x.device) if i < s - 1
                 else x.new_zeros((bw,) + x.shape[1:]))
        out.append(torch.cat([left, x, right]))
    return out


def col_dot(a: list[torch.Tensor], c: list[torch.Tensor]) -> list[torch.Tensor]:
    """Per-column dot products of per-shard (rows, k) blocks, on every shard."""
    return psum([torch.sum(x * y, dim=0) for x, y in zip(a, c)])


def cg_fixed_blocks(matvec, precond, project, b: list[torch.Tensor], iters: int):
    """tpufem's shard-local CG loop: ``iters`` Jacobi-PCG iterations on
    per-shard (rows, k) blocks from x = 0, per-column α and β (0 where the
    denominator is 0); ``b`` is projected first, as is each z."""
    b = project(b)
    x = [torch.zeros_like(v) for v in b]
    r = b
    z = project(precond(r))
    p, rz = z, col_dot(r, z)
    for _ in range(iters):
        ap = project(matvec(p))
        alpha = [_ratio(a, c) for a, c in zip(rz, col_dot(p, ap))]
        x = [xi + al * pi for xi, al, pi in zip(x, alpha, p)]
        r = [ri - al * api for ri, al, api in zip(r, alpha, ap)]
        z = project(precond(r))
        rz_new = col_dot(r, z)
        beta = [_ratio(a, c) for a, c in zip(rz_new, rz)]
        p = [zi + be * pi for zi, be, pi in zip(z, beta, p)]
        rz = rz_new
    return x


def deflation(w: list[torch.Tensor]):
    """v ↦ v − (w·v / w·w) w per column: the constant-nullspace projection
    on the active dofs ``w`` (per-shard blocks)."""
    ww = col_dot(w, w)

    def project(v):
        c = col_dot(w, v)
        return [vi - (ci / wi) * wv for vi, ci, wi, wv in zip(v, c, ww, w)]

    return project


def _blocks(v: np.ndarray, devices, dtype=None) -> list[torch.Tensor]:
    """Host (s, rows, ...) blocks as one tensor a shard."""
    return [torch.as_tensor(np.ascontiguousarray(v[i]), dtype=dtype, device=dev)
            for i, dev in enumerate(devices)]


def _split(x: torch.Tensor, devices, rows: int) -> list[torch.Tensor]:
    return [x[i * rows:(i + 1) * rows].to(dev) for i, dev in enumerate(devices)]


def _join(blocks: list[torch.Tensor], device) -> torch.Tensor:
    return torch.cat([v.to(device) for v in blocks])


def _cast(tables: list[torch.Tensor], dtype) -> list[torch.Tensor]:
    return [t.to(dtype) for t in tables]


def _merge_rhs(b, ml, masters, slaves, act):
    """merge(M_L ∘ b): the slaves' rows added to their masters', masked to
    the active dofs (the merged periodic pressure right-hand side)."""
    rhs = ml.to(b.dtype) * b
    if masters is not None:
        rhs = rhs.index_add(0, masters, rhs[slaves]) * act.to(b.dtype)
    return rhs


def _pressure_index(m_lumped, masters, slaves, active_mask, device):
    """(M_L, masters, slaves, active mask) on ``device``; the pairs None
    where there are none."""
    t = lambda a: a.to(device) if torch.is_tensor(a) else torch.as_tensor(np.asarray(a),
                                                                           device=device)
    if not len(masters):
        return t(m_lumped), None, None, t(active_mask)
    pairs = (t(np.asarray(masters, dtype=np.int64)), t(np.asarray(slaves, dtype=np.int64)))
    return t(m_lumped), *pairs, t(active_mask)


def make_halo_pressure_solver(device_mesh, band_merged: BandedOperator, m_lumped, masters,
                              slaves, active_mask, iters: int, axis: str = "space"):
    """The merged-periodic pressure Poisson, K_merged p = merge(M_L ∘ b),
    by the halo-exchange Jacobi-PCG of :func:`make_halo_viscous_solver`'s
    block layout, the constant nullspace deflated on the active dofs.
    Returns ``solve(b (N,)) → (N,)`` in global node order, on ``b``'s
    device."""
    devices = device_mesh.axis_devices(axis)
    s = len(devices)
    n, bw = band_merged.n, band_merged.bandwidth
    rows, n_pad, nb, diags_sh = _block_layout(band_merged, s)
    act_perm = np.zeros(n_pad)
    act_perm[:n] = _np(active_mask)[band_merged.perm]
    diag_pad = np.zeros(n_pad)
    diag_pad[:n] = _np(band_merged.diags[bw]).astype(np.float64)
    inv_diag = np.where(diag_pad > 0, 1.0 / np.where(diag_pad > 0, diag_pad, 1.0), 1.0)
    tables = (_blocks(diags_sh, devices), _blocks(act_perm.reshape(s, rows, 1), devices),
              _blocks(inv_diag.reshape(s, rows, 1), devices))
    home = band_merged.diags.device
    ml, m_idx, s_idx, act = _pressure_index(m_lumped, masters, slaves, active_mask, home)
    perm, inv_perm = band_merged.perm_t, band_merged.inv_perm_t

    def solve(b):
        diags, w, invd = (_cast(t, b.dtype) for t in tables)
        project = deflation(w)

        def mv(p):
            return [band_sum(d, xe, rows) for d, xe in zip(diags, halo_extend(p, bw))]

        rhs = _merge_rhs(b.to(home), ml, m_idx, s_idx, act)
        pad = torch.zeros((n_pad, 1), dtype=b.dtype, device=home)
        pad[:n, 0] = rhs[perm]
        x = cg_fixed_blocks(mv, lambda r: [d * ri for d, ri in zip(invd, r)], project,
                            _split(pad, devices, rows), iters)
        p = _join(x, home)[:n, 0][inv_perm]
        if m_idx is not None:
            p = p.index_put((s_idx,), p[m_idx])
        return p.to(b.device)

    return solve


def make_halo_viscous_solver(device_mesh, band: BandedOperator, interior_mask, dt_nu: float,
                             iters: int, axis: str = "space"):
    """The (I + Δt·ν·K_masked) solve with halo exchange over ``axis``.
    Returns ``solve(b (N,) or (N, k)) → same shape`` in global node order
    (the RCM permutation in and out inside), on ``b``'s device."""
    devices = device_mesh.axis_devices(axis)
    s = len(devices)
    n, bw = band.n, band.bandwidth
    rows, n_pad, nb, diags_sh = _block_layout(band, s)
    mask_p = np.zeros(n_pad)
    mask_p[:n] = _np(interior_mask)[band.perm]
    diag_main = np.zeros(n_pad)
    diag_main[:n] = _np(band.diags[bw]).astype(np.float64)
    inv_diag = np.where(mask_p > 0, 1.0 / (1.0 + dt_nu * diag_main), 1.0)
    tables = (_blocks(diags_sh, devices), _blocks(mask_p.reshape(s, rows, 1), devices),
              _blocks(inv_diag.reshape(s, rows, 1), devices))
    home = band.diags.device
    perm, inv_perm = band.perm_t, band.inv_perm_t
    ident = lambda v: v

    def solve(b):
        diags, mask, invd = (_cast(t, b.dtype) for t in tables)

        def full_op(x):
            mx = [m * xi for m, xi in zip(mask, x)]
            kx = [band_sum(d, xe, rows) for d, xe in zip(diags, halo_extend(mx, bw))]
            return [m * (xi + dt_nu * k) + (1.0 - m) * xi for m, xi, k in zip(mask, x, kx)]

        b2 = b.to(home).reshape(n, -1)
        pad = torch.zeros((n_pad, b2.shape[1]), dtype=b.dtype, device=home)
        pad[:n] = b2[perm]
        x = cg_fixed_blocks(full_op, lambda r: [d * ri for d, ri in zip(invd, r)], ident,
                            _split(pad, devices, rows), iters)
        return _join(x, home)[:n][inv_perm].reshape(b.shape).to(b.device)

    return solve


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
