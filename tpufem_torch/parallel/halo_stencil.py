"""Halo-exchange distributed CG over stencil-offset operators.

The counterpart of ``tpufem.parallel.halo_stencil`` on the port's
single-controller device mesh.  A :class:`~tpufem_torch.ops.stencil.
StencilOperator` is A = Σ_k diag(d_k)·Shift(o_k) + R; distributed over
contiguous row blocks:

* the stencil part reads x only within ``max|o_k|`` rows of a block, so
  its halo is the two neighbour strips of :func:`~tpufem_torch.parallel.
  halo.halo_extend`, ``max|offset|`` rows wide;
* the remainder R is split by ownership: entries whose row and column lie
  in one block apply there; the cross-block ones read a compacted send
  buffer, each shard's x at the indices some other block's remainder
  reads, joined by :func:`~tpufem_torch.parallel.spmd.all_gather`.

Offsets at least a block wide cannot ride a neighbour halo: their entries
are demoted into the remainder.  The host tables (:func:`build_stencil_layout`)
are array-equal to tpufem's.  Both solvers run the Jacobi-PCG of
:mod:`tpufem_torch.parallel.halo` in natural node order (no permutation).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufem_torch.ops.stencil import StencilOperator, shift_sum
from tpufem_torch.parallel.halo import (_blocks, _cast, _join, _merge_rhs, _np,
                                        _pressure_index, _split, cg_fixed_blocks, deflation,
                                        halo_extend)
from tpufem_torch.parallel.spmd import all_gather


@dataclasses.dataclass(frozen=True)
class _StencilLayout:
    """Host tables of the distributed stencil apply, each with a leading (s,)
    shard axis and equal padded lengths (pad slots: data 0, index 0)."""

    offsets: tuple
    bw: int  # halo strip width, max |offset|
    rows: int  # rows a block
    n_pad: int
    diags: np.ndarray  # (s, n_off, rows)
    lrows: np.ndarray  # (s, L_loc) local-remainder target rows (block-local)
    lcols: np.ndarray  # (s, L_loc) block-local source columns
    ldata: np.ndarray  # (s, L_loc)
    send_idx: np.ndarray  # (s, L_send) block-local x indices each shard sends
    crows: np.ndarray  # (s, L_cross) cross-remainder target rows
    cpos: np.ndarray  # (s, L_cross) positions in the gathered buffer
    cdata: np.ndarray  # (s, L_cross)
    has_local: bool
    has_cross: bool


def _pad_by_device(dev: np.ndarray, arrays, s: int):
    """Per-entry arrays scattered into (s, L) tables ordered by shard."""
    counts = np.bincount(dev, minlength=s)
    L = max(1, int(counts.max()) if len(dev) else 0)
    order = np.argsort(dev, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(dev)) - np.repeat(starts, counts)
    out = []
    for a in arrays:
        t = np.zeros((s, L), dtype=a.dtype)
        t[dev[order], slot] = a[order]
        out.append(t)
    return out


def build_stencil_layout(op: StencilOperator, s: int) -> _StencilLayout:
    """The tables of ``op`` over ``s`` row blocks (host, float64 values)."""
    n = op.n
    rows = -(-n // s)
    # the single-device picker keeps the 16 most frequent offsets, some of
    # them long ring–grid couplings on annulus meshes; the nine grid
    # offsets (|o| ≤ n_side + 1) always stay diagonals
    near = [o for o in op.offsets if abs(o) < rows]
    far = [o for o in op.offsets if abs(o) >= rows]
    if not near or 0 not in near:
        raise ValueError(f"no stencil offset fits a {rows}-row block: use fewer shards")
    bw = max(abs(o) for o in near)
    offsets = tuple(near)
    n_pad = rows * s

    all_diags = _np(op.diags).astype(np.float64)
    diags = np.zeros((len(offsets), n_pad))
    for j, o in enumerate(offsets):
        diags[j, :n] = all_diags[op.offsets.index(o)]
    diags_sh = diags.reshape(len(offsets), s, rows).transpose(1, 0, 2)

    r = np.asarray(op.rest_rows, dtype=np.int64)
    c = np.asarray(op.rest_cols, dtype=np.int64)
    d = _np(op.rest_data).astype(np.float64)
    for o in far:
        dk = all_diags[op.offsets.index(o)]
        rr = np.nonzero(dk)[0]
        rr = rr[(rr + o >= 0) & (rr + o < n)]
        r = np.concatenate([r, rr])
        c = np.concatenate([c, rr + o])
        d = np.concatenate([d, dk[rr]])
    row_dev = r // rows
    col_dev = c // rows
    local = row_dev == col_dev

    lrows, lcols, ldata = _pad_by_device(
        row_dev[local],
        [(r[local] % rows).astype(np.int32), (c[local] % rows).astype(np.int32), d[local]], s)

    cross = ~local
    rc, cc, dc = r[cross], c[cross], d[cross]
    if len(rc):
        uc = np.unique(cc)  # sorted, so their owners are too
        owner = uc // rows
        counts = np.bincount(owner, minlength=s)
        L_send = max(1, int(counts.max()))
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(len(uc)) - np.repeat(starts, counts)
        send_idx = np.zeros((s, L_send), np.int32)
        send_idx[owner, slot] = (uc % rows).astype(np.int32)
        buf_pos = owner * L_send + slot  # position in the joined buffer
        pos = buf_pos[np.searchsorted(uc, cc)].astype(np.int32)
        crows, cpos, cdata = _pad_by_device(row_dev[cross],
                                            [(rc % rows).astype(np.int32), pos, dc], s)
    else:
        send_idx = np.zeros((s, 1), np.int32)
        crows, cpos, cdata = (np.zeros((s, 1), np.int32), np.zeros((s, 1), np.int32),
                              np.zeros((s, 1)))

    return _StencilLayout(
        offsets=offsets, bw=bw, rows=rows, n_pad=n_pad, diags=diags_sh,
        lrows=lrows, lcols=lcols, ldata=ldata, send_idx=send_idx,
        crows=crows, cpos=cpos, cdata=cdata,
        has_local=bool(local.any()), has_cross=bool(len(rc)),
    )


def _make_stencil_mv(layout: _StencilLayout, devices):
    """``(values, x blocks) → A x`` blocks: ``values`` are the float tables
    (diagonals, local and cross remainder data) in the run's dtype from
    ``cast(dtype)``; the index tables are built once, on each shard."""
    bw, rows, offsets = layout.bw, layout.rows, layout.offsets
    idx = lambda a: _blocks(a.astype(np.int64), devices)
    lrows, lcols, send_idx = idx(layout.lrows), idx(layout.lcols), idx(layout.send_idx)
    crows, cpos = idx(layout.crows), idx(layout.cpos)
    host = (_blocks(layout.diags, devices), _blocks(layout.ldata, devices),
            _blocks(layout.cdata, devices))

    def cast(dtype):
        return tuple(_cast(t, dtype) for t in host)

    def mv(values, x):
        diags, ldata, cdata = values
        ys = [shift_sum(dg, xe, offsets, bw, rows)
              for dg, xe in zip(diags, halo_extend(x, bw))]
        if layout.has_local:
            for y, xi, lr, lc, ld in zip(ys, x, lrows, lcols, ldata):
                y.index_add_(0, lr, ld[:, None] * xi[lc])
        if layout.has_cross:
            bufs = all_gather([xi[si] for xi, si in zip(x, send_idx)])
            for y, buf, cr, cp, cd in zip(ys, bufs, crows, cpos, cdata):
                y.index_add_(0, cr, cd[:, None] * buf[cp])
        return ys

    return cast, mv


def make_stencil_halo_viscous_solver(device_mesh, op: StencilOperator, interior_mask,
                                     dt_nu: float, iters: int, axis: str = "space"):
    """The distributed (I + Δt·ν·K_masked) CG over stencil storage: the
    iteration of :func:`~tpufem_torch.parallel.halo.make_halo_viscous_solver`
    with the stencil apply.  Returns ``solve(b (N,) or (N, k)) → same
    shape`` in natural node order, on ``b``'s device."""
    devices = device_mesh.axis_devices(axis)
    s = len(devices)
    n = op.n
    layout = build_stencil_layout(op, s)
    rows, n_pad = layout.rows, layout.n_pad
    mask_p = np.zeros(n_pad)
    mask_p[:n] = _np(interior_mask)
    diag_main = np.zeros(n_pad)
    diag_main[:n] = _np(op.diag()).astype(np.float64)
    inv_diag = np.where(mask_p > 0, 1.0 / (1.0 + dt_nu * diag_main), 1.0)
    tables = (_blocks(mask_p.reshape(s, rows, 1), devices),
              _blocks(inv_diag.reshape(s, rows, 1), devices))
    cast, mv = _make_stencil_mv(layout, devices)
    home = op.diags.device
    ident = lambda v: v

    def solve(b):
        values = cast(b.dtype)
        mask, invd = (_cast(t, b.dtype) for t in tables)

        def full_op(x):
            kx = mv(values, [m * xi for m, xi in zip(mask, x)])
            return [m * (xi + dt_nu * k) + (1.0 - m) * xi for m, xi, k in zip(mask, x, kx)]

        b2 = b.to(home).reshape(n, -1)
        pad = torch.zeros((n_pad, b2.shape[1]), dtype=b.dtype, device=home)
        pad[:n] = b2
        x = cg_fixed_blocks(full_op, lambda r: [d * ri for d, ri in zip(invd, r)], ident,
                            _split(pad, devices, rows), iters)
        return _join(x, home)[:n].reshape(b.shape).to(b.device)

    return solve


def make_stencil_halo_pressure_solver(device_mesh, op_merged: StencilOperator, m_lumped,
                                      masters, slaves, active_mask, iters: int,
                                      axis: str = "space"):
    """The distributed merged-periodic pressure Poisson over stencil
    storage: :func:`~tpufem_torch.parallel.halo.make_halo_pressure_solver`'s
    deflated Jacobi-PCG with the stencil apply, natural node order.
    Returns ``solve(b (N,)) → (N,)`` on ``b``'s device."""
    devices = device_mesh.axis_devices(axis)
    s = len(devices)
    n = op_merged.n
    layout = build_stencil_layout(op_merged, s)
    rows, n_pad = layout.rows, layout.n_pad
    act_p = np.zeros(n_pad)
    act_p[:n] = _np(active_mask)
    diag_main = np.zeros(n_pad)
    diag_main[:n] = _np(op_merged.diag()).astype(np.float64)
    inv_diag = np.where(diag_main > 0, 1.0 / np.where(diag_main > 0, diag_main, 1.0), 1.0)
    tables = (_blocks(act_p.reshape(s, rows, 1), devices),
              _blocks(inv_diag.reshape(s, rows, 1), devices))
    cast, mv = _make_stencil_mv(layout, devices)
    home = op_merged.diags.device
    ml, m_idx, s_idx, act = _pressure_index(m_lumped, masters, slaves, active_mask, home)

    def solve(b):
        values = cast(b.dtype)
        w, invd = (_cast(t, b.dtype) for t in tables)
        project = deflation(w)

        rhs = _merge_rhs(b.to(home), ml, m_idx, s_idx, act)
        pad = torch.zeros((n_pad, 1), dtype=b.dtype, device=home)
        pad[:n, 0] = rhs
        x = cg_fixed_blocks(lambda p: mv(values, p), lambda r: [d * ri for d, ri in zip(invd, r)],
                            project, _split(pad, devices, rows), iters)
        p = _join(x, home)[:n, 0]
        if m_idx is not None:
            p = p.index_put((s_idx,), p[m_idx])
        return p.to(b.device)

    return solve
