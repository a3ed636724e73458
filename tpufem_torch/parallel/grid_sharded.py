"""Space-sharded grid-offset CG: the multi-device form of kernels K2 and K3.

The counterpart of ``tpufem.parallel.grid_sharded``.  The grid-offset
operator (:class:`tpufem_torch.ops.gridop.GridOperator`) is sharded over one
axis of a device mesh, as plain tensor code per shard (tpufem's is XLA code
under ``shard_map``, not Pallas):

* the (ns, ns) grid image is cut into row strips, one per shard;
* each offset plane needs a ``dmax = max|dy|``-row halo from the ring
  neighbours, exchanged once per matvec (the cyclic ring reproduces the
  grid's row wrap, the periodic-x coupling included); lane rolls stay
  strip-local; dot products are :func:`~tpufem_torch.parallel.spmd.psum`
  scalars;
* the remainder's sources are gathered by the shard that owns their row
  into a full-length vector that is zero elsewhere and ``psum``'d (exact:
  each entry has one owner); each shard then applies the entries whose
  target row it owns, a contiguous run of the target-sorted COO list;
* the two-level preconditioner's block restriction is taken per shard into
  the full (nc, nc) coarse vector and ``psum``'d (a strip's edges need not
  fall on block edges), the coarse solve runs once, where the problem's
  coarse inverse lives, and is copied to every shard (tpufem repeats it on
  each, with the same inputs), and the prolongation is row-local.

Rounding is that of tpufem's sharded form, not of its single-device
kernels: the remainder and the restriction in the field's precision, only
the coarse product rounded to float32 (``preferred_element_type=float32``).

``halo="ppermute"`` exchanges halos with :func:`_halo_exchange` (neighbours'
rows moved with ``.to`` and joined with ``torch.cat``), ``halo="rdma"`` with
kernel K6 (:mod:`tpufem_torch.parallel.grid_remote_dma`), bit-equal to it.
A halo exchange comes once per viscous iteration, and per two-level
pressure solve of k iterations 3k + 2 times in the CG and twice for the
rhs merge and slave copy-back rolls (k + 2 with Jacobi); under ``"rdma"``
each is one K6 launch on each card of the axis.
"""

from __future__ import annotations

import torch

from tpufem_torch.parallel.spmd import psum
from tpufem_torch.solve.grid_cg import PressureGridCG, ViscousGridCG, _ratio, coarse_product


def _signed_dy(dy: int, ns: int) -> int:
    """Nearest-zero representative of a row offset (ns−1 ≡ −1)."""
    return ((dy + ns // 2) % ns) - ns // 2


def _halo_exchange(x_strips: list[torch.Tensor], d: int) -> list[torch.Tensor]:
    """Each (h, ns) strip → (h+2d, ns) with d rows from each ring neighbour."""
    if d == 0:
        return list(x_strips)
    n = len(x_strips)
    out = []
    for i, x in enumerate(x_strips):
        from_prev = x_strips[(i - 1) % n][-d:].to(x.device)
        from_next = x_strips[(i + 1) % n][:d].to(x.device)
        out.append(torch.cat([from_prev, x, from_next]))
    return out


def _roll_rows(x_strips: list[torch.Tensor], dy: int, halo_fn) -> list[torch.Tensor]:
    """out[iy] = X[(iy+dy) mod ns] across strips, |dy| ≤ 1 (the periodic
    merge / copy-back rolls of the pressure solve)."""
    h = x_strips[0].shape[0]
    return [xh[1 + dy:1 + dy + h] for xh in halo_fn(x_strips, 1)]


def _strips(v: torch.Tensor, devices, h: int) -> list[torch.Tensor]:
    """Row strips of (..., ns, ns) ``v``, shard i's on ``devices[i]``."""
    return [v[..., i * h:(i + 1) * h, :].to(dev).contiguous() for i, dev in enumerate(devices)]


def _gather(x_strips: list[torch.Tensor], device) -> torch.Tensor:
    return torch.cat([x.to(device) for x in x_strips])


def _dot(a: list[torch.Tensor], b: list[torch.Tensor]) -> list[torch.Tensor]:
    return psum([torch.sum(x * y) for x, y in zip(a, b)])


def _target_table(tgt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(distinct targets, (n_targets, k) entry table) of target-sorted
    entries ``tgt``: row t lists the entries of the t-th target, padded with
    ``len(tgt)``, the index of an appended zero.  Summing a row adds each
    target's entries in a fixed order, which a scatter with atomics on CUDA
    does not."""
    targets, counts = torch.unique_consecutive(tgt, return_counts=True)
    k = int(counts.max()) if len(counts) else 0
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(k)
    table = torch.where(slot < counts[:, None], start[:, None] + slot, len(tgt))
    return targets, table


def _make_apply(K, devices, h: int, dmax: int, halo_fn):
    """K·x on per-shard (h, ns) strips, one halo exchange a call."""
    ns, m = K.ns, K.n_rest
    shifts = [(dmax + _signed_dy(dy, ns), s) for dy, s in K.offsets]
    planes = _strips(K.diags, devices, h)
    rest = []
    if m:
        src = K.rest_src.to(torch.int64).cpu()
        tgt = K.rest_tgt.to(torch.int64).cpu()
        ptr = K.rest_rowptr.to(torch.int64).cpu()
        for i, dev in enumerate(devices):
            base = i * h * ns
            own = torch.nonzero((src >= base) & (src < base + h * ns)).flatten()
            lo, hi = int(ptr[i * h]), int(ptr[(i + 1) * h])
            targets, table = _target_table(tgt[lo:hi] - base)
            rest.append(((lo, hi), own.to(dev), (src[own] - base).to(dev), targets.to(dev),
                         table.to(dev), K.rest_vals[lo:hi].to(dev)))

    def apply(x_strips):
        xh = halo_fn(x_strips, dmax)
        ys = []
        for i, pl in enumerate(planes):
            y = None
            for g, (row, s) in enumerate(shifts):
                term = pl[g] * torch.roll(xh[i][row:row + h], -s, dims=1)
                y = term if y is None else y + term
            ys.append(y)
        if m:
            parts = [torch.zeros(m, dtype=x.dtype, device=x.device).index_copy_(
                0, own, x.reshape(-1)[src_local])
                for x, (_, own, src_local, _, _, _) in zip(x_strips, rest)]
            xs = psum(parts)
            for i, ((lo, hi), _, _, targets, table, vals) in enumerate(rest):
                w = vals * xs[i][lo:hi]
                sums = torch.cat([w, w.new_zeros(1)])[table].sum(1)  # per target, no atomics
                r = torch.zeros(h * ns, dtype=w.dtype, device=w.device).index_put_((targets,), sums)
                ys[i] = ys[i] + r.reshape(h, ns)
        return ys

    return apply


def _cg(matvec, precond, project, b, iters: int, tol: float = 0.0):
    """tpufem's sharded ``cg`` on per-shard lists, x0 = 0: (x, iterations).
    ``tol > 0`` exits once the psum'd ‖r‖² is at most (tol·‖b‖)², tested
    on the host each iteration (every shard holds the same sum)."""
    b = project(b)
    x = [torch.zeros_like(v) for v in b]
    r = b
    z = project(precond(r))
    p, rz = z, _dot(r, z)
    atol2 = None
    if tol > 0:
        atol2 = (tol * torch.clamp(torch.sqrt(_dot(b, b)[0]), min=1e-30)) ** 2
    k = 0
    while k < iters and (atol2 is None or bool(_dot(r, r)[0] > atol2)):
        ap = project(matvec(p))
        alpha = [_ratio(a, c) for a, c in zip(rz, _dot(p, ap))]
        x = [xi + al * pi for xi, al, pi in zip(x, alpha, p)]
        r = [ri - al * api for ri, al, api in zip(r, alpha, ap)]
        z = project(precond(r))
        rz_new = _dot(r, z)
        beta = [_ratio(a, c) for a, c in zip(rz_new, rz)]
        p = [zi + be * pi for zi, be, pi in zip(z, beta, p)]
        rz = rz_new
        k += 1
    return project(x), k


def make_sharded_grid_solvers(device_mesh, problem, axis: str = "space",
                              halo: str = "ppermute"):
    """(visc_solve, pressure_solve) sharded over ``axis`` of ``device_mesh``.

    ``problem`` must hold grid solvers (``cg_storage="grid"`` or
    ``"grid_interpret"``).  ``visc_solve(b (N, 2)) → (N, 2)`` and
    ``pressure_solve(b (N,)) → (N,)`` match the single-device
    ``ViscousGridCG.solve`` / ``PressureGridCG.solve`` from zero initial
    guesses, with the solvers' iteration counts, or their ``tol`` early exit
    (the viscous columns as two solves, each with its own exit, as in
    tpufem's sharded form).  Results land on the right-hand side's device.
    A solver's ``iters_count``, when set, has each solve's iterations added
    (both columns' for the viscous solve).

    ``halo``: ``"ppermute"`` (:func:`_halo_exchange`) or ``"rdma"`` (kernel
    K6)."""
    from tpufem_torch.parallel.grid_remote_dma import make_halo_rdma

    visc, pres = problem.visc_solver, problem.pressure_solver
    if not (isinstance(visc, ViscousGridCG) and isinstance(pres, PressureGridCG)):
        raise ValueError("the sharded grid solvers need grid solvers "
                         "(cg_storage='grid' or 'grid_interpret')")
    Kv, Kp = visc.K, pres.K
    ns = Kv.ns
    devices = device_mesh.axis_devices(axis)
    s_ = len(devices)
    if ns % s_:
        raise ValueError(f"ns={ns} must divide over {s_} shards")
    h = ns // s_
    dmax = max([abs(_signed_dy(dy, ns)) for dy, _ in Kv.offsets + Kp.offsets] + [1])
    if halo == "rdma":
        halo_fn = make_halo_rdma(device_mesh, axis)
    elif halo == "ppermute":
        halo_fn = _halo_exchange
    else:
        raise ValueError(f"unknown halo {halo!r}; expected 'ppermute' or 'rdma'")
    if h <= dmax:
        raise ValueError(f"strip height {h} must exceed the halo depth {dmax}: "
                         "use fewer shards or a larger mesh")
    if pres.pair_axis != 0:
        raise ValueError("the sharded grid CG assumes row-axis periodic pairs")

    dt_nu, omega = visc.dt_nu, pres.omega
    apply_v = _make_apply(Kv, devices, h, dmax, halo_fn)
    apply_p = _make_apply(Kp, devices, h, dmax, halo_fn)
    mask = _strips(visc.mask_grid, devices, h)
    invd_v = _strips(visc.inv_diag_grid, devices, h)
    grid = lambda v: _strips(v.reshape(ns, ns), devices, h)
    ml, act, mm, sm = (grid(v) for v in (pres.m_lumped, pres.active_mask, pres.master_mask,
                                         pres.slave_mask))
    invd_p = _strips(pres.inv_diag_grid, devices, h)
    ww = _dot(act, act)
    blk, nc = pres.block, pres.n_blocks
    coarse_dev = pres.ac_inv.device
    row_block = [(torch.arange(i * h, (i + 1) * h) // blk).to(dev) for i, dev in enumerate(devices)]
    # a strip's rows padded out to whole blocks: blocks [b0, b1), pad rows
    # above and below (reshaped sums, no atomics)
    block_span = [(i * h // blk, -(-(i + 1) * h // blk)) for i in range(s_)]

    def visc_mv(x):
        kx = apply_v([m * xi for m, xi in zip(mask, x)])
        return [m * (xi + dt_nu * k) + (1.0 - m) * xi for m, xi, k in zip(mask, x, kx)]

    def jacobi_v(r):
        return [d * ri for d, ri in zip(invd_v, r)]

    def ident(v):
        return v

    def project(x):
        c = _dot(act, x)
        return [xi - (ci / w) * a for xi, ci, w, a in zip(x, c, ww, act)]

    def coarse(t):
        parts = []
        for i, (tb, (b0, b1)) in enumerate(zip(t, block_span)):
            rows = torch.nn.functional.pad(tb, (0, nc * blk - ns, i * h - b0 * blk,
                                                b1 * blk - (i + 1) * h))
            blocks = rows.reshape(b1 - b0, blk, nc * blk).sum(1).reshape(b1 - b0, nc, blk).sum(-1)
            parts.append(torch.nn.functional.pad(blocks, (0, 0, b0, nc - b1)))
        rc = psum(parts)[0]
        z = coarse_product(pres, rc.reshape(-1).to(coarse_dev)).to(rc.dtype).reshape(nc, nc)
        return [z.to(a.device)[rb].repeat_interleave(blk, 1)[:, :ns] * a
                for rb, a in zip(row_block, act)]

    def precond(r):
        if not pres.use_coarse:
            return [d * ri for d, ri in zip(invd_p, r)]
        z1 = [omega * (d * ri) for d, ri in zip(invd_p, r)]
        c = coarse([ri - ai for ri, ai in zip(r, apply_p(z1))])
        z2 = [a + b for a, b in zip(z1, c)]
        return [z + omega * (d * (ri - ai)) for z, d, ri, ai in zip(z2, invd_p, r, apply_p(z2))]

    def visc_solve(b):
        cols, total = [], 0
        for c in range(b.shape[1]):
            x, k = _cg(visc_mv, jacobi_v, ident, grid(b[:, c]), visc.iters, visc.tol)
            cols.append(_gather(x, b.device).reshape(-1))
            total += k
        if visc.iters_count is not None:
            visc.iters_count.add_(total)
        return torch.stack(cols, dim=1)

    def pressure_solve(b):
        rhs = [m * v for m, v in zip(ml, grid(b))]
        rolled = _roll_rows([v * s for v, s in zip(rhs, sm)], -1, halo_fn)
        rhs = [(v + q * m) * a for v, q, m, a in zip(rhs, rolled, mm, act)]
        p, k = _cg(apply_p, precond, project, rhs, pres.iters, pres.tol)
        back = _roll_rows([v * m for v, m in zip(p, mm)], 1, halo_fn)
        if pres.iters_count is not None:
            pres.iters_count.add_(k)
        return _gather([v * (1.0 - s) + q * s for v, q, s in zip(p, back, sm)],
                       b.device).reshape(-1)

    return visc_solve, pressure_solve
