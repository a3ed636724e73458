"""Distributed matrix-free CG over a node-partitioned CSR operator.

The counterpart of ``tpufem.parallel.dist_cg``: nodal DOFs are cut into
contiguous row blocks over one axis of a device mesh, each shard owning its
CSR row slab.  Per CG iteration:

* SpMV: ``all_gather`` of the partitioned vector (a full gather: every P1
  row touches few off-block columns), then a local gather → multiply →
  ``index_add_`` over the owned rows;
* dot products: local partial sums, ``psum``'d.

Plain tensor code per shard; numerics are the single-device solver's up to
summation order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufem_torch.ops.sparse import CSROperator
from tpufem_torch.parallel.spmd import all_gather, psum
from tpufem_torch.solve.grid_cg import _ratio


@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """Row-partitioned CSR with equal-size padded shards.

    Each shard holds E entry slots (the largest slab; pad slots have zero
    data, column 0 and scatter into the shard's last row) over
    ``rows_per_shard`` rows."""

    row_of_entry: np.ndarray  # (s, E) local row index of each entry
    indices: np.ndarray  # (s, E) global column ids
    data: torch.Tensor  # (s, E)
    rows_per_shard: int
    n: int

    @classmethod
    def build(cls, op: CSROperator, n_shards: int) -> "ShardedCSR":
        n = op.shape[0]
        rows_per = -(-n // n_shards)
        row_ids = op.row_ids
        ptr = np.asarray(op.indptr)
        slabs = []
        for s in range(n_shards):
            r0, r1 = s * rows_per, min((s + 1) * rows_per, n)
            slabs.append((r0, ptr[min(r0, n)], ptr[r1]))
        max_e = max(e1 - e0 for _, e0, e1 in slabs)
        roe = np.full((n_shards, max_e), rows_per - 1, dtype=np.int32)
        idx = np.zeros((n_shards, max_e), dtype=np.int32)
        data = op.data.detach().cpu()
        dat = torch.zeros((n_shards, max_e), dtype=data.dtype)
        for s, (r0, e0, e1) in enumerate(slabs):
            k = e1 - e0
            roe[s, :k] = row_ids[e0:e1] - r0
            idx[s, :k] = op.indices[e0:e1]
            dat[s, :k] = data[e0:e1]
        return cls(row_of_entry=roe, indices=idx, data=dat, rows_per_shard=rows_per, n=n)


def _local_spmv(shard_roe, shard_idx, shard_data, x_full, rows_per):
    """One shard's row-slab SpMV: (E,) entries, x_full (N_pad, k) → (rows_per, k)."""
    gathered = shard_data[:, None] * x_full[shard_idx]
    out = torch.zeros((rows_per, x_full.shape[1]), dtype=gathered.dtype, device=gathered.device)
    return out.index_add_(0, shard_roe, gathered)


def make_sharded_viscous_solver(device_mesh, K: CSROperator, interior_mask, dt_nu: float,
                                iters: int, axis: str = "space"):
    """The distributed solve of (I + Δt·ν·K_masked), tpufem's
    ``make_sharded_viscous_solver``: ``solve(b (N, k) or (N,))`` → the same
    shape, on b's device, by ``iters`` CG iterations from zero with the
    Jacobi preconditioner; one step length for all columns (the dots sum
    over them)."""
    devices = device_mesh.axis_devices(axis)
    s = len(devices)
    sh = ShardedCSR.build(K, s)
    rows_per, n = sh.rows_per_shard, sh.n
    n_pad = rows_per * s
    mask_pad = np.zeros(n_pad)
    mask_pad[:n] = np.asarray(interior_mask)
    diag = np.zeros(n_pad)
    rid = K.row_ids
    dnp = K.data.detach().cpu().double().numpy()
    is_diag = rid == K.indices
    np.add.at(diag, rid[is_diag], dnp[is_diag])
    inv_diag = np.where(mask_pad > 0, 1.0 / (1.0 + dt_nu * diag), 1.0)
    dtype = K.data.dtype

    def per_shard(a, dt):
        return [torch.as_tensor(np.asarray(a[i]), dtype=dt, device=dev)
                for i, dev in enumerate(devices)]

    roe = per_shard(sh.row_of_entry.astype(np.int64), torch.int64)
    idx = per_shard(sh.indices.astype(np.int64), torch.int64)
    data = [sh.data[i].to(dev) for i, dev in enumerate(devices)]
    mask = [m[:, None] for m in per_shard(mask_pad.reshape(s, rows_per), dtype)]
    invd = [d[:, None] for d in per_shard(inv_diag.reshape(s, rows_per), dtype)]

    def full_op(x):
        xm = [m * xi for m, xi in zip(mask, x)]
        kx = [_local_spmv(*args, rows_per)
              for args in zip(roe, idx, data, all_gather(xm))]
        return [m * (xi + dt_nu * k) + (1.0 - m) * xi for m, xi, k in zip(mask, x, kx)]

    def dot(a, c):
        return psum([torch.sum(ai * ci) for ai, ci in zip(a, c)])

    def solve(b):
        b2 = b.reshape(n, -1)
        pad = torch.zeros((n_pad, b2.shape[1]), dtype=b2.dtype, device=b2.device)
        pad[:n] = b2
        bl = [pad[i * rows_per:(i + 1) * rows_per].to(dev) for i, dev in enumerate(devices)]
        x = [torch.zeros_like(v) for v in bl]
        r = [bi - ai for bi, ai in zip(bl, full_op(x))]
        z = [d * ri for d, ri in zip(invd, r)]
        p, rz = z, dot(r, z)
        for _ in range(iters):
            ap = full_op(p)
            alpha = [_ratio(a, c) for a, c in zip(rz, dot(p, ap))]
            x = [xi + al * pi for xi, al, pi in zip(x, alpha, p)]
            r = [ri - al * api for ri, al, api in zip(r, alpha, ap)]
            z = [d * ri for d, ri in zip(invd, r)]
            rz_new = dot(r, z)
            beta = [_ratio(a, c) for a, c in zip(rz_new, rz)]
            p = [zi + be * pi for zi, be, pi in zip(z, beta, p)]
            rz = rz_new
        return torch.cat([xi.to(b.device) for xi in x])[:n].reshape(b.shape)

    return solve
