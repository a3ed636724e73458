"""Single-controller device meshes, their collectives, and the
element-sharded divergence/gradient.

The counterpart of the parts of ``tpufem.parallel.spmd`` that the sharded
grid path uses.  tpufem runs its sharded code as one program over a device
mesh (``shard_map``); the port keeps that single controller: one process
holds a list of per-shard tensors, one for each position of the mesh axis,
and the collectives are plain functions over such lists.  Positions may
share a device: on the CPU the shards all live on ``cpu``, on one card all
on ``cuda:0``; over several cards each shard's tensors live on its card.

* :class:`DeviceMesh` and :func:`build_device_mesh` (tpufem's signature and
  shape rule);
* :func:`psum` and :func:`all_gather` over per-shard lists;
* :func:`_shard_elements`, :func:`_div_local`, :func:`_grad_local`: the
  element-padded shards and their partial nodal sums, by elementwise
  products and ``index_add_``.

tpufem's ensembles (``ShardedEnsemble``, ``MultiMeshEnsemble``,
``run_sharded``) are not ported (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufem_torch import config as tconfig


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A grid of shard positions: ``shape`` maps each axis name to its size,
    ``devices`` holds one device per position in row-major order over
    ``axis_names`` (repeats allowed)."""

    shape: dict
    devices: tuple
    axis_names: tuple = ("data", "space")

    def axis_devices(self, axis: str = "space") -> list[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis.  The
        sharded grid functions run there once; tpufem replicates them over
        the other axes, which compute the same values."""
        sizes = [self.shape[a] for a in self.axis_names]
        grid = np.arange(len(self.devices)).reshape(sizes)
        index = tuple(slice(None) if a == axis else 0 for a in self.axis_names)
        return [self.devices[i] for i in grid[index]]


def _device(d) -> torch.device:
    """``d`` as a device with an explicit index for CUDA; raises for CUDA
    without a card."""
    dev = tconfig.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def build_device_mesh(n_devices: int | None = None, data: int | None = None,
                      devices=None) -> DeviceMesh:
    """A ("data", "space") mesh of ``n_devices`` positions (tpufem's shape
    rule: ``data`` = 2 when the count is even and above 1, else 1).

    ``devices`` lists one device per position (``["cpu"] * 8`` on the CPU,
    ``["cuda:0"] * 4`` for four shards on one card, ``["cuda:0", "cuda:1"]``
    for one on each of two); None means CUDA, the positions going
    round-robin over the visible cards, and raises without one.  All
    positions are on one kind of device."""
    if devices is None:
        tconfig.device(None)  # raises without CUDA
        count = torch.cuda.device_count()
        n = n_devices or count
        devices = [torch.device("cuda", i % count) for i in range(n)]
    devices = [_device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"{n} positions asked for, {len(devices)} devices given")
    devices = devices[:n]
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"a mesh is on one kind of device, not {sorted(set(map(str, devices)))}")
    if data is None:
        data = 2 if n % 2 == 0 and n > 1 else 1
    if n % data:
        raise ValueError(f"{n} positions do not split into {data} data rows")
    return DeviceMesh(shape={"data": data, "space": n // data}, devices=tuple(devices))


def psum(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of the per-shard ``parts``, on every shard: added in shard
    order on shard 0's device, then copied to each shard's device.  Every
    shard gets the same bits, so a test on the sum takes the same branch
    everywhere."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return [total.to(p.device) for p in parts]


def all_gather(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The per-shard ``parts`` concatenated along dim 0, on every shard."""
    dev = parts[0].device
    full = torch.cat([p.to(dev) for p in parts])
    return [full.to(p.device) for p in parts]


# ---------------------------------------------------------------------------
# Element-sharded divergence / gradient (psum-assembled)
# ---------------------------------------------------------------------------


def _shard_elements(mesh, n_shards: int):
    """Element arrays padded to a multiple of ``n_shards`` (pad entries
    invalid, host NumPy): (tris, grads, area, valid)."""
    pad = (-mesh.n_tris) % n_shards
    tris = np.concatenate([mesh.tris, np.zeros((pad, 3), np.int32)])
    grads = np.concatenate([mesh.grads, np.zeros((pad, 3, 2))])
    area = np.concatenate([mesh.area, np.zeros(pad)])
    valid = np.concatenate([mesh.valid, np.zeros(pad, bool)])
    return tris, grads, area, valid


def _lumped_sums(tris, area, valid, per_element, n_nodes):
    """(num, den): the ⅓-area-weighted element values scattered to nodes,
    and the scattered weights.  ``per_element`` is (B, Tl) or (B, Tl, 2)."""
    w = torch.where(valid, area / 3.0, torch.zeros_like(area))
    seg = tris.reshape(-1)
    b, t = per_element.shape[:2]
    q = per_element * (w[None, :, None] if per_element.ndim == 3 else w[None])
    contrib = q[:, :, None].expand(b, t, 3, *q.shape[2:]).reshape(b, 3 * t, *q.shape[2:])
    num = torch.zeros((b, n_nodes) + tuple(q.shape[2:]), dtype=q.dtype, device=q.device)
    num.index_add_(1, seg, contrib)
    den = torch.zeros(n_nodes, dtype=w.dtype, device=w.device)
    den.index_add_(0, seg, w[:, None].expand(t, 3).reshape(-1))
    return num, den


def _div_local(tris, grads, area, valid, u, n_nodes):
    """Partial sums of the lumped divergence of u (B, N, 2) over this
    shard's elements (no normalization): (num (B, N), den (N,))."""
    d = torch.sum(u[:, tris] * grads, dim=2)  # (B, Tl, 2): ∂uₓ/∂x, ∂u_y/∂y
    return _lumped_sums(tris, area, valid, d[..., 0] + d[..., 1], n_nodes)


def _grad_local(tris, grads, area, valid, p, n_nodes):
    """Partial sums of the lumped gradient of p (B, N) over this shard's
    elements: (num (B, N, 2), den (N,))."""
    g = torch.sum(p[:, tris][..., None] * grads, dim=2)  # (B, Tl, 2)
    return _lumped_sums(tris, area, valid, g, n_nodes)
