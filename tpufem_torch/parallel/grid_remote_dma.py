"""The ring halo exchange of the sharded grid solvers: kernel K6.

The counterpart of ``tpufem.parallel.grid_remote_dma``, the drop-in halo of
:func:`tpufem_torch.parallel.grid_sharded.make_sharded_grid_solvers` under
``halo="rdma"``.  Each shard of the "space" axis owns an ``(h, ns)`` strip
of the ``(ns, ns)`` grid image; the halo extends it to ``(h + 2d, ns)`` with
the last ``d`` rows of the previous shard above and the first ``d`` rows of
the next one below, cyclically.

* :func:`halo_rdma_ref` is the plain version (``torch.cat``, the same
  function as ``grid_sharded._halo_exchange``).
* :func:`halo_rdma` launches the hand-written kernel in ``csrc/halo_rdma.cu``
  for CUDA strips, one launch for the strips of each card, each shard
  pushing its centre and edges through the per-shard output pointers
  (tpufem's remote DMAs; into another card's outputs through peer access);
  it takes the plain version for CPU strips and raises for anything else.
  It counts its launches in ``halo_rdma.launches``.
* :func:`make_halo_rdma` binds it to a device mesh's axis.

tpufem's kernel barriers with both neighbours and waits on two receive
semaphores.  On one card the stream orders the launch after the writes of
every strip and the allocation of every output, which gives both.  Across
cards each card's stream first waits on an event recorded on every other
card's stream after its outputs were allocated (so no push lands in memory
a pending kernel there still reads: the barrier), and after the launches
each card's stream waits on the events of every launch (the semaphores).
tpufem caches one Pallas instance per ``(h, ns, d, dtype)`` because each
carries its own traced program and barrier semaphore (collective id); the
CUDA kernel is one compiled library for every shape and needs no
semaphore, so there is nothing to cache.

The library is compiled at first use with ``nvcc`` (``ops/_nvcc.py``) and
loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from tpufem_torch.ops import _nvcc
from tpufem_torch.parallel.grid_sharded import _halo_exchange
from tpufem_torch.solve.grid_cg import _device_ok, _launch

SOURCE = _nvcc.CSRC / "halo_rdma.cu"
MAX_SHARDS = 64  # kMaxShards in the source: the pointer table lives in parameter space
_SYMBOLS = {torch.float32: "halo_rdma_f32", torch.float64: "halo_rdma_f64"}
_lib: ctypes.CDLL | None = None


def build() -> ctypes.CDLL:
    """Compile (unless cached) and load the K6 library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _nvcc.build(SOURCE)
    for name in _SYMBOLS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p)] * 2 + [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int] + [ctypes.c_int64] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.halo_rdma_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.halo_rdma_enable_peer.restype = ctypes.c_int
    _lib = lib
    return lib


def library_path():
    return _nvcc.library_path(SOURCE)


def halo_rdma_ref(x_strips: list[torch.Tensor], d: int) -> list[torch.Tensor]:
    """Plain K6: each ``(h, ns)`` strip → ``(h + 2d, ns)`` with ``d`` rows
    from each ring neighbour (``grid_sharded._halo_exchange``)."""
    return _halo_exchange(x_strips, d)


def _check(x_strips: list[torch.Tensor], d: int) -> tuple[int, int]:
    if not x_strips:
        raise ValueError("K6 needs at least one strip")
    x0 = x_strips[0]
    if x0.ndim != 2:
        raise ValueError(f"need (h, ns) strips, got {tuple(x0.shape)}")
    h, ns = x0.shape
    for x in x_strips:
        if x.shape != x0.shape or x.dtype != x0.dtype or x.device.type != x0.device.type:
            raise ValueError("K6 needs strips of one shape and dtype on one kind of device; got "
                             f"{[(tuple(x.shape), x.dtype, str(x.device)) for x in x_strips]}")
    if not 0 <= d <= h:
        raise ValueError(f"halo depth {d} must lie in [0, h = {h}]")
    return h, ns


def halo_rdma(x_strips: list[torch.Tensor], d: int) -> list[torch.Tensor]:
    """K6 on a ring of ``(h, ns)`` strips, shard ``i`` at position ``i``:
    the kernel on CUDA strips (float32 or float64, at most
    :data:`MAX_SHARDS`; one launch for each card that holds strips), the
    plain version on CPU strips."""
    h, ns = _check(x_strips, d)
    if d == 0:
        return list(x_strips)
    x0 = x_strips[0]
    if not _device_ok(x0, "K6"):
        return halo_rdma_ref(x_strips, d)
    if x0.dtype not in _SYMBOLS:
        raise TypeError(f"K6 runs on float32 or float64 strips, not {x0.dtype}")
    n = len(x_strips)
    if n > MAX_SHARDS:
        raise ValueError(f"K6 takes at most {MAX_SHARDS} shards in one call, got {n}")
    lib = _lib or build()
    xs = [x.contiguous() for x in x_strips]
    outs = [torch.empty((h + 2 * d, ns), dtype=x0.dtype, device=x.device) for x in xs]
    cards = list(dict.fromkeys(x.device for x in xs))
    multi = len(cards) > 1
    if multi:
        _enable_peers(lib, xs)
        allocated = [_record(card) for card in cards]  # the barrier: every out exists
    table = ctypes.c_void_p * n
    x_ptrs, out_ptrs = table(*[x.data_ptr() for x in xs]), table(*[o.data_ptr() for o in outs])
    launched = []
    for card in cards:
        local = [i for i, x in enumerate(xs) if x.device == card]
        if multi:
            _wait(card, allocated)
        _launch(getattr(lib, _SYMBOLS[x0.dtype]), card, x_ptrs, out_ptrs, n,
                (ctypes.c_int * len(local))(*local), len(local), h, ns, d)
        halo_rdma.launches += 1
        if multi:
            launched.append(_record(card))
    for card in cards if multi else ():  # the receive semaphores: every push has landed
        _wait(card, launched)
    return outs


halo_rdma.launches = 0


def _record(card: torch.device) -> torch.cuda.Event:
    """An event at the current end of ``card``'s current stream."""
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(card))
    return event


def _wait(card: torch.device, events) -> None:
    stream = torch.cuda.current_stream(card)
    for event in events:
        stream.wait_event(event)


_peers: set = set()  # (card, peer) pairs with peer access enabled in this process


def _enable_peers(lib, xs: list[torch.Tensor]) -> None:
    """Peer access from each shard's card to its two ring neighbours' cards,
    once per pair; raises where the cards cannot reach each other."""
    n = len(xs)
    for i, x in enumerate(xs):
        for j in ((i - 1) % n, (i + 1) % n):
            pair = (x.device.index, xs[j].device.index)
            if pair[0] == pair[1] or pair in _peers:
                continue
            err = lib.halo_rdma_enable_peer(*pair)
            if err != 0:
                raise RuntimeError(f"K6: card {pair[0]} cannot store into card {pair[1]} "
                                   f"(peer access, CUDA error {err})")
            _peers.add(pair)


def make_halo_rdma(device_mesh, axis: str = "space"):
    """``halo(x_strips, d) → out_strips`` over ``axis`` of ``device_mesh``:
    :func:`halo_rdma` on the strips of that axis's shards, each on its
    shard's device (tpufem's ``make_halo_rdma``, called there inside
    ``shard_map``)."""
    devices = device_mesh.axis_devices(axis)

    def halo(x_strips, d: int):
        if len(x_strips) != len(devices) or any(
                x.device != dev for x, dev in zip(x_strips, devices)):
            raise ValueError(f"need one strip on each of the {len(devices)} {axis!r} shards' "
                             f"devices {[str(v) for v in devices]}")
        return halo_rdma(x_strips, d)

    return halo
