"""The Navier–Stokes step's per-step refill of C(u): kernels E and G.

Each step rebuilds the advection operator C(u) on the velocity operator's
offset planes in two calls, ``GridRefill.refill_flat(
assembly.element_convection_flat(mesh, u, variant))``.  On CUDA tensors
those two functions launch the kernels of ``csrc/ns_refill.cu``; on CPU
tensors they run their plain PyTorch code.

* E, :func:`convection_flat`: the (9·T,) k-major element values of C(u)
  from the element constants of ``assembly.convection_constants`` (tris
  (3, T) int32; gx0, gy0, gx1, gy1, gx2, gy2, row (7, T)) and u (N, 2).
  Its plain version is ``assembly.element_convection_flat_ref``.
* G, :func:`segment_sum`: each slot's run of ``vals[index[ptr[s]:ptr[s+1]]]``
  summed from 0 in that order; empty runs give 0.  ``GridRefill.segments``
  builds index and ptr from the refill's slot map.
  :func:`segment_sum_ref` is the same order in PyTorch.

The wrappers take CUDA tensors only and raise on anything the kernels do
not take (device, dtype, shape, contiguity, alignment); there is no
fallback.  Each counts its launches in ``.launches``.  The library is
compiled at first use with ``nvcc`` (``ops/_nvcc.py``) and loaded with
``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from tpufem_torch.ops import _nvcc

SOURCE = _nvcc.CSRC / "ns_refill.cu"
_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_lib: ctypes.CDLL | None = None  # the loaded kernel library, once built


def library_path():
    """Where the library built from the current source and flags lives."""
    return _nvcc.library_path(SOURCE)


def build() -> ctypes.CDLL:
    """Compile the kernel library unless a build of this source is cached,
    load it and return it (the ptxas report lands beside it as ``.log``)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _nvcc.build(SOURCE)
    for kernel in ("convection_flat", "segment_sum"):
        for suffix in _DTYPES.values():
            fn = getattr(lib, f"ns_{kernel}_{suffix}")
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _device(name: str, **tensors) -> torch.device:
    """The one CUDA device of ``tensors``, each contiguous."""
    for k, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} is not contiguous")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name} takes tensors on one CUDA device; got "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    return next(iter(devices))


def _launch(symbol: str, dev: torch.device, *args) -> None:
    lib = _lib or build()
    with torch.cuda.device(dev):
        # the raw handle: building a torch.cuda.Stream object costs ~7 µs a call
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        err = getattr(lib, symbol)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")


def convection_flat(tris: torch.Tensor, geo: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Kernel E: (9·T,) k-major convection values, entry ``(3i + j)·T + t``
    = row_t · (ū_t · ∇̃φ_j), from ``tris`` (3, T) int32, ``geo`` (7, T) and
    ``u`` (N, 2) in ``geo``'s dtype, all contiguous on one CUDA device.
    The indices are not checked against N: ``assembly`` builds them."""
    if u.dtype not in _DTYPES or tris.dtype != torch.int32 or geo.dtype != u.dtype:
        raise TypeError(f"convection_flat takes int32 tris, and geo and u in float32 or "
                        f"float64; got {tris.dtype}, {geo.dtype}, {u.dtype}")
    if tris.ndim != 2 or tris.shape[0] != 3 or geo.shape != (7, tris.shape[1]) \
            or u.ndim != 2 or u.shape[1] != 2:
        raise ValueError(f"convection_flat takes tris (3, T), geo (7, T), u (N, 2); got "
                         f"{tuple(tris.shape)}, {tuple(geo.shape)}, {tuple(u.shape)}")
    if u.data_ptr() % (2 * u.element_size()):
        raise ValueError("convection_flat reads u's rows as pairs: u must start on a "
                         f"{2 * u.element_size()}-byte boundary")
    dev = _device("convection_flat", tris=tris, geo=geo, u=u)
    n = tris.shape[1]
    out = torch.empty(9 * n, dtype=u.dtype, device=dev)
    _launch(f"ns_convection_flat_{_DTYPES[u.dtype]}", dev, tris.data_ptr(), geo.data_ptr(),
            u.data_ptr(), out.data_ptr(), n)
    convection_flat.launches += 1
    return out


convection_flat.launches = 0


def segment_sum(vals: torch.Tensor, index: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """Kernel G: (n,) slot sums, slot s = Σ ``vals[index[k]]`` for k from
    ``ptr[s]`` to ``ptr[s+1]``, added from 0 in that order; ``vals`` (E,)
    float, ``index`` (E,) int32 (a permutation of vals' positions, as
    ``GridRefill.segments`` gives), ``ptr`` (n + 1,) int32, all contiguous
    on one CUDA device.  The indices are not checked: reading them would
    cost a synchronise."""
    if vals.dtype not in _DTYPES or index.dtype != torch.int32 or ptr.dtype != torch.int32:
        raise TypeError(f"segment_sum takes vals in float32 or float64 and int32 index and "
                        f"ptr; got {vals.dtype}, {index.dtype}, {ptr.dtype}")
    if vals.ndim != 1 or index.shape != vals.shape or ptr.ndim != 1 or ptr.numel() < 1:
        raise ValueError(f"segment_sum takes vals (E,), index (E,), ptr (n + 1,); got "
                         f"{tuple(vals.shape)}, {tuple(index.shape)}, {tuple(ptr.shape)}")
    dev = _device("segment_sum", vals=vals, index=index, ptr=ptr)
    n = ptr.numel() - 1
    out = torch.empty(n, dtype=vals.dtype, device=dev)
    _launch(f"ns_segment_sum_{_DTYPES[vals.dtype]}", dev, vals.data_ptr(), index.data_ptr(),
            ptr.data_ptr(), out.data_ptr(), n)
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


def segment_sum_ref(vals: torch.Tensor, index: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_sum`, on any device: the
    k-th entry of every run with more than k entries added in turn."""
    start = ptr[:-1].long()
    count = ptr[1:].long() - start
    out = torch.zeros(len(start), dtype=vals.dtype, device=vals.device)
    for k in range(int(count.max()) if len(start) else 0):
        live = torch.nonzero(count > k).squeeze(1)
        out[live] = out[live] + vals[index[start[live] + k].long()]
    return out
