"""The dense regime's fused-step matvec ``y = M @ x + b`` (kernel K1).

``M`` is the host-composed (2N, 2N) whole-step matrix of
``workloads.stokes._compose_fused_step``; one call is one Stokes step.

* :func:`fused_step_matvec_ref` is the plain PyTorch version
  (``torch.addmv``).  The CPU tests use it, and the wrapper takes it for
  tensors on the CPU.
* :func:`fused_step_matvec` launches the hand-written Hopper kernel in
  ``csrc/fused_step_matvec.cu`` for CUDA tensors, or raises.  It counts its
  kernel launches in ``fused_step_matvec.launches``.

The kernel is compiled at first use with ``nvcc`` into a shared library
with a plain C interface under ``tpufem_torch/_build/``, keyed by a hash of
its source and flags (``ops/_nvcc.py``), and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from tpufem_torch.ops import _nvcc

SOURCE = _nvcc.CSRC / "fused_step_matvec.cu"
_SYMBOLS = {torch.float32: "fused_step_matvec_f32", torch.float64: "fused_step_matvec_f64"}
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
    for name in _SYMBOLS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def fused_step_matvec_ref(M: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``b + M @ x``."""
    return torch.addmv(b, M, x)


def _check(M: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> None:
    if M.ndim != 2 or x.ndim != 1 or b.ndim != 1:
        raise ValueError(f"need M (R, C), x (C,), b (R,); got {tuple(M.shape)}, "
                         f"{tuple(x.shape)}, {tuple(b.shape)}")
    R, C = M.shape
    if x.shape[0] != C or b.shape[0] != R:
        raise ValueError(f"shape mismatch: M {tuple(M.shape)}, x {tuple(x.shape)}, "
                         f"b {tuple(b.shape)}")
    if M.dtype not in _SYMBOLS or x.dtype != M.dtype or b.dtype != M.dtype:
        raise TypeError(f"need one dtype of float32/float64; got {M.dtype}, "
                        f"{x.dtype}, {b.dtype}")
    if not (M.device == x.device == b.device):
        raise ValueError(f"tensors on different devices: {M.device}, {x.device}, {b.device}")


def fused_step_matvec(M: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``y = M @ x + b``: the K1 kernel on CUDA tensors, the plain version
    on CPU tensors.  Raises for any other device, for mixed devices, dtypes
    or shapes, and for non-contiguous CUDA operands."""
    _check(M, x, b)
    if M.device.type == "cpu":
        return fused_step_matvec_ref(M, x, b)
    if M.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {M.device}")
    if not (M.is_contiguous() and x.is_contiguous() and b.is_contiguous()):
        raise ValueError("K1 needs contiguous (row-major) operands")
    lib = _lib or build()
    y = torch.empty_like(b)
    R, C = M.shape
    with torch.cuda.device(M.device):
        # the raw handle: building a torch.cuda.Stream object costs ~7 µs a call
        stream = torch._C._cuda_getCurrentRawStream(M.device.index)
        err = getattr(lib, _SYMBOLS[M.dtype])(
            M.data_ptr(), x.data_ptr(), b.data_ptr(), y.data_ptr(), R, C, stream
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    fused_step_matvec.launches += 1
    return y


fused_step_matvec.launches = 0
