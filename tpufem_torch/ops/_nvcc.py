"""Build the port's CUDA sources into shared libraries with ``nvcc``.

Each source under ``tpufem_torch/csrc/`` becomes its own shared library
with a plain C interface, loaded with ``ctypes``:

* the library's path is ``_build/<name>-<hash>.so``, the hash taken over
  the source and the flags, so an edit or a flag change builds anew;
* nvcc's ``-Xptxas -v`` report (registers, shared memory, spills of each
  kernel instance) is kept beside it with the suffix ``.log``;
* the library is compiled to a temporary file and moved into place with an
  atomic replace, so a concurrent build sees a whole file or none.

:func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each instance
)

_loaded: dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: Path, flags=NVCC_FLAGS) -> Path:
    """Where the library built from ``source`` with ``flags`` lives."""
    key = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{key}.so"


def _compile(source: Path, path: Path, flags) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([nvcc(), *flags, "-o", tmp, str(source)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed building {source.name}:\n{res.stderr}")
        path.with_suffix(".log").write_text(res.stderr)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build(source: Path, flags=NVCC_FLAGS) -> ctypes.CDLL:
    """Compile ``source`` unless a build of it is cached, load it (once per
    process) and return the library."""
    path = library_path(source, flags)
    with _lock:
        lib = _loaded.get(path)
    if lib is not None:
        return lib
    if not path.exists():
        _compile(source, path, flags)
    with _lock:
        return _loaded.setdefault(path, ctypes.CDLL(str(path)))


def build_all(sources, flags=NVCC_FLAGS) -> list[ctypes.CDLL]:
    """Build several sources, one ``nvcc`` for each, all started together."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        futures = [pool.submit(build, s, flags) for s in sources]
        return [f.result() for f in futures]
