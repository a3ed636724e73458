"""Global configuration: reference meshes, dtype policy, device choice.

Host-side set-up (mesh, boundary discovery, assembly, inverses, the fused
step composition) always runs in NumPy/SciPy float64; only the finished
operators are moved to the device in the run's dtype.
"""

from __future__ import annotations

import os

import torch

# Root of a checkout of the reference project whose bundled Triangle meshes
# serve as inputs.  Data assets only, never code.  Unset: no reference
# meshes, and callers fall back to generated meshes.
REFERENCE_DIR = os.environ.get("TPUFEM_REFERENCE_DIR")

# "f64" is the parity mode, "f32" the fast mode; "bf16" runs the Stokes
# workload's fused dense step only (``workloads.stokes.check_config``).
DTYPES = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}


def reference_mesh_path(name: str) -> str | None:
    """Resolve a bundled reference mesh stem (e.g. ``mesh.1``) to a path,
    or None when the reference checkout or the mesh is absent."""
    if not REFERENCE_DIR:
        return None
    for stem in (
        os.path.join(REFERENCE_DIR, "code", "mesh", name),
        os.path.join(REFERENCE_DIR, "resources", name),
    ):
        if os.path.exists(stem + ".node"):
            return stem
    return None


def dtype(precision: str, bf16: bool = True) -> torch.dtype:
    """The device dtype of a precision name.  ``bf16=False`` refuses "bf16":
    the workloads other than Stokes have no bf16 path (tpufem runs them at
    f64 under "bf16", which the port does not copy)."""
    if precision == "bf16" and not bf16:
        raise ValueError("precision='bf16' runs only the Stokes workload's fused dense step; "
                         "use 'f64' or 'f32' here")
    try:
        return DTYPES[precision]
    except KeyError:
        raise ValueError(f"unknown precision {precision!r}; expected 'f64', 'f32' or "
                         "'bf16'") from None


def device(name: str | torch.device | None = None) -> torch.device:
    """The device to run on.

    ``None`` means CUDA: the port runs on the card unless the caller asks
    for the CPU by name.  A CUDA device must exist: this raises rather than
    falling back to the CPU."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} was asked for but CUDA is not available")
    return dev
