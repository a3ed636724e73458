"""Carry a problem or a state across from NumPy arrays.

The arrays come from any source that lays them out under the port's field
paths, for instance the JAX package's ``StokesProblem`` flattened with its
``_extract_arrays`` plus its boundary index sets and locator tables.  The
port then steps exactly the operators another build produced:

    ``visc_solver.lu`` + ``visc_solver.piv`` (SciPy 0-based pivots) or
    ``visc_solver.inv``; the same under ``pressure_solver.``;
    ``m_lumped``, ``div_x``, ``div_y``; optionally ``fused_M``,
    ``fused_b``, ``fused_Dstar``, ``fused_dstar0`` and ``visc_lift``;
    ``boundary.<walls|inner|dirichlet|interior|masters|slaves>``;
    ``inner_values``; for transport ``locator.<cells|rows|origin|extent|g>``;
    for tracers ``tracer_init``.

Operator arrays keep their own dtype on the device; the arrays are copied,
so read-only inputs (such as views of JAX arrays) are fine.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufem_torch import bc, transport
from tpufem_torch import config as tconfig
from tpufem_torch.mesh.core import Mesh
from tpufem_torch.solve.dense import DenseInverse, DenseLU
from tpufem_torch.workloads.stokes import StokesConfig, StokesProblem, check_config


def _solver(arrays: dict, prefix: str, device):
    if f"{prefix}.inv" in arrays:
        return DenseInverse(inv=torch.as_tensor(np.array(arrays[f"{prefix}.inv"]), device=device))
    lu = np.array(arrays[f"{prefix}.lu"])
    return DenseLU.from_scipy(lu, arrays[f"{prefix}.piv"], dtype=torch.as_tensor(lu).dtype,
                              device=device)


def problem_from_numpy(arrays: dict[str, np.ndarray], mesh: Mesh, config: StokesConfig,
                       device=None) -> StokesProblem:
    """A port ``StokesProblem`` holding the given operator arrays."""
    check_config(config)
    dev = tconfig.device(device)
    boundary = bc.ChannelBoundary(**{
        f.name: np.asarray(arrays[f"boundary.{f.name}"])
        for f in dataclasses.fields(bc.ChannelBoundary)
    })
    locator = None
    if config.transport != "none":
        locator = transport.GridLocator.from_tables(
            mesh, arrays["locator.cells"], arrays["locator.origin"], arrays["locator.extent"],
            int(arrays["locator.g"]), rows=arrays["locator.rows"],
            dtype=tconfig.dtype(config.precision), device=dev,
        )

    def dev_array(key):
        return None if key not in arrays else torch.as_tensor(np.array(arrays[key]), device=dev)

    fused = None
    if "fused_M" in arrays:
        fused = tuple(dev_array(k) for k in ("fused_M", "fused_b", "fused_Dstar", "fused_dstar0"))
    return StokesProblem.from_host(
        mesh, config, dev,
        boundary=boundary,
        visc_solver=_solver(arrays, "visc_solver", dev),
        pressure_solver=_solver(arrays, "pressure_solver", dev),
        inner_values=np.asarray(arrays["inner_values"]),
        m_lumped=dev_array("m_lumped"),
        div_xy=(dev_array("div_x"), dev_array("div_y")),
        fused=fused,
        visc_lift=dev_array("visc_lift"),
        locator=locator,
        tracer_init=None if "tracer_init" not in arrays else np.asarray(arrays["tracer_init"]),
    )


def state_from_numpy(state: dict[str, np.ndarray], device=None) -> dict[str, torch.Tensor]:
    """A state dict on ``device``; each array keeps its dtype."""
    dev = tconfig.device(device)
    return {k: torch.as_tensor(np.array(v), device=dev) for k, v in state.items()}


def state_to_numpy(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A state dict as host NumPy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}
