"""Carry a problem or a state across from NumPy arrays.

The arrays come from any source that lays them out under the port's field
paths, for instance the JAX package's ``StokesProblem`` flattened with its
``_extract_arrays`` plus its boundary index sets and locator tables.  The
port then steps exactly the operators another build produced.

Dense regime:

    ``visc_solver.lu`` + ``visc_solver.piv`` (SciPy 0-based pivots) or
    ``visc_solver.inv``; the same under ``pressure_solver.``;
    ``div_x``, ``div_y``; optionally ``fused_M``, ``fused_b``,
    ``fused_Dstar``, ``fused_dstar0`` and ``visc_lift``.

Scale regime, grid storage (``solver="cg"``), with the JAX package's
grid-operator layout (its one-hot remainder is turned back into the port's
COO list):

    ``<op>.diags``, ``<op>.offsets`` ((n_off, 2) of (dy, s)), ``<op>.n_rest``,
    ``<op>.gr_rowT``, ``<op>.gr_laneT``, ``<op>.sc_row``, ``<op>.sc_laneT``,
    ``<op>.rest_vals`` and optionally ``<op>.coverage``, for ``<op>`` =
    ``visc_solver.K`` and ``pressure_solver.K``; ``visc_solver.interior_mask``;
    ``pressure_solver.<m_lumped|active_mask|master_mask|slave_mask|ac_inv>``,
    ``pressure_solver.Pr`` (the block size and count are read off it),
    ``pressure_solver.omega`` (taken as is) and ``pressure_solver.pair_axis``;
    ``mf_dx.<indptr|indices|data>`` and the same under ``mf_dy.`` for
    div/grad.

Both: ``m_lumped``; ``boundary.<walls|inner|dirichlet|interior|masters|slaves>``;
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
from tpufem_torch.ops.gridop import GridOperator
from tpufem_torch.ops.sparse import CSROperator
from tpufem_torch.solve.dense import DenseInverse, DenseLU
from tpufem_torch.solve.grid_cg import PressureGridCG, ViscousGridCG
from tpufem_torch.workloads.stokes import StokesConfig, StokesProblem, check_config


def _tensor(a, device) -> torch.Tensor:
    """A copy of ``a`` on ``device`` in its own dtype (bfloat16 included)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # NumPy's bfloat16 extension type
        return torch.as_tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.as_tensor(a, device=device)


def _grid_operator(arrays: dict, prefix: str, device) -> GridOperator:
    diags = np.array(arrays[f"{prefix}.diags"])
    ns = diags.shape[-1]
    m = int(arrays[f"{prefix}.n_rest"])
    onehot = lambda key: np.asarray(arrays[f"{prefix}.{key}"])
    src = onehot("gr_rowT")[:m].argmax(1) * ns + onehot("gr_laneT")[:m].argmax(1)
    tgt = onehot("sc_row")[:, :m].argmax(0) * ns + onehot("sc_laneT")[:m].argmax(1)
    return GridOperator.from_parts(
        ns, np.asarray(arrays[f"{prefix}.offsets"]).tolist(), diags, tgt, src,
        onehot("rest_vals")[:m, 0], coverage=float(arrays.get(f"{prefix}.coverage", np.nan)),
        dtype=torch.as_tensor(diags).dtype, device=device,
    )


def _grid_solvers(arrays: dict, config: StokesConfig, device):
    plain = config.cg_storage == "grid_interpret"
    visc = ViscousGridCG(
        K=_grid_operator(arrays, "visc_solver.K", device),
        interior_mask=_tensor(arrays["visc_solver.interior_mask"], device),
        dt_nu=config.dt * config.nu, iters=config.cg_iters_visc, tol=config.cg_tol_visc,
        plain=plain,
    )
    pr = np.asarray(arrays["pressure_solver.Pr"])  # (nc, ns) one-hot row blocks
    field = lambda name: _tensor(arrays[f"pressure_solver.{name}"], device)
    pressure = PressureGridCG(
        K=_grid_operator(arrays, "pressure_solver.K", device),
        m_lumped=field("m_lumped"), active_mask=field("active_mask"),
        master_mask=field("master_mask"), slave_mask=field("slave_mask"),
        iters=config.cg_iters_pressure, ac_inv=field("ac_inv"), block=int(pr[0].sum()),
        n_blocks=pr.shape[0], omega=float(arrays["pressure_solver.omega"]),
        tol=config.cg_tol_pressure, plain=plain,
        pair_axis=int(arrays["pressure_solver.pair_axis"]),
        use_coarse=config.cg_precond == "twolevel",
    )
    return visc, pressure


def _csr(arrays: dict, prefix: str, n: int, dtype, device) -> CSROperator:
    return CSROperator(
        indptr=np.asarray(arrays[f"{prefix}.indptr"], dtype=np.int32),
        indices=np.asarray(arrays[f"{prefix}.indices"], dtype=np.int32),
        data=torch.as_tensor(np.array(arrays[f"{prefix}.data"]), dtype=dtype, device=device),
        shape=(n, n),
    )


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

    common = dict(
        boundary=boundary,
        inner_values=np.asarray(arrays["inner_values"]),
        m_lumped=dev_array("m_lumped"),
        visc_lift=dev_array("visc_lift"),
        locator=locator,
        tracer_init=None if "tracer_init" not in arrays else np.asarray(arrays["tracer_init"]),
    )
    if "visc_solver.K.diags" in arrays:
        if config.solver != "cg":
            raise ValueError("grid-storage arrays need a solver='cg' configuration")
        visc, pressure = _grid_solvers(arrays, config, dev)
        dtype = tconfig.dtype(config.precision)
        mf = tuple(_csr(arrays, k, mesh.n_nodes, dtype, dev) for k in ("mf_dx", "mf_dy"))
        return StokesProblem.from_host(mesh, config, dev, visc_solver=visc,
                                       pressure_solver=pressure, div_xy=(None, None),
                                       mf_dxy=mf, **common)
    fused = None
    if "fused_M" in arrays:
        fused = tuple(dev_array(k) for k in ("fused_M", "fused_b", "fused_Dstar", "fused_dstar0"))
    return StokesProblem.from_host(
        mesh, config, dev,
        visc_solver=_solver(arrays, "visc_solver", dev),
        pressure_solver=_solver(arrays, "pressure_solver", dev),
        div_xy=(dev_array("div_x"), dev_array("div_y")),
        fused=fused,
        **common,
    )


def state_from_numpy(state: dict[str, np.ndarray], device=None) -> dict[str, torch.Tensor]:
    """A state dict on ``device``; each array keeps its dtype."""
    dev = tconfig.device(device)
    return {k: torch.as_tensor(np.array(v), device=dev) for k, v in state.items()}


def state_to_numpy(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A state dict as host NumPy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}
