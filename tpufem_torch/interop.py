"""Carry a problem or a state across from NumPy arrays.

The arrays come from any source that lays them out under the port's field
paths, for instance the JAX package's ``StokesProblem`` flattened with its
``_extract_arrays`` plus its boundary index sets and locator tables.  The
port then steps exactly the operators another build produced.

Dense regime:

    ``visc_solver.lu`` + ``visc_solver.piv`` (SciPy 0-based pivots) or
    ``visc_solver.inv``; the same under ``pressure_solver.``;
    ``div_x``, ``div_y`` (left out under ``dense_ops=False``); optionally
    ``fused_M``, ``fused_b``, ``fused_Dstar``, ``fused_dstar0`` and
    ``visc_lift``; for ``pressure_smoothing > 0`` the smoothing solver as
    ``smooth_solver.<lu|piv|inv>`` (as the other solvers); for
    ``variant="report"`` ``pressure_pin`` (the pinned node, a 0-d integer);
    for ``transport="eulerian_dye"`` ``eul_M`` (consistent mass), ``eul_K``
    (stiffness) and, at f32, ``eul_Mg`` (periodic merge map); for
    ``"dye_griddata"`` ``eul_K``.

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
    ``mf_dx`` and ``mf_dy`` for div/grad, as any operator below.  Under
    ``grid_steps_per_call ≥ 1`` (kernel K5), the JAX package's
    ``GridStokesStep``: ``grid_step.Gdx`` and ``grid_step.Gdy`` (as ``<op>``
    above) and ``grid_step.<wall_mask|inner_mask|inner_vals|interior2>``.
    A renumbered mesh (``mesh.gridify``) comes as the renumbered mesh plus
    ``gridified.perm``.

Operators off the grid (:func:`operator_from_numpy`), by the keys under
their prefix: CSR ``<op>.<indptr|indices|data>``; the JAX package's
stencil layout ``<op>.<diags|offsets|rest_rows_j|rest_cols_j|rest_data>``
and optionally ``<op>.coverage``; its banded layout
``<op>.<diags|perm|inv_perm|bandwidth>``.

Both: ``m_lumped``; ``boundary.<walls|inner|dirichlet|interior|masters|slaves>``;
``inner_values``; for transport ``locator.<cells|rows|origin|extent|g>``
(under ``locator="topk"`` none: that locator is the mesh's centroids); for
tracers ``tracer_init``.

Navier–Stokes grid path (:func:`ns_problem_from_numpy`, the JAX package's
``NSProblem`` layout): ``grid_refill.<dest|order|order_k>`` and the template
operator under ``grid_refill.template.`` (as ``<op>`` above; its values are
not used); ``Kg_diags``, ``Kg_rest``; ``inv_diag_visc``; ``wall_mask``; the
pressure solver's arrays as above.

Poisson-family and dense Taylor–Hood problems (the factored or inverted
arrays of a dense build, the BC index sets and values):

    :func:`heat_problem_from_numpy`: ``solver.<lu|piv|inv>``,
    ``boundary.<walls|inner|dirichlet|interior|masters|slaves>``,
    ``dirichlet_values``;
    :func:`ad_problem_from_numpy`: ``solver.<lu|piv|inv>``, ``mass``,
    ``dirichlet``, ``inject_idx``, ``inject_vals``;
    :func:`th_problem_from_numpy`: ``e_inv``, ``r_op``, ``bc_dofs``,
    ``bc_values``, ``corners``;
    :func:`stam_state_from_numpy`: Stam's state ``{vx, vy, density, t}``.

Ensembles (:func:`ensemble_from_numpy`, :func:`multimesh_from_numpy`):
the JAX package's ``ShardedEnsemble`` as its problem's arrays plus
``ensemble.<inner_values|visc_inv|pressure_inv|smooth_inv>``, and its
``MultiMeshEnsemble`` as its stacked operators, boundary sets and
``BatchedGridLocator`` tables (see each function).

Sparse Taylor–Hood problems (:func:`sparse_th_problem_from_numpy`, the JAX
package's ``SparseTHProblem``): ``<op>.<indptr|indices|data>`` for ``<op>``
in ``K2``, ``M2``, ``Bx``, ``By``, ``BxT``, ``ByT`` and ``Kp``; ``mp_lumped``,
``vel_mask``, ``u_bc`` and ``corners``.  The grid engine
(``th_sparse.GridTHProblem.build``) then builds on it as on the port's own.

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
from tpufem_torch.mesh.gridify import Gridified
from tpufem_torch.ops.banded import BandedOperator
from tpufem_torch.ops.gridop import GridOperator, GridRefill
from tpufem_torch.ops.sparse import CSROperator
from tpufem_torch.ops.stencil import StencilOperator
from tpufem_torch.parallel.spmd import MultiMeshEnsemble, ShardedEnsemble
from tpufem_torch.solve.dense import DenseInverse, DenseLU
from tpufem_torch.solve.grid_cg import NSGridBiCGStab, PressureGridCG, ViscousGridCG
from tpufem_torch.solve.grid_step import GridStokesStep, steps_per_call
from tpufem_torch.workloads.advection_diffusion import ADConfig, ADProblem
from tpufem_torch.workloads.heat import HeatConfig, HeatProblem
from tpufem_torch.workloads.navier_stokes import (NSConfig, NSProblem, TransientTHConfig,
                                                  TransientTHProblem)
from tpufem_torch.workloads.navier_stokes import check_config as check_ns_config
from tpufem_torch.workloads.stokes import StokesConfig, StokesProblem, check_config
from tpufem_torch.workloads.th_sparse import SparseTHConfig, SparseTHProblem


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


def _grid_pressure(arrays: dict, iters: int, tol: float, use_coarse: bool, plain: bool,
                   device) -> PressureGridCG:
    pr = np.asarray(arrays["pressure_solver.Pr"])  # (nc, ns) one-hot row blocks
    field = lambda name: _tensor(arrays[f"pressure_solver.{name}"], device)
    return PressureGridCG(
        K=_grid_operator(arrays, "pressure_solver.K", device),
        m_lumped=field("m_lumped"), active_mask=field("active_mask"),
        master_mask=field("master_mask"), slave_mask=field("slave_mask"),
        iters=iters, ac_inv=field("ac_inv"), block=int(pr[0].sum()),
        n_blocks=pr.shape[0], omega=float(arrays["pressure_solver.omega"]),
        tol=tol, plain=plain, pair_axis=int(arrays["pressure_solver.pair_axis"]),
        use_coarse=use_coarse,
    )


def _grid_solvers(arrays: dict, config: StokesConfig, device):
    plain = config.cg_storage == "grid_interpret"
    visc = ViscousGridCG(
        K=_grid_operator(arrays, "visc_solver.K", device),
        interior_mask=_tensor(arrays["visc_solver.interior_mask"], device),
        dt_nu=config.dt * config.nu, iters=config.cg_iters_visc, tol=config.cg_tol_visc,
        plain=plain,
    )
    pressure = _grid_pressure(arrays, config.cg_iters_pressure, config.cg_tol_pressure,
                              config.cg_precond == "twolevel", plain, device)
    return visc, pressure


def _grid_step(arrays: dict, problem: StokesProblem, device) -> GridStokesStep | None:
    """K5's operators and masks from the arrays, on ``problem``'s solvers;
    None when the arrays carry none or the configuration does not ask for K5."""
    k = steps_per_call(problem.config)
    if k < 1 or "grid_step.Gdx.diags" not in arrays:
        return None
    cfg = problem.config
    field = lambda name: _tensor(arrays[f"grid_step.{name}"], device)
    return GridStokesStep(
        visc=problem.visc_solver, pressure=problem.pressure_solver,
        Gdx=_grid_operator(arrays, "grid_step.Gdx", device),
        Gdy=_grid_operator(arrays, "grid_step.Gdy", device),
        wall_mask=field("wall_mask"), inner_mask=field("inner_mask"),
        inner_vals=field("inner_vals"), interior2=field("interior2"),
        outer_value=tuple(float(v) for v in np.asarray(cfg.outer_value)), dt=float(cfg.dt),
        body_force=tuple(float(v) for v in np.asarray(cfg.body_force)), steps_per_call=k,
    )


def _csr(arrays: dict, prefix: str, n: int, dtype, device) -> CSROperator:
    return CSROperator(
        indptr=np.asarray(arrays[f"{prefix}.indptr"], dtype=np.int32),
        indices=np.asarray(arrays[f"{prefix}.indices"], dtype=np.int32),
        data=torch.as_tensor(np.array(arrays[f"{prefix}.data"]), dtype=dtype, device=device),
        shape=(n, n),
    )


def _stencil(arrays: dict, prefix: str, dtype, device) -> StencilOperator:
    get = lambda key: np.array(arrays[f"{prefix}.{key}"])
    coverage = float(arrays.get(f"{prefix}.coverage", np.nan))
    return StencilOperator.from_parts(get("offsets").tolist(), get("diags"), get("rest_rows_j"),
                                      get("rest_cols_j"), get("rest_data"), coverage,
                                      dtype=dtype, device=device)


def _banded(arrays: dict, prefix: str, dtype, device) -> BandedOperator:
    get = lambda key: np.array(arrays[f"{prefix}.{key}"])
    return BandedOperator.from_parts(get("diags"), get("perm"), get("inv_perm"),
                                     int(get("bandwidth")), dtype=dtype, device=device)


def operator_from_numpy(arrays: dict, prefix: str, n: int, dtype=None, device=None):
    """The operator under ``prefix``: banded, stencil or CSR by its keys (see
    the module docstring), in ``dtype`` (None: the arrays' own) on
    ``device``."""
    dev = tconfig.device(device)
    if f"{prefix}.bandwidth" in arrays:
        return _banded(arrays, prefix, dtype, dev)
    if f"{prefix}.rest_data" in arrays:
        return _stencil(arrays, prefix, dtype, dev)
    if dtype is None:
        dtype = torch.as_tensor(np.array(arrays[f"{prefix}.data"])).dtype
    return _csr(arrays, prefix, n, dtype, dev)


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
    if config.transport != "none" and config.locator == "topk":
        locator = transport.TopKLocator.build(mesh, k=config.locator_k,
                                              dtype=tconfig.dtype(config.precision), device=dev)
    elif config.transport != "none":
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
        mf = tuple(operator_from_numpy(arrays, k, mesh.n_nodes, dtype, dev)
                   for k in ("mf_dx", "mf_dy"))
        problem = StokesProblem.from_host(mesh, config, dev, visc_solver=visc,
                                          pressure_solver=pressure, div_xy=(None, None),
                                          mf_dxy=mf, **common)
        gridified = None
        if "gridified.perm" in arrays:
            gridified = Gridified(mesh=mesh, perm=np.asarray(arrays["gridified.perm"]),
                                  ns=visc.K.ns)
        return dataclasses.replace(problem, grid_step=_grid_step(arrays, problem, dev),
                                   gridified=gridified)
    fused = None
    if "fused_M" in arrays:
        fused = tuple(dev_array(k) for k in ("fused_M", "fused_b", "fused_Dstar", "fused_dstar0"))
    smooth = None
    if any(k.startswith("smooth_solver.") for k in arrays):
        smooth = _solver(arrays, "smooth_solver", dev)
    return StokesProblem.from_host(
        mesh, config, dev,
        visc_solver=_solver(arrays, "visc_solver", dev),
        pressure_solver=_solver(arrays, "pressure_solver", dev),
        div_xy=(dev_array("div_x"), dev_array("div_y")),
        fused=fused,
        smooth_solver=smooth,
        pressure_pin=int(arrays.get("pressure_pin", -1)),
        eul=tuple(dev_array(k) for k in ("eul_M", "eul_K", "eul_Mg")),
        **common,
    )


def ensemble_from_numpy(arrays: dict[str, np.ndarray], mesh: Mesh, device_mesh,
                        config: StokesConfig) -> ShardedEnsemble:
    """A port ``ShardedEnsemble`` holding the given arrays: the problem's, as
    :func:`problem_from_numpy` takes them (dense ``solver="inverse"``), plus
    ``ensemble.inner_values`` (B, k, 2), ``ensemble.visc_inv`` and
    ``ensemble.pressure_inv`` (N_pad, N) and, for the "report" variant with
    smoothing, ``ensemble.smooth_inv``; all cast to the configuration's
    precision on the CPU."""
    kind = config.transport if config.transport in ("dye", "tracers") else "dye"
    problem = problem_from_numpy(arrays, mesh, dataclasses.replace(config, transport=kind),
                                 device="cpu")

    def t(key):
        return None if key not in arrays else torch.as_tensor(np.array(arrays[key]),
                                                              dtype=problem.dtype)

    visc_inv = t("ensemble.visc_inv")
    return ShardedEnsemble(problem=problem, device_mesh=device_mesh,
                           inner_values=t("ensemble.inner_values"), visc_inv=visc_inv,
                           pressure_inv=t("ensemble.pressure_inv"), n_pad=visc_inv.shape[0],
                           smooth_inv=t("ensemble.smooth_inv"))


def multimesh_from_numpy(arrays: dict[str, np.ndarray], meshes, device_mesh,
                         config: StokesConfig) -> MultiMeshEnsemble:
    """A port ``MultiMeshEnsemble`` holding the given stacked arrays:
    ``inner_values`` (B, k, 2); ``visc_inv``, ``pressure_inv``, ``div_x``,
    ``div_y`` (B, N_pad, N); ``boundary.<walls|inner|dirichlet|interior|
    masters|slaves>``; for transport the stacked locator tables
    ``locator.<rows|origins|extents|coords|g>``; for tracers
    ``tracer_init``.  Cast to the configuration's precision on the CPU."""
    dtype = tconfig.dtype(config.precision)
    boundary = bc.ChannelBoundary(**{
        f.name: np.asarray(arrays[f"boundary.{f.name}"])
        for f in dataclasses.fields(bc.ChannelBoundary)
    })
    locator = None
    if config.transport != "none":
        locator = transport.BatchedGridLocator.from_tables(
            *(arrays[f"locator.{k}"] for k in ("rows", "origins", "extents", "coords")),
            int(arrays["locator.g"]), dtype=dtype, device="cpu")
    return MultiMeshEnsemble(
        meshes=tuple(meshes), device_mesh=device_mesh, config=config, boundary=boundary,
        locator=locator, tracer_init=None if "tracer_init" not in arrays
        else np.asarray(arrays["tracer_init"]),
        **{k: torch.as_tensor(np.array(arrays[k]), dtype=dtype)
           for k in ("inner_values", "visc_inv", "pressure_inv", "div_x", "div_y")})


def ns_problem_from_numpy(arrays: dict[str, np.ndarray], mesh: Mesh, config: NSConfig,
                          device=None) -> NSProblem:
    """A port grid-path ``NSProblem`` holding the given operator arrays."""
    check_ns_config(config)
    if config.solver != "cg" or "grid_refill.dest" not in arrays:
        raise ValueError("ns_problem_from_numpy carries the grid path only: grid_refill.* "
                         "arrays and a solver='cg' configuration")
    dev = tconfig.device(device)
    template = _grid_operator(arrays, "grid_refill.template", dev)
    m = template.n_rest

    def index(key):
        return torch.as_tensor(np.asarray(arrays[key], dtype=np.int64), device=dev)

    refill = GridRefill(template=template, dest=index("grid_refill.dest"),
                        order=index("grid_refill.order"), order_k=index("grid_refill.order_k"),
                        n_flat=len(template.offsets) * template.n + m)
    plain = config.cg_storage == "grid_interpret"
    wall_mask = np.asarray(arrays["wall_mask"], dtype=bool)
    dtype = tconfig.dtype(config.precision)
    return NSProblem(
        mesh=mesh, wall_mask=wall_mask, config=config, wall=torch.as_tensor(wall_mask, device=dev),
        body_force=torch.as_tensor(np.asarray(config.body_force), dtype=dtype, device=dev),
        pressure_solver=_grid_pressure(arrays, config.cg_iters_pressure, config.cg_tol,
                                       config.cg_precond == "twolevel", plain, dev),
        inv_diag_visc=_tensor(arrays["inv_diag_visc"], dev), grid_refill=refill,
        Kg_diags=_tensor(arrays["Kg_diags"], dev),
        Kg_rest=_tensor(np.asarray(arrays["Kg_rest"])[:m, 0], dev),
        vel_solver_grid=NSGridBiCGStab(ns=template.ns, offsets=template.offsets, n_rest=m,
                                       iters=config.cg_iters_visc, tol=config.cg_tol,
                                       interpret=plain),
        ones_mask=torch.ones(mesh.n_nodes, dtype=dtype, device=dev),
    )


def heat_problem_from_numpy(arrays: dict[str, np.ndarray], config: HeatConfig,
                            device=None) -> HeatProblem:
    """A port ``HeatProblem`` of a dense build (``solver`` "lu" or
    "inverse"; at f32 the inverse) holding the given arrays."""
    if config.solver == "cg":
        raise ValueError("heat_problem_from_numpy carries the dense solvers only")
    dev = tconfig.device(device)
    boundary = bc.ChannelBoundary(**{
        f.name: np.asarray(arrays[f"boundary.{f.name}"])
        for f in dataclasses.fields(bc.ChannelBoundary)
    })
    return HeatProblem(solver=_solver(arrays, "solver", dev), boundary=boundary,
                       dirichlet_values=_tensor(arrays["dirichlet_values"], dev), config=config,
                       index=boundary.index_tensors(dev))


def ad_problem_from_numpy(arrays: dict[str, np.ndarray], mesh: Mesh, config: ADConfig,
                          device=None) -> ADProblem:
    """A port ``ADProblem`` holding the given factored or inverted system
    and consistent mass."""
    dev = tconfig.device(device)
    return ADProblem(mesh=mesh, solver=_solver(arrays, "solver", dev),
                     mass=_tensor(arrays["mass"], dev),
                     dirichlet=np.asarray(arrays["dirichlet"]),
                     inject_idx=np.asarray(arrays["inject_idx"]),
                     inject_vals=np.asarray(arrays["inject_vals"]), config=config)


def th_problem_from_numpy(arrays: dict[str, np.ndarray], mesh: Mesh, config: TransientTHConfig,
                          device=None) -> TransientTHProblem:
    """A port ``TransientTHProblem`` holding the given inverse θ-system and
    right-hand-side operator (cast to the configuration's precision)."""
    return TransientTHProblem.from_host(mesh, config, np.array(arrays["e_inv"]),
                                        np.array(arrays["r_op"]), arrays["bc_dofs"],
                                        np.array(arrays["bc_values"]), arrays["corners"], device)


def sparse_th_problem_from_numpy(arrays: dict[str, np.ndarray], mesh: Mesh,
                                 config: SparseTHConfig, device=None) -> SparseTHProblem:
    """A port ``SparseTHProblem`` holding the given CSR operators (pattern
    from ``indptr``/``indices``, the values as given) and host arrays, cast
    to the configuration's precision on ``device``."""
    corners = np.asarray(arrays["corners"], dtype=np.int64)
    n2, n1 = mesh.coords.shape[0], len(corners)
    shapes = {"K2": (n2, n2), "M2": (n2, n2), "Bx": (n1, n2), "By": (n1, n2),
              "BxT": (n2, n1), "ByT": (n2, n1), "Kp": (n1, n1)}
    ops = {k: CSROperator(indptr=np.asarray(arrays[f"{k}.indptr"], dtype=np.int32),
                          indices=np.asarray(arrays[f"{k}.indices"], dtype=np.int32),
                          data=torch.as_tensor(np.array(arrays[f"{k}.data"])), shape=shape)
           for k, shape in shapes.items()}
    return SparseTHProblem.from_operators(
        mesh, config, ops, np.asarray(arrays["mp_lumped"]), np.asarray(arrays["vel_mask"]),
        np.asarray(arrays["u_bc"]), corners, device)


def stam_state_from_numpy(state: dict[str, np.ndarray], device=None) -> dict[str, torch.Tensor]:
    """Stam's state ``{vx, vy, density, t}`` on ``device``, each array in its
    own dtype."""
    if set(state) != {"vx", "vy", "density", "t"}:
        raise ValueError(f"a Stam state has vx, vy, density and t, not {sorted(state)}")
    return state_from_numpy(state, device)


def state_from_numpy(state: dict[str, np.ndarray], device=None) -> dict[str, torch.Tensor]:
    """A state dict on ``device``; each array keeps its dtype."""
    dev = tconfig.device(device)
    return {k: torch.as_tensor(np.array(v), device=dev) for k, v in state.items()}


def state_to_numpy(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A state dict as host NumPy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}
