"""Single-controller device meshes, their collectives, the element-sharded
divergence/gradient, and the ensembles.

The counterpart of ``tpufem.parallel.spmd``.  tpufem runs its sharded code
as one program over a device mesh (``shard_map``); the port keeps that
single controller: one process holds the per-position tensors, and the
collectives are plain functions over lists of them.  Positions may share a
device: on the CPU they all live on ``cpu``, on one card all on ``cuda:0``;
over several cards each position's tensors live on its card.

* :class:`DeviceMesh` and :func:`build_device_mesh` (tpufem's signature and
  shape rule);
* :func:`psum` and :func:`all_gather` over per-position lists;
* :func:`_shard_elements`, :func:`_div_local`, :func:`_grad_local`: the
  element-padded shards and their partial nodal sums, by elementwise
  products and ``index_add_``;
* :class:`ShardedEnsemble` (one mesh, a batch of squirmer gaits or
  rotation rates) and :class:`MultiMeshEnsemble` (one mesh a simulation),
  stepped by :func:`make_sharded_step`, :func:`make_multimesh_step` and
  :func:`run_sharded`.

An ensemble's batch of B simulations splits over ``"data"`` (B divisible by
its size); ``"space"`` splits the rows of the dense operators (padded to a
multiple of its size) and the elements of the divergence/gradient.  Data
positions with the same devices along ``"space"`` form one group, which
holds its simulations as ONE batch tensor on its first device: on one card
every position is in one group, so a step is one batch program whatever B,
``data`` and ``space`` are.  Within a group, each device multiplies the
operator rows of its ``"space"`` positions (one product for all of them)
and sums its element shards (one ``index_add_``); :func:`all_gather` and
:func:`psum` join the devices.  Groups on different cards step
independently, their launches queued one group after the other.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from tpufem_torch import bc, transport
from tpufem_torch import config as tconfig
from tpufem_torch.cuda_graph import capture_step


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


def all_gather(parts: list[torch.Tensor], dim: int = 0) -> list[torch.Tensor]:
    """The per-shard ``parts`` concatenated along ``dim``, on every shard."""
    dev = parts[0].device
    full = torch.cat([p.to(dev) for p in parts], dim=dim)
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
    t = w.shape[0]
    den = torch.zeros(n_nodes, dtype=w.dtype, device=w.device)
    den.index_add_(0, seg, w[:, None].expand(t, 3).reshape(-1))
    return _lumped_num(seg, w, per_element, n_nodes), den


def _lumped_num(seg, w, per_element, n_nodes):
    """The numerator of :func:`_lumped_sums`, for weights ``w`` (Tl,) and
    the flattened corner ids ``seg`` (3·Tl,)."""
    b, t = per_element.shape[:2]
    q = per_element * (w[None, :, None] if per_element.ndim == 3 else w[None])
    contrib = q[:, :, None].expand(b, t, 3, *q.shape[2:]).reshape(b, 3 * t, *q.shape[2:])
    num = torch.zeros((b, n_nodes) + tuple(q.shape[2:]), dtype=q.dtype, device=q.device)
    return num.index_add_(1, seg, contrib)


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


# ---------------------------------------------------------------------------
# Ensembles: a batch of simulations over ("data", "space")
# ---------------------------------------------------------------------------


def _pad_rows(A: np.ndarray, mult: int) -> np.ndarray:
    """Pad a matrix with zero rows to a row count divisible by ``mult``."""
    pad = (-A.shape[0]) % mult
    if pad:
        A = np.concatenate([A, np.zeros((pad,) + A.shape[1:], dtype=A.dtype)], axis=0)
    return A


@dataclasses.dataclass(frozen=True)
class _Group:
    """Data positions of the mesh with the same devices along ``"space"``:
    their simulations (``index``, in batch order) run as one batch on the
    group's ``devices``; ``spaces[i]`` lists the ``"space"`` positions
    ``devices[i]`` holds.  The batch lives on ``devices[0]``, the device of
    ``"space"`` position 0."""

    index: torch.Tensor  # (B_g,) int64, on the CPU
    devices: tuple
    spaces: tuple

    @property
    def home(self) -> torch.device:
        return self.devices[0]


def _groups(device_mesh: DeviceMesh, n_batch: int) -> tuple:
    data, space = device_mesh.shape["data"], device_mesh.shape["space"]
    if n_batch % data:
        raise ValueError(f"{n_batch} simulations do not split over {data} 'data' positions")
    per = n_batch // data
    layouts: dict = {}
    for d in range(data):
        row = tuple(device_mesh.devices[d * space + s] for s in range(space))
        layouts.setdefault(row, []).extend(range(d * per, (d + 1) * per))
    groups = []
    for row, sims in layouts.items():
        devs = tuple(dict.fromkeys(row))
        groups.append(_Group(index=torch.tensor(sims, dtype=torch.int64), devices=devs,
                             spaces=tuple(tuple(s for s in range(space) if row[s] == d)
                                          for d in devs)))
    return tuple(groups)


def _row_blocks(A: torch.Tensor, group: _Group, n_space: int, batch: bool) -> tuple:
    """Each group device's rows of the padded operator ``A`` ((N_pad, N), or
    (B, N_pad, N) per simulation with ``batch``, then the group's
    simulations only), its ``"space"`` positions' row blocks stacked in
    order."""
    if batch:
        A = A[group.index]
    n_l = A.shape[-2] // n_space
    return tuple(torch.cat([A[..., s * n_l:(s + 1) * n_l, :] for s in spaces], dim=-2).to(dev)
                 for dev, spaces in zip(group.devices, group.spaces))


def _rows_times(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Σₙ A[r, n]·x[b, n, ...] → (B, R, ...): one product for the batch.
    ``A`` is (R, N), shared, or (B, R, N), one for each simulation; ``x`` is
    (B, N) or (B, N, 2)."""
    if A.ndim == 3:
        return torch.matmul(A, x[..., None])[..., 0] if x.ndim == 2 else torch.matmul(A, x)
    if x.ndim == 2:
        return x @ A.T
    b, n, c = x.shape
    return (A @ x.transpose(0, 1).reshape(n, b * c)).reshape(-1, b, c).transpose(0, 1)


def _matvec(group: _Group, blocks: tuple, x: torch.Tensor, n: int) -> torch.Tensor:
    """The row-sharded product (B_g, N, ...) → (B_g, N, ...) on the home
    device: each device multiplies its rows, :func:`all_gather` joins the
    ``"space"`` positions (nothing to join where one device holds them
    all), and the padding rows are cut."""
    if len(group.devices) == 1:
        return _rows_times(blocks[0], x)[:, :n]
    n_space = sum(len(s) for s in group.spaces)
    parts = [None] * n_space
    for dev, spaces, A in zip(group.devices, group.spaces, blocks):
        y = _rows_times(A, x.to(dev))
        for s, part in zip(spaces, y.split(y.shape[1] // len(spaces), dim=1)):
            parts[s] = part
    return all_gather(parts, dim=1)[0][:, :n]


@dataclasses.dataclass(frozen=True)
class _BatchedProblem:
    """What ``stokes._report_projection_step`` reads of a problem, for one
    group's batch: (B_g, k, 2) inner values, the row-sharded inverses as
    solvers, the element-sharded div/grad."""

    config: Any
    boundary: Any
    bidx: dict
    outer_value: torch.Tensor
    body_force: torch.Tensor
    inner_values: torch.Tensor
    pressure_pin: int
    visc_solver: Any
    pressure_solver: Any
    smooth_solver: Any
    div: Callable
    grad: Callable
    visc_lift: Any = None


@dataclasses.dataclass(frozen=True)
class _Apply:
    """A solver whose solve is one (row-sharded) operator product."""

    apply: Callable

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return self.apply(b)


def _apply_bcs_(u: torch.Tensor, bidx: dict, periodic: bool, wall_value: torch.Tensor,
                inner_vals: torch.Tensor):
    """In place on a (B, N, 2) field that no one else holds: periodic copy,
    walls, inner surface velocities (tpufem's ``_apply_bcs_batched`` with a
    zero ``wall_value`` and ``_apply_bcs_shared`` with the outer value).
    The values are (2,) and (B, k, 2) device tensors: a CUDA graph captures
    no copy from the host."""
    if periodic:
        u[:, bidx["slaves"]] = u[:, bidx["masters"]]
    u[:, bidx["walls"]] = wall_value
    u[:, bidx["inner"]] = inner_vals
    return u


def _initial_state(u: torch.Tensor, transport: str, tracer_init, dye_x, threshold: float) -> dict:
    """The ensemble state from the BC'd velocities ``u`` (B, N, 2): the
    tracer lattice tiled over the batch, or the half-domain dye of the node
    x coordinates ``dye_x`` ((N,) shared or (B, N))."""
    b = u.shape[0]
    state = {"u": u, "step": torch.zeros(b, dtype=torch.int32, device=u.device)}
    if transport == "tracers":
        pts = torch.as_tensor(tracer_init, dtype=u.dtype, device=u.device)
        state["tracers"] = pts[None].repeat(b, 1, 1)
        state["tracer_status"] = torch.zeros((b, pts.shape[0]), dtype=torch.int32,
                                             device=u.device)
    elif transport == "dye":
        c = torch.where(dye_x < threshold, 1.0, 0.0).to(u.dtype)
        state["c"] = c.expand(b, -1).clone() if c.ndim == 1 else c
    return state


@dataclasses.dataclass(frozen=True)
class ShardedEnsemble:
    """A batch of squirmer simulations on one mesh, prepared for a (data,
    space) mesh.

    The physics of each simulation is that of
    :func:`tpufem_torch.workloads.stokes.projection_step`; what differs is
    the layout: batched state, row-sharded inverses, element-sharded
    div/grad.  The fields are host (CPU) tensors in the run's dtype;
    :func:`make_sharded_step` places them on the mesh."""

    problem: Any  # stokes.StokesProblem, built on the CPU
    device_mesh: DeviceMesh
    inner_values: torch.Tensor  # (B, k, 2) per-simulation surface velocities
    visc_inv: torch.Tensor  # (N_pad, N)
    pressure_inv: torch.Tensor  # (N_pad, N)
    n_pad: int
    smooth_inv: torch.Tensor | None = None  # (N_pad, N) pressure smoothing ("report")

    @classmethod
    def build(cls, mesh, device_mesh: DeviceMesh, b1s=None, b2s=None, config=None,
              omegas=None) -> "ShardedEnsemble":
        """Squirmer ensembles sweep (b1s, b2s); rotating-cylinder ones
        (``config.bc_kind="rotating"``, e.g. the "report" variant) sweep
        ``omegas``.  ``config`` needs ``solver="inverse"``; its transport
        is the ensemble's (dye unless it names tracers)."""
        from tpufem_torch.workloads import stokes

        config = config or stokes.StokesConfig(solver="inverse")
        if config.solver != "inverse":
            raise ValueError("the sharded ensemble needs solver='inverse' (matvec solvers)")
        kind = config.transport if config.transport in ("dye", "tracers") else "dye"
        problem = stokes.StokesProblem.build(
            mesh, dataclasses.replace(config, transport=kind), device="cpu")
        inner = problem.boundary.inner
        if config.bc_kind == "rotating":
            if omegas is None:
                raise ValueError("rotating ensembles sweep omegas")
            vals = [bc.rotating_cylinder_values(mesh.coords, inner, config.center, om)
                    for om in omegas]
        else:
            vals = [bc.squirmer_values(mesh.coords, inner, config.center, b1, b2)
                    for b1, b2 in zip(b1s, b2s)]
        space = device_mesh.shape["space"]

        def rows(solver):
            return torch.as_tensor(_pad_rows(solver.inv.cpu().numpy(), space))

        visc_inv = rows(problem.visc_solver)
        _groups(device_mesh, len(vals))  # the batch must split over "data"
        return cls(
            problem=problem, device_mesh=device_mesh,
            inner_values=torch.as_tensor(np.stack(vals), dtype=problem.dtype),
            visc_inv=visc_inv, pressure_inv=rows(problem.pressure_solver),
            n_pad=visc_inv.shape[0],
            smooth_inv=None if problem.smooth_solver is None else rows(problem.smooth_solver))

    @property
    def transport(self) -> str:
        return self.problem.config.transport

    def initial_state(self) -> dict:
        """The state of every simulation at rest, on the mesh's first device."""
        problem = self.problem
        dev = self.device_mesh.devices[0]
        b, n = self.inner_values.shape[0], problem.mesh.n_nodes
        u = _apply_bcs_(torch.zeros((b, n, 2), dtype=problem.dtype, device=dev),
                        problem.boundary.index_tensors(dev), len(problem.boundary.masters) > 0,
                        torch.zeros(2, dtype=problem.dtype, device=dev),
                        self.inner_values.to(dev))
        x = torch.as_tensor(problem.mesh.coords[:, 0], dtype=problem.dtype, device=dev)
        return _initial_state(u, self.transport, problem.tracer_init, x,
                              problem.config.dye_threshold)


class _Shard:
    """One group's piece of an ensemble on its devices: its batch's inner
    values, operator row blocks (``ops``, by the ensemble's field names),
    index sets and locator, and the steps common to both ensembles.
    Subclasses give ``div`` and ``grad``."""

    def __init__(self, group: _Group, cfg, n: int, boundary, inner_values: torch.Tensor,
                 wall_value, ops: dict, locator):
        home = group.home
        self.group, self.cfg, self.n = group, cfg, n
        self.bidx = boundary.index_tensors(home)
        self.periodic = len(boundary.masters) > 0
        self.inner_values = inner_values[group.index].to(home)
        self.wall_value, self.ops, self.locator = wall_value, ops, locator

    def matvec(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return _matvec(self.group, self.ops[name], x, self.n)

    def _bcs(self, u: torch.Tensor) -> torch.Tensor:
        return _apply_bcs_(u, self.bidx, self.periodic, self.wall_value, self.inner_values)

    def _transport(self, state: dict, u: torch.Tensor, new: dict):
        """Dye or tracers on the new flow, into ``new`` (each simulation's
        points in its own mesh where the locator is stacked); the eaten
        counts (B_g,) for tracers, else None."""
        cfg = self.cfg
        if self.locator is None:
            return None
        if "tracers" not in state:
            new["c"] = transport.advect_semilagrange(None, self.locator, state["c"], u, cfg.dt,
                                                     L=cfg.L, H=cfg.H)
            return None
        pts = transport.tracer_step(None, self.locator, state["tracers"], u, cfg.dt, L=cfg.L,
                                    method=cfg.tracer_method)
        status = transport.capture_update(pts, state["tracer_status"], cfg.center,
                                          cfg.capture_radius)
        new["tracers"], new["tracer_status"] = pts, status
        return torch.sum(status, dim=1).to(u.dtype)

    def _color_step(self, state: dict):
        """The StokesColor double projection, then transport; the metric is
        the eaten count, else max |div u|."""
        dt = self.cfg.dt
        u_star = self._bcs(self.matvec("visc_inv", state["u"]))
        p = self.matvec("pressure_inv", -self.div(u_star) / dt)
        u_new = self._bcs(u_star - dt * self.grad(p))
        p2 = self.matvec("pressure_inv", -self.div(u_new) / dt)
        interior = self.bidx["interior"]
        u_new.index_add_(1, interior, -dt * self.grad(p2)[:, interior])
        new = {"u": u_new, "step": state["step"] + 1}
        per_sim = self._transport(state, u_new, new)
        if per_sim is None:
            per_sim = torch.amax(torch.abs(self.div(u_new)), dim=1)
        return new, per_sim


class _EnsembleShard(_Shard):
    """A group of a :class:`ShardedEnsemble`: element-sharded div/grad, the
    report step besides the color step."""

    def __init__(self, ens: ShardedEnsemble, group: _Group):
        problem = ens.problem
        mesh, cfg, dtype, home = problem.mesh, problem.config, problem.dtype, group.home
        n_space = ens.device_mesh.shape["space"]
        ops = {name: _row_blocks(getattr(ens, name), group, n_space, batch=False)
               for name in ("visc_inv", "pressure_inv", "smooth_inv")
               if getattr(ens, name) is not None}
        super().__init__(group, cfg, mesh.n_nodes, problem.boundary, ens.inner_values,
                         torch.zeros(2, dtype=dtype, device=home), ops,
                         None if cfg.transport == "none" else problem.get_locator().to(home))
        tris, grads, area, valid = _shard_elements(mesh, n_space)
        t_l = tris.shape[0] // n_space
        self.elements, dens = [], []
        for dev, spaces in zip(group.devices, group.spaces):
            sel = np.concatenate([np.arange(s * t_l, (s + 1) * t_l) for s in spaces])
            t = torch.as_tensor(tris[sel], dtype=torch.int64, device=dev)
            a = torch.as_tensor(area[sel], dtype=dtype, device=dev)
            w = torch.where(torch.as_tensor(valid[sel], device=dev), a / 3.0, torch.zeros_like(a))
            self.elements.append((t, torch.as_tensor(grads[sel], dtype=dtype, device=dev), w))
            dens.append(torch.zeros(self.n, dtype=dtype, device=dev).index_add_(
                0, t.reshape(-1), w[:, None].expand(-1, 3).reshape(-1)))
        self.den = psum(dens)[0] + 1e-12  # (N,) the lumped weights, on the home device
        self.batched = _BatchedProblem(
            config=cfg, boundary=problem.boundary, bidx=self.bidx,
            outer_value=torch.as_tensor(cfg.outer_value, dtype=dtype, device=home),
            body_force=torch.as_tensor(cfg.body_force, dtype=dtype, device=home),
            inner_values=self.inner_values, pressure_pin=problem.pressure_pin,
            visc_solver=_Apply(lambda b: self.matvec("visc_inv", b)),
            pressure_solver=_Apply(lambda b: self.matvec("pressure_inv", b)),
            smooth_solver=_Apply(lambda b: self.matvec("smooth_inv", b))
            if "smooth_inv" in ops else None,
            div=self.div, grad=self.grad)

    def _nodal(self, per_element) -> torch.Tensor:
        """psum of each device's ⅓-area-weighted nodal sums of
        ``per_element(tris, grads)`` over its element shards."""
        parts = [_lumped_num(tris.reshape(-1), w, per_element(tris, grads), self.n)
                 for tris, grads, w in self.elements]
        return psum(parts)[0]

    def div(self, u: torch.Tensor) -> torch.Tensor:
        def per_element(tris, grads):
            d = torch.sum(u.to(tris.device)[:, tris] * grads, dim=2)  # ∂uₓ/∂x, ∂u_y/∂y
            return d[..., 0] + d[..., 1]

        return self._nodal(per_element) / self.den

    def grad(self, p: torch.Tensor) -> torch.Tensor:
        def per_element(tris, grads):
            return torch.sum(p.to(tris.device)[:, tris][..., None] * grads, dim=2)

        return self._nodal(per_element) / self.den[:, None]

    def step(self, state: dict):
        if self.cfg.variant == "report":
            return self._report_step(state)
        return self._color_step(state)

    def _report_step(self, state: dict):
        """The "report" step of each simulation, by
        ``stokes._report_projection_step`` on the batch, with a BC ramp by
        each simulation's own (step + 1)."""
        from tpufem_torch.workloads import stokes

        u = state["u"]
        ramp = self.cfg.ramp_steps
        if ramp > 0:
            scale = torch.clamp((state["step"] + 1).to(u.dtype) / ramp, max=1.0)
        else:
            scale = torch.ones(u.shape[0], dtype=u.dtype, device=u.device)
        u_new, _, metrics, _ = stokes._report_projection_step(self.batched, u,
                                                              scale[:, None, None])
        new = {"u": u_new, "step": state["step"] + 1}
        per_sim = self._transport(state, u_new, new)
        return new, metrics["final_div_max"] if per_sim is None else per_sim


@dataclasses.dataclass(frozen=True)
class MultiMeshEnsemble:
    """An ensemble where every simulation runs on its OWN mesh: jittered
    geometry realizations, ``generate_annulus_mesh(..., jitter=…,
    pad_hole=True, seed=k)``, with one node count and identical boundary
    index sets.  The per-simulation operators (viscous and pressure
    inverses, dense div/grad) are stacked on the batch axis; transport
    ("dye"/"tracers") rides a :class:`~tpufem_torch.transport.BatchedGridLocator`.
    The fields are host (CPU) tensors in the run's dtype;
    :func:`make_multimesh_step` places them on the mesh."""

    meshes: tuple
    device_mesh: DeviceMesh
    inner_values: torch.Tensor  # (B, k, 2)
    visc_inv: torch.Tensor  # (B, N_pad, N)
    pressure_inv: torch.Tensor  # (B, N_pad, N)
    div_x: torch.Tensor  # (B, N_pad, N)
    div_y: torch.Tensor  # (B, N_pad, N)
    config: Any
    boundary: Any  # bc.ChannelBoundary, shared by every mesh
    locator: Any = None  # BatchedGridLocator when transport != "none"
    tracer_init: Any = None  # (P, 2) shared tracer seed lattice

    @classmethod
    def build(cls, meshes, device_mesh: DeviceMesh, b1s, b2s, config=None) -> "MultiMeshEnsemble":
        from tpufem_torch.workloads import stokes

        config = config or stokes.StokesConfig(solver="inverse", pressure_mode="merge",
                                               transport="none")
        if config.solver != "inverse" or not config.dense_ops:
            raise ValueError("per-simulation meshes ride stacked dense operators: "
                             "solver='inverse', dense_ops=True")
        if config.transport not in ("none", "dye", "tracers"):
            raise ValueError(f"transport {config.transport!r}: the multi-mesh ensemble "
                             "carries 'none', 'dye' or 'tracers'")
        if not len(meshes) == len(b1s) == len(b2s):
            raise ValueError(f"{len(meshes)} meshes, {len(b1s)} B1 and {len(b2s)} B2 values")
        _groups(device_mesh, len(meshes))  # the batch must split over "data"
        built = dataclasses.replace(config, transport="none")
        b0 = None
        ops: dict = {"visc_inv": [], "pressure_inv": [], "div_x": [], "div_y": []}
        space = device_mesh.shape["space"]
        dtype = None
        for m in meshes:
            p = stokes.StokesProblem.build(m, built, device="cpu")
            if b0 is None:
                b0, dtype = p.boundary, p.dtype
            for f in ("walls", "inner", "masters", "slaves", "interior"):
                if not np.array_equal(getattr(p.boundary, f), getattr(b0, f)):
                    raise ValueError(f"per-simulation meshes must share boundary index sets "
                                     f"({f}): use the same pad_hole generator parameters")
            for key, t in (("visc_inv", p.visc_solver.inv), ("pressure_inv", p.pressure_solver.inv),
                           ("div_x", p.div_x), ("div_y", p.div_y)):
                ops[key].append(torch.as_tensor(_pad_rows(t.cpu().numpy(), space)))
        vals = np.stack([bc.squirmer_values(m.coords, b0.inner, config.center, b1, b2)
                         for m, b1, b2 in zip(meshes, b1s, b2s)])
        locator = tracer_init = None
        if config.transport != "none":
            locator = transport.BatchedGridLocator.build(meshes, dtype=dtype, device="cpu")
        if config.transport == "tracers":
            tracer_init = transport.init_tracer_grid(
                config.tracer_density, L=config.L, H=config.H, exclude_center=config.center,
                exclude_radius=0.25)
        return cls(meshes=tuple(meshes), device_mesh=device_mesh,
                   inner_values=torch.as_tensor(vals, dtype=dtype), config=config, boundary=b0,
                   locator=locator, tracer_init=tracer_init,
                   **{k: torch.stack(v) for k, v in ops.items()})

    def initial_state(self) -> dict:
        """The state of every simulation at rest, on the mesh's first device."""
        cfg, dev = self.config, self.device_mesh.devices[0]
        b, n = self.inner_values.shape[0], self.meshes[0].n_nodes
        dtype = self.inner_values.dtype
        u = _apply_bcs_(torch.zeros((b, n, 2), dtype=dtype, device=dev),
                        self.boundary.index_tensors(dev), len(self.boundary.masters) > 0,
                        torch.as_tensor(cfg.outer_value, dtype=dtype, device=dev),
                        self.inner_values.to(dev))
        x = None if self.locator is None else self.locator.coords[..., 0].to(dev)
        return _initial_state(u, cfg.transport, self.tracer_init, x, cfg.dye_threshold)


class _MultiMeshShard(_Shard):
    """A group of a :class:`MultiMeshEnsemble`: each simulation's own
    operators, its dense div/grad, its transport in its own mesh."""

    def __init__(self, ens: MultiMeshEnsemble, group: _Group):
        cfg, home = ens.config, group.home
        n_space = ens.device_mesh.shape["space"]
        ops = {name: _row_blocks(getattr(ens, name), group, n_space, batch=True)
               for name in ("visc_inv", "pressure_inv", "div_x", "div_y")}
        outer = torch.as_tensor(cfg.outer_value, dtype=ens.inner_values.dtype, device=home)
        super().__init__(group, cfg, ens.meshes[0].n_nodes, ens.boundary, ens.inner_values,
                         outer, ops,
                         None if ens.locator is None else ens.locator.select(group.index, home))

    def div(self, u: torch.Tensor) -> torch.Tensor:
        return self.matvec("div_x", u[..., 0]) + self.matvec("div_y", u[..., 1])

    def grad(self, p: torch.Tensor) -> torch.Tensor:
        return torch.stack([self.matvec("div_x", p), self.matvec("div_y", p)], dim=-1)

    def step(self, state: dict):
        return self._color_step(state)


class EnsembleStep:
    """The step of an ensemble: ``state → (state, metric (B,))`` on global
    (B, ...) state tensors that live on the mesh's first device, as
    tpufem's jitted step takes them.  The metric is each simulation's eaten
    count for tracers, else its max |div u|.  :meth:`run` keeps each group's
    state on its own devices between steps."""

    def __init__(self, shards: list, groups: tuple, n_batch: int, home: torch.device):
        self.shards, self.groups, self.n_batch, self.home = shards, groups, n_batch, home

    def _one_group(self) -> bool:
        g = self.groups[0]
        return len(self.groups) == 1 and g.home == self.home

    def split(self, state: dict) -> list[dict]:
        """Global state → each group's part on its home device."""
        if self._one_group():
            return [state]
        return [{k: v[g.index.to(v.device)].to(g.home) for k, v in state.items()}
                for g in self.groups]

    def join(self, parts: list, dim: int = 0):
        """Each group's tensors (or state dicts) → global ones on the first
        device, the batch on ``dim``."""
        if self._one_group():
            return parts[0]
        if isinstance(parts[0], dict):
            return {k: self.join([p[k] for p in parts], dim) for k in parts[0]}
        first = parts[0]
        shape = list(first.shape)
        shape[dim] = self.n_batch
        out = torch.empty(shape, dtype=first.dtype, device=self.home)
        for g, part in zip(self.groups, parts):
            out.index_copy_(dim, g.index.to(self.home), part.to(self.home))
        return out

    def __call__(self, state: dict):
        outs = [shard.step(part) for shard, part in zip(self.shards, self.split(state))]
        return self.join([o[0] for o in outs]), self.join([o[1] for o in outs])

    def run(self, state: dict, steps: int):
        """``steps`` steps → (state, metric (steps, B)); a Python loop that
        only enqueues device work, each group's metrics into preallocated
        (steps, B_g) tensors.  A group on one card replays its step as one
        CUDA graph (:func:`capture_step`): ~140 small kernels a step,
        which the host enqueues slower than the card runs them."""
        parts = self.split(state)
        series, graphs = [], []
        for shard, part in zip(self.shards, parts):
            home = shard.group.home
            series.append(torch.empty((steps, len(shard.group.index)), dtype=part["u"].dtype,
                                      device=home))
            one_card = home.type == "cuda" and len(shard.group.devices) == 1
            graphs.append(capture_step(shard.step, part, home) if one_card and steps else None)
        for i in range(steps):
            for k, shard in enumerate(self.shards):
                if graphs[k] is None:
                    parts[k], series[k][i] = shard.step(parts[k])
                else:
                    _, metric, graph = graphs[k]
                    with torch.cuda.device(shard.group.home):
                        graph.replay()
                    series[k][i] = metric
        for k, captured in enumerate(graphs):
            if captured is not None:
                parts[k] = {key: v.clone() for key, v in captured[0].items()}
        return self.join(parts), self.join(series, dim=1)


def make_sharded_step(ensemble: ShardedEnsemble) -> EnsembleStep:
    """The (data, space)-sharded full step of a :class:`ShardedEnsemble`:
    viscous solve → double pressure projection → BCs → dye advection or
    tracer transport ("color"), or the "report" step; row-sharded inverse
    products joined by :func:`all_gather`, element-sharded div/grad sums by
    :func:`psum`."""
    groups = _groups(ensemble.device_mesh, ensemble.inner_values.shape[0])
    return EnsembleStep([_EnsembleShard(ensemble, g) for g in groups], groups,
                        ensemble.inner_values.shape[0], ensemble.device_mesh.devices[0])


def make_multimesh_step(ensemble: MultiMeshEnsemble) -> EnsembleStep:
    """The (data, space)-sharded double-projection step of a
    :class:`MultiMeshEnsemble`: every product is each simulation's own
    operator rows, one batched product a device, joined by
    :func:`all_gather`."""
    groups = _groups(ensemble.device_mesh, ensemble.inner_values.shape[0])
    return EnsembleStep([_MultiMeshShard(ensemble, g) for g in groups], groups,
                        ensemble.inner_values.shape[0], ensemble.device_mesh.devices[0])


def run_sharded(ensemble, steps: int, state: dict | None = None):
    """Run ``steps`` ensemble steps → (final state, metric (steps, B)): eaten
    counts for tracer ensembles, max |div u| otherwise.  A Python loop of
    device steps (tpufem scans them in one jitted program)."""
    step = (make_multimesh_step(ensemble) if isinstance(ensemble, MultiMeshEnsemble)
            else make_sharded_step(ensemble))
    if state is None:
        state = ensemble.initial_state()
    return step.run(state, steps)
