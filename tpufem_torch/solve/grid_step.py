"""The whole double-projection Stokes step on the grid storage: kernel K5.

The counterpart of ``tpufem.solve.pallas_step``.  Under
``StokesConfig(solver="cg", cg_storage="grid", grid_steps_per_call=K ≥ 1)``
one launch advances K whole steps of ``workloads.stokes.projection_step``
(standard variant):

    viscous CG (x, then y) → BCs → div → pressure PCG → grad update → BCs →
    second projection (interior nodes) → final div → metrics

with the viscous and pressure solves of K2/K3, div and grad applied as
grid operators (Gdx, Gdy) instead of CSR scatters, and the BCs as mask
algebra (periodic copy by a cyclic shift along the pairing axis, then
walls, then the inner body).  The two viscous columns stop each on its own
test, as tpufem's kernel solves them one after the other; the plain and
CUDA versions both take them in one pass with a stop flag per column.

* :func:`grid_step_ref` is the plain PyTorch version, built from the plain
  K2/K3 solves; the CPU tests use it, and ``cg_storage="grid_interpret"``
  takes it on every device;
* :func:`grid_step` launches the CUDA kernel in ``csrc/grid_step.cu`` for
  CUDA tensors (a failed build or cooperative launch raises), takes the
  plain version for CPU tensors, and counts its launches in
  ``grid_step.launches``.

tpufem refuses the fused step from 360k nodes (``stream_diags``: its kernel
keeps every plane in the TPU's VMEM); that is a capacity limit of the TPU,
and the port runs K5 at every size.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from tpufem_torch.ops import _nvcc
from tpufem_torch.ops.gridop import GridOperator
from tpufem_torch.solve import grid_cg
from tpufem_torch.solve.grid_cg import (
    PressureGridCG,
    ViscousGridCG,
    _check_counter,
    _device_ok,
    _kernel_operator_args,
    _launch,
    pressure_cg_ref,
    viscous_cg_ref,
)

SOURCE = _nvcc.CSRC / "grid_step.cu"
_ENTRY = {
    (torch.float32, torch.float32): "grid_step_f32",
    (torch.float32, torch.bfloat16): "grid_step_f32_bf16",
    (torch.float64, torch.float64): "grid_step_f64",
    (torch.float64, torch.bfloat16): "grid_step_f64_bf16",
}
_WORK_PLANES = 18  # K3's six, its rhs, warm start and solution, 2×3 viscous, 2 stage, 1 div
_vp, _int, _dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGTYPES = (grid_cg._OP_ARGS * 4 + [_vp] * 8 + [_int] * 3 + [_vp] * 16 + [_dbl] * 7
             + [_int, _dbl, _int, _dbl, _int, _int, _vp, _vp, _vp])
_lib: ctypes.CDLL | None = None


def load(source=SOURCE) -> ctypes.CDLL:
    """Compile ``source`` (unless cached) and load it with the entry points'
    argument types set (another copy of the source: to time beside it)."""
    lib = _nvcc.build(source)
    for name in _ENTRY.values():
        getattr(lib, name).argtypes = _ARGTYPES
        getattr(lib, name).restype = ctypes.c_int
    return lib


def build() -> ctypes.CDLL:
    """Compile (unless cached) and load the K5 library the wrapper launches."""
    global _lib
    if _lib is None:
        _lib = load()
    return _lib


def library_path():
    return _nvcc.library_path(SOURCE)


def blocks_per_sm() -> dict[str, int]:
    """Blocks per SM of each K5 instance, as the cooperative launch finds
    them on the current card."""
    names = ["grid_step f32", "grid_step f32 bf16", "grid_step f64", "grid_step f64 bf16"]
    out = (ctypes.c_int * len(names))()
    build().grid_step_blocks_per_sm(out, len(names))
    return dict(zip(names, out))


def steps_per_call(config) -> int:
    """K, the physics steps one K5 launch advances, from the configuration:
    0 (K5 off, the default), else ``grid_steps_per_call``, forced to 1 under
    transport, which samples the velocity every step."""
    k = int(config.grid_steps_per_call or 0)
    if k > 1 and config.transport != "none":
        return 1
    return max(k, 0)


@dataclasses.dataclass(frozen=True)
class GridStokesStep:
    """K5's operators and masks, on the problem's device; calling it runs
    ``steps_per_call`` steps (see :meth:`__call__`)."""

    visc: ViscousGridCG
    pressure: PressureGridCG
    Gdx: GridOperator
    Gdy: GridOperator
    wall_mask: torch.Tensor  # (N,)
    inner_mask: torch.Tensor  # (N,)
    inner_vals: torch.Tensor  # (N, 2) squirmer values on the inner nodes
    interior2: torch.Tensor  # (N,) nodes the second projection updates
    outer_value: tuple
    dt: float
    body_force: tuple
    steps_per_call: int = 1

    def __post_init__(self):
        # K5's pressure solves keep the full planes in the preconditioner:
        # tpufem's whole-step kernel has no precond_bf16 (pallas_step.py),
        # and its gate (the streamed regime) is where tpufem refuses K5
        if self.pressure.K_pre is not None:
            object.__setattr__(self, "pressure", dataclasses.replace(self.pressure, K_pre=None))

    @classmethod
    def build(cls, problem) -> "GridStokesStep | None":
        """From a ``StokesProblem`` with grid solvers; None (the unfused
        path runs) where tpufem's ``build`` refuses, except for its
        ``stream_diags`` capacity limit."""
        from tpufem_torch.ops import calculus

        cfg = problem.config
        if not (isinstance(problem.visc_solver, ViscousGridCG)
                and isinstance(problem.pressure_solver, PressureGridCG)
                and cfg.variant != "report" and cfg.ramp_steps == 0
                and cfg.double_projection and not cfg.dirichlet_lift):
            return None
        k = steps_per_call(cfg)
        if k < 1:
            return None
        if k > 1 and not (cfg.cg_warm_start and cfg.cg_tol_visc > 0):
            # the kernel chains u*, p and p2 between its inner steps, which
            # matches K separate steps only when those warm-start too
            raise ValueError(
                "grid_steps_per_call>1 requires cg_warm_start=True and cg_tol_visc>0: the "
                "fused kernel chains warm starts across inner steps, which only matches "
                "the K=1 path when the K=1 path also warm-starts")
        mesh, b = problem.mesh, problem.boundary
        ns, n = problem.visc_solver.K.ns, mesh.n_nodes
        dtype, dev = problem.dtype, problem.device
        dx_csr, dy_csr = calculus.divergence_csr_operators(mesh)

        def nodes(idx, values=1.0, shape=(n,)):
            out = np.zeros(shape)
            out[np.asarray(idx, dtype=np.int64)] = values
            return torch.as_tensor(out, dtype=dtype, device=dev)

        return cls(
            visc=problem.visc_solver,
            pressure=problem.pressure_solver,
            Gdx=GridOperator.dense_split(dx_csr, ns, dtype=dtype, device=dev),
            Gdy=GridOperator.dense_split(dy_csr, ns, dtype=dtype, device=dev),
            wall_mask=nodes(b.walls),
            inner_mask=nodes(b.inner),
            inner_vals=nodes(b.inner, problem.inner_values.cpu().double().numpy(), (n, 2)),
            interior2=nodes(b.interior),
            outer_value=tuple(float(v) for v in np.asarray(cfg.outer_value)),
            dt=float(cfg.dt),
            body_force=tuple(float(v) for v in np.asarray(cfg.body_force)),
            steps_per_call=k,
        )

    @property
    def ns(self) -> int:
        return self.visc.K.ns

    def _grid(self, v: torch.Tensor) -> torch.Tensor:
        return v.reshape(self.ns, self.ns).contiguous()

    @functools.cached_property
    def planes(self) -> dict[str, torch.Tensor]:
        """The (ns, ns) mask and value planes both versions read."""
        p = self.pressure
        return {
            "wall": self._grid(self.wall_mask), "inner": self._grid(self.inner_mask),
            "ivx": self._grid(self.inner_vals[:, 0]), "ivy": self._grid(self.inner_vals[:, 1]),
            "int2": self._grid(self.interior2), "ml": self._grid(p.m_lumped),
            "mmask": self._grid(p.master_mask), "smask": self._grid(p.slave_mask),
        }

    def __call__(self, u: torch.Tensor, warm: dict | None):
        """``projection_step``'s contract: (u_new, p, metrics, warm_out) after
        ``steps_per_call`` steps.  Metrics are per-step series of length K
        when K > 1 (``stokes.run`` flattens them), else the step's values;
        ``warm_out`` is None without ``warm`` and carries ``"u_star"`` only
        when it came in."""
        ns, n = self.ns, self.ns * self.ns

        def planes(v):  # (N, 2) → (2, ns, ns)
            return v.T.reshape(2, ns, ns).contiguous()

        ug = planes(u)
        has_us = warm is not None and "u_star" in warm
        us0 = planes(warm["u_star"]) if has_us else torch.zeros_like(ug)
        zero = torch.zeros((ns, ns), dtype=ug.dtype, device=ug.device)
        p0 = warm["p"].reshape(ns, ns) if warm is not None else zero
        p20 = warm["p2"].reshape(ns, ns) if warm is not None else zero
        fn = grid_step_ref if self.visc.plain else grid_step
        u2, us, p, p2, met = fn(self, ug, us0, p0, p20, self.visc.iters_count,
                                self.pressure.iters_count)
        names = ("div_star_max", "final_div_max", "max_u")
        if self.steps_per_call > 1:
            metrics = {k: met[:, j] for j, k in enumerate(names)}
        else:
            metrics = {k: met[-1, j] for j, k in enumerate(names)}
        p_flat = p.reshape(n)
        if warm is None:
            return u2.reshape(2, n).T, p_flat, metrics, None
        warm_out = {"p": p_flat, "p2": p2.reshape(n)}
        if has_us:
            warm_out["u_star"] = us.reshape(2, n).T
        return u2.reshape(2, n).T, p_flat, metrics, warm_out


def _shift(X: torch.Tensor, axis: int, k: int) -> torch.Tensor:
    """out[…, i, …] = X[…, (i + k) mod ns, …] along grid axis ``axis``."""
    return torch.roll(X, shifts=-k, dims=-2 + axis)


def grid_step_ref(step: GridStokesStep, u: torch.Tensor, us0: torch.Tensor, p0: torch.Tensor,
                  p20: torch.Tensor, visc_iters: torch.Tensor | None = None,
                  pres_iters: torch.Tensor | None = None):
    """Plain K5 on grid planes: u, us0 (2, ns, ns), p0, p20 (ns, ns) →
    (u, u*, p, p2, metrics (K, 3)), tpufem's ``_step_fn`` op for op.  The
    counters, when given, get the viscous iterations of each step (the
    larger column's, as K2 counts them) and the pressure iterations of each
    solve added."""
    visc, pres, pl = step.visc, step.pressure, step.planes
    dt, axis = step.dt, pres.pair_axis
    Gdx, Gdy = step.Gdx, step.Gdy
    ml, act, mm, sm = pl["ml"], pres.act_grid, pl["mmask"], pl["smask"]
    wall, inner, int2 = pl["wall"], pl["inner"], pl["int2"]

    def div(X):
        return Gdx.matvec_grid(X[0], round32=True) + Gdy.matvec_grid(X[1], round32=True)

    def grad(P):
        return torch.stack([Gdx.matvec_grid(P, round32=True), Gdy.matvec_grid(P, round32=True)])

    def bcs(X):  # periodic copy → walls → inner
        out = []
        for c, (o, iv) in enumerate(((step.outer_value[0], pl["ivx"]),
                                     (step.outer_value[1], pl["ivy"]))):
            v = X[c] * (1.0 - sm) + _shift(X[c] * mm, axis, 1) * sm
            v = v * (1.0 - wall) + wall * o
            out.append(v * (1.0 - inner) + inner * iv)
        return torch.stack(out)

    def psolve(bfield, P):
        rhs = ml * bfield
        rhs = (rhs + _shift(rhs * sm, axis, -1) * mm) * act
        x = pressure_cg_ref(pres, rhs, P * act, pres_iters)
        return x * (1.0 - sm) + _shift(x * mm, axis, 1) * sm

    met = torch.empty((step.steps_per_call, 3), dtype=u.dtype, device=u.device)
    us, p, p2 = us0.clone(), p0, p20
    for i in range(step.steps_per_call):
        counts = []
        for c in range(2):  # each column stops on its own test
            count = None if visc_iters is None else torch.zeros_like(visc_iters)
            us[c] = viscous_cg_ref(visc, (u[c] + dt * step.body_force[c])[None], us[c][None],
                                   count)[0]
            counts.append(count)
        if visc_iters is not None:
            visc_iters += torch.maximum(*counts)
        stage = bcs(us)
        dstar = div(stage)
        met[i, 0] = torch.max(torch.abs(dstar))
        p = psolve(-dstar / dt, p)
        stage = bcs(stage - dt * grad(p))
        p2 = psolve(-div(stage) / dt, p2)
        u = stage - dt * grad(p2) * int2
        met[i, 1] = torch.max(torch.abs(div(u)))
        met[i, 2] = torch.max(torch.abs(u))
    return u, us, p, p2, met


def grid_step(step: GridStokesStep, u: torch.Tensor, us0: torch.Tensor, p0: torch.Tensor,
              p20: torch.Tensor, visc_iters: torch.Tensor | None = None,
              pres_iters: torch.Tensor | None = None):
    """K5: the kernel on CUDA tensors, :func:`grid_step_ref` on CPU tensors;
    arguments and results as there."""
    visc, pres = step.visc, step.pressure
    K = visc.K
    grid_cg._check_planes(K, u, us0, p0, p20)
    if u.shape != (2, K.ns, K.ns) or us0.shape != u.shape or p0.shape != (K.ns, K.ns) \
            or p20.shape != p0.shape:
        raise ValueError(f"need u, u* of shape (2, {K.ns}, {K.ns}) and p, p2 of ({K.ns}, "
                         f"{K.ns}); got {tuple(u.shape)}, {tuple(us0.shape)}, "
                         f"{tuple(p0.shape)}, {tuple(p20.shape)}")
    _check_counter(visc_iters, u)
    _check_counter(pres_iters, u)
    if not _device_ok(u, "K5"):
        return grid_step_ref(step, u, us0, p0, p20, visc_iters, pres_iters)
    key = (u.dtype, pres.ac_inv.dtype)
    if key not in _ENTRY:
        raise TypeError(f"K5 has no instance for fields {key[0]} with a {key[1]} coarse inverse")
    for op in (pres.K, step.Gdx, step.Gdy):
        grid_cg._check_planes(op, u)
    grid_cg._check_block(pres)
    lib = _lib or build()
    n, nc, pl = K.n, pres.n_blocks, step.planes
    u, us0, p0, p20 = (t.contiguous() for t in (u, us0, p0, p20))
    outs = [torch.empty_like(u), torch.empty_like(u), torch.empty_like(p0), torch.empty_like(p0),
            torch.empty((step.steps_per_call, 3), dtype=u.dtype, device=u.device)]
    work = torch.empty(_WORK_PLANES * n + grid_cg._PARTIAL_VALUES, dtype=u.dtype, device=u.device)
    fwork = torch.empty(2 * nc * nc, dtype=torch.float32, device=u.device)
    _launch(getattr(lib, _ENTRY[key]), u.device,
            *_kernel_operator_args(K), *_kernel_operator_args(pres.K),
            *_kernel_operator_args(step.Gdx), *_kernel_operator_args(step.Gdy),
            visc.mask_grid.data_ptr(), visc.inv_diag_grid.data_ptr(), pl["ml"].data_ptr(),
            pres.act_grid.data_ptr(), pl["mmask"].data_ptr(), pl["smask"].data_ptr(),
            pres.inv_diag_grid.data_ptr(), pres.ac_inv.contiguous().data_ptr(),
            pres.block, nc, int(pres.use_coarse),
            *(pl[k].data_ptr() for k in ("wall", "inner", "ivx", "ivy", "int2")),
            *(t.data_ptr() for t in (u, us0, p0, p20, *outs)),
            work.data_ptr(), fwork.data_ptr(),
            step.dt, visc.dt_nu, step.dt * step.body_force[0], step.dt * step.body_force[1],
            *step.outer_value, pres.omega, int(visc.iters), float(visc.tol), int(pres.iters),
            float(pres.tol), int(pres.pair_axis), int(step.steps_per_call),
            *(None if t is None else t.data_ptr() for t in (visc_iters, pres_iters)))
    grid_step.launches += 1
    return tuple(outs)


grid_step.launches = 0
