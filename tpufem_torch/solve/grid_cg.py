"""Whole-solve PCG on the grid-offset operator: kernels K2 and K3.

The counterpart of ``tpufem.solve.pallas_cg`` for the Stokes step's two
solvers on ring-in-grid meshes (N = ns²), over a
:class:`~tpufem_torch.ops.gridop.GridOperator`:

* :class:`ViscousGridCG`: ``(m·(I + dtν·K)·m + (1−m)I) x = b`` for both
  velocity columns in lockstep, Jacobi-PCG, warm start, ``tol > 0`` early
  exit once every column has converged (kernel K2);
* :class:`PressureGridCG`: the merged periodic pressure operator with
  constant-nullspace deflation on the active dofs and the two-level
  preconditioner (damped Jacobi ω = 1/λmax, block-aggregate restriction,
  dense coarse inverse, piecewise-constant prolongation), ``tol > 0`` early
  exit (kernel K3).

For each kernel there are three functions:

* the plain PyTorch version (:func:`viscous_cg_ref`, :func:`pressure_cg_ref`),
  which follows tpufem's ``_cg_core_cols`` / ``_cg_core`` step for step:
  denominator guards, the loop condition, where the projections sit, and
  the coarse path's float32 rounding (below);
* the wrapper (:func:`viscous_cg`, :func:`pressure_cg`), which launches the
  CUDA kernel in ``csrc/grid_cg.cu`` for CUDA tensors, takes the plain
  version for CPU tensors, and raises for anything else;
* the wrapper's launch count, ``viscous_cg.launches`` / ``pressure_cg.launches``.

Both solves round to float32 where tpufem's kernels do, at every field
precision: the TPU kernels take ``preferred_element_type=float32`` in the
operator's remainder products (``pallas_cg.py:388-392``, so each remainder
source value and each target's remainder sum is a float32 value) and in
the two-level restriction and coarse products (``pallas_cg.py:1362``;
there the lane-block stage takes float32 operands and accumulates in
float32).  With a bfloat16 coarse inverse the restricted vector is rounded
to bfloat16 first and the product accumulates in float32.

The solvers' TPU-only fields (``stream_diags``, ``stream_loop``,
``hbm_io``, ``roll_cache``, ``stream_chunk``, ``lean``) are accepted so
that configurations carry across, and ignored; the port always runs the
velocity columns in lockstep (tpufem's ``batch_cols=True``).  ``probe``
and ``precond_bf16`` are refused.  ``plain=True``
(``cg_storage="grid_interpret"``) takes the plain versions on every device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from tpufem_torch.ops import _nvcc
from tpufem_torch.ops.gridop import GridDecompositionError, GridOperator

SOURCE = _nvcc.CSRC / "grid_cg.cu"
_PARTIAL_VALUES = 2 * 4096 * 8  # kMaxBlocks × kSlots × 2 slots, as in the source
_VISCOUS = {torch.float32: "viscous_cg_f32", torch.float64: "viscous_cg_f64"}
_PRESSURE = {
    (torch.float32, torch.float32): "pressure_cg_f32",
    (torch.float32, torch.bfloat16): "pressure_cg_f32_bf16",
    (torch.float64, torch.float64): "pressure_cg_f64",
    (torch.float64, torch.bfloat16): "pressure_cg_f64_bf16",
}
_lib: ctypes.CDLL | None = None

_vp, _int, _dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_OP_ARGS = [_vp, _vp, _vp, _int, _int, _vp, _vp, _vp, _vp]  # planes, shifts, remainder
_VISCOUS_ARGTYPES = _OP_ARGS + [_vp] * 6 + [_int, _dbl, _int, _dbl, _vp, _vp]
_PRESSURE_ARGTYPES = _OP_ARGS + [_vp] * 3 + [_int] * 3 + [_vp] * 5 + [_dbl, _int, _dbl, _vp, _vp]


def build() -> ctypes.CDLL:
    """Compile (unless cached) and load the K2/K3 library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _nvcc.build(SOURCE)
    for name in _VISCOUS.values():
        getattr(lib, name).argtypes = _VISCOUS_ARGTYPES
        getattr(lib, name).restype = ctypes.c_int
    for name in _PRESSURE.values():
        getattr(lib, name).argtypes = _PRESSURE_ARGTYPES
        getattr(lib, name).restype = ctypes.c_int
    _lib = lib
    return lib


def library_path():
    return _nvcc.library_path(SOURCE)


def _dot2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-plane sum of a·b over the last two axes."""
    return torch.sum(a * b, dim=(-2, -1))


def _ratio(num, den):
    return torch.where(den != 0, num / den, torch.zeros_like(den))


def _round32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).to(x.dtype)


# ---------------------------------------------------------------------------
# K2: viscous solve
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ViscousGridCG:
    """``(m·(I + dtν·K)·m + (1−m)I) x = b`` per velocity column, Jacobi-PCG,
    the whole solve in one launch of K2."""

    K: GridOperator
    interior_mask: torch.Tensor  # (N,)
    dt_nu: float
    iters: int
    tol: float = 0.0
    plain: bool = False  # the plain version on every device ("grid_interpret")
    iters_count: torch.Tensor | None = None  # int32 (1,) on the device: each
    # solve adds its iteration count here (read it after a run, not in it)
    # TPU-only fields, accepted and ignored
    stream_diags: bool = False
    stream_loop: bool = False
    roll_cache: bool = True
    hbm_io: bool = False
    stream_chunk: int = 1

    @functools.cached_property
    def mask_grid(self) -> torch.Tensor:
        return self.interior_mask.reshape(self.K.ns, self.K.ns).contiguous()

    @functools.cached_property
    def inv_diag_grid(self) -> torch.Tensor:
        m = self.interior_mask
        d = torch.where(m > 0, 1.0 / (1.0 + self.dt_nu * self.K.diag()), torch.ones_like(m))
        return d.reshape(self.K.ns, self.K.ns).contiguous()

    def solve(self, b: torch.Tensor, x0: torch.Tensor | None = None) -> torch.Tensor:
        """b (N,) or (N, C) → x of the same shape."""
        ns = self.K.ns
        cols = 1 if b.ndim == 1 else b.shape[1]
        bg = b.T.reshape(cols, ns, ns).contiguous()
        x0g = torch.zeros_like(bg) if x0 is None else x0.T.reshape(cols, ns, ns).contiguous()
        fn = viscous_cg_ref if self.plain else viscous_cg
        xg = fn(self, bg, x0g, self.iters_count)
        if b.ndim == 1:
            return xg.reshape(-1)
        return xg.reshape(cols, ns * ns).T


def viscous_cg_ref(solver: ViscousGridCG, b: torch.Tensor, x0: torch.Tensor,
                   iters_out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain K2 on (C, ns, ns) planes: tpufem's ``_cg_core_cols`` with the
    viscous operator and the Jacobi preconditioner.  With ``tol > 0`` the
    loop condition is read on the host each iteration."""
    K, m, invd = solver.K, solver.mask_grid, solver.inv_diag_grid
    dt_nu, iters, tol = solver.dt_nu, solver.iters, solver.tol

    def mv(X):
        return m * (X + dt_nu * K.matvec_grid(m * X, round32=True)) + (1.0 - m) * X

    x = x0
    r = b - mv(x0)
    z = invd * r
    p, rz = z, _dot2(r, z)
    atol2 = (tol * torch.clamp(torch.sqrt(_dot2(b, b)), min=1e-30)) ** 2
    k = 0
    while k < iters and (tol <= 0 or bool(torch.any(_dot2(r, r) > atol2))):
        Ap = mv(p)
        alpha = _ratio(rz, _dot2(p, Ap))[:, None, None]
        x = x + alpha * p
        r = r - alpha * Ap
        z = invd * r
        rz_new = _dot2(r, z)
        beta = _ratio(rz_new, rz)[:, None, None]
        p = z + beta * p
        rz = rz_new
        k += 1
    if iters_out is not None:
        iters_out += k
    return x


def _kernel_operator_args(K: GridOperator):
    """The operator as the C interface takes it: planes, host shift tables
    (source row and lane offsets mod ns) and the remainder."""
    rs = (ctypes.c_int * len(K.offsets))(*[dy % K.ns for dy, _ in K.offsets])
    ls = (ctypes.c_int * len(K.offsets))(*[s % K.ns for _, s in K.offsets])
    return [K.diags.data_ptr(), rs, ls, len(K.offsets), K.ns, K.rest_rowptr.data_ptr(),
            K.rest_lane.data_ptr(), K.rest_src.data_ptr(), K.rest_vals.data_ptr()]


def _check_planes(K: GridOperator, *planes: torch.Tensor) -> None:
    for t in planes:
        if t.shape[-2:] != (K.ns, K.ns):
            raise ValueError(f"need (…, {K.ns}, {K.ns}) planes, got {tuple(t.shape)}")
        if t.dtype != K.dtype or t.device != K.device:
            raise TypeError(f"plane {t.dtype} on {t.device}, operator {K.dtype} on {K.device}")


def _check_counter(iters_out: torch.Tensor | None, like: torch.Tensor) -> None:
    if iters_out is not None and (iters_out.dtype != torch.int32 or iters_out.numel() != 1
                                  or iters_out.device != like.device):
        raise ValueError("iters_out must be one int32 element on the planes' device")


def _device_ok(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {t.device}")
    return True


def _launch(fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch._C._cuda_getCurrentRawStream(device.index)
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def viscous_cg(solver: ViscousGridCG, b: torch.Tensor, x0: torch.Tensor,
               iters_out: torch.Tensor | None = None) -> torch.Tensor:
    """K2 on (C, ns, ns) planes, C ≤ 2: the kernel on CUDA tensors, the plain
    version on CPU tensors.  ``iters_out`` (int32, one element, on the same
    device), when given, has the iteration count added to it."""
    K = solver.K
    _check_planes(K, b, x0)
    if b.ndim != 3 or b.shape != x0.shape or b.shape[0] not in (1, 2):
        raise ValueError(f"need b, x0 of shape (C ≤ 2, ns, ns); got {tuple(b.shape)}, "
                         f"{tuple(x0.shape)}")
    _check_counter(iters_out, b)
    if not _device_ok(b, "K2"):
        return viscous_cg_ref(solver, b, x0, iters_out)
    lib = _lib or build()
    C, n = b.shape[0], K.n
    b, x0 = b.contiguous(), x0.contiguous()
    x = torch.empty_like(b)
    work = torch.empty(3 * C * n + _PARTIAL_VALUES, dtype=b.dtype, device=b.device)
    _launch(getattr(lib, _VISCOUS[b.dtype]), b.device, *_kernel_operator_args(K),
            solver.mask_grid.data_ptr(), solver.inv_diag_grid.data_ptr(), b.data_ptr(),
            x0.data_ptr(), x.data_ptr(), work.data_ptr(), C, float(solver.dt_nu),
            int(solver.iters), float(solver.tol),
            None if iters_out is None else iters_out.data_ptr())
    viscous_cg.launches += 1
    return x


viscous_cg.launches = 0


# ---------------------------------------------------------------------------
# K3: pressure solve
# ---------------------------------------------------------------------------


def _block_pool(ns: int, target_coarse: int) -> tuple[int, int]:
    """(block size b, blocks per side nc) of the separable block aggregation:
    tpufem's ``_block_pool_matrices`` as numbers instead of one-hot
    matrices.  The last block is ragged when b does not divide ns."""
    per_side = max(2, int(round(np.sqrt(target_coarse))))
    b = max(1, int(np.ceil(ns / per_side)))
    return b, int(np.ceil(ns / b))


@dataclasses.dataclass(frozen=True)
class PressureGridCG:
    """The merged periodic pressure solve (two-level PCG with deflation),
    the whole solve in one launch of K3; the rhs merge and the slave
    copy-back run as plain tensor code around it."""

    K: GridOperator  # merged periodic pressure operator
    m_lumped: torch.Tensor  # (N,)
    active_mask: torch.Tensor  # (N,) 0.0 at slave and dummy dofs
    master_mask: torch.Tensor  # (N,) 1.0 at master dofs
    slave_mask: torch.Tensor  # (N,) 1.0 at slave dofs
    iters: int
    ac_inv: torch.Tensor  # (nc², nc²) regularized coarse inverse
    block: int  # aggregation block size b (blocks are b×b grid tiles)
    n_blocks: int  # blocks per side nc
    omega: float
    tol: float = 0.0
    plain: bool = False  # the plain version on every device ("grid_interpret")
    iters_count: torch.Tensor | None = None  # as ViscousGridCG.iters_count
    pair_axis: int = 0  # grid axis along which the periodic pairs sit
    use_coarse: bool = True  # False → plain Jacobi preconditioning
    # TPU-only fields, accepted and ignored
    stream_diags: bool = False
    stream_loop: bool = False
    lean: bool | None = None
    hbm_io: bool = False
    roll_cache: bool = True
    stream_chunk: int = 1
    # refused
    probe: str = ""
    precond_bf16: bool = False

    def __post_init__(self):
        if self.probe:
            raise NotImplementedError("PressureGridCG.probe is a TPU measurement mode; not ported")
        if self.precond_bf16:
            raise NotImplementedError(
                "PressureGridCG.precond_bf16 (cg_precond_bf16='on') is not ported to "
                "tpufem_torch (ROADMAP Queue 1 item 6)")

    @classmethod
    def build(cls, K_merged_csr, grid_op: GridOperator, m_lumped, masters, slaves,
              active_mask, iters: int, tol: float = 0.0, target_coarse: int = 1024,
              use_coarse: bool = True, coarse_dtype=None, plain: bool = False,
              stream_diags: bool = False, stream_loop: bool = False, hbm_io: bool = False,
              precond_bf16: bool = False, roll_cache: bool = True,
              stream_chunk: int = 1) -> "PressureGridCG":
        """Host-side set-up, as tpufem's: opposite-edge pairing check,
        block aggregation, Galerkin coarse inverse, ω by power iteration in
        the operator's dtype."""
        from tpufem_torch.solve.cg import estimate_lmax
        from tpufem_torch.solve.twolevel import coarse_inverse, galerkin_coarse

        ns = grid_op.ns
        n = ns * ns
        target_coarse = min(int(target_coarse), 1024)
        pair_axis = 0
        if len(masters):
            mi, mj = np.divmod(np.asarray(masters), ns)
            si, sj = np.divmod(np.asarray(slaves), ns)
            if (mi == 0).all() and (si == ns - 1).all() and (mj == sj).all():
                pair_axis = 0
            elif (mj == 0).all() and (sj == ns - 1).all() and (mi == si).all():
                pair_axis = 1
            else:
                raise GridDecompositionError(
                    "the pressure grid solve needs the periodic pairs on opposite grid edges")
        master_mask = np.zeros(n)
        slave_mask = np.zeros(n)
        master_mask[np.asarray(masters, dtype=np.int64)] = 1.0
        slave_mask[np.asarray(slaves, dtype=np.int64)] = 1.0

        blk, nc = _block_pool(ns, target_coarse)
        iy, ix = np.divmod(np.arange(n), ns)
        agg = ((iy // blk) * nc + ix // blk).astype(np.int32)
        ac_inv = coarse_inverse(galerkin_coarse(K_merged_csr, agg, nc * nc))

        diag = grid_op.diag()
        inv_diag = torch.where(diag > 0, 1.0 / torch.where(diag > 0, diag, torch.ones_like(diag)),
                               torch.ones_like(diag))
        lmax = estimate_lmax(grid_op.matvec, inv_diag, n)

        dtype, dev = grid_op.dtype, grid_op.device

        def t(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        return cls(
            K=grid_op, m_lumped=t(m_lumped), active_mask=t(active_mask),
            master_mask=t(master_mask), slave_mask=t(slave_mask), iters=iters,
            ac_inv=t(ac_inv, coarse_dtype or dtype), block=blk, n_blocks=nc,
            omega=1.0 / float(lmax), tol=tol, plain=plain, pair_axis=pair_axis,
            use_coarse=use_coarse, stream_diags=stream_diags, stream_loop=stream_loop,
            hbm_io=hbm_io, roll_cache=roll_cache, stream_chunk=stream_chunk,
            precond_bf16=precond_bf16 and stream_diags and use_coarse,
        )

    def _grid(self, v: torch.Tensor) -> torch.Tensor:
        return v.reshape(self.K.ns, self.K.ns)

    @functools.cached_property
    def act_grid(self) -> torch.Tensor:
        return self._grid(self.active_mask).contiguous()

    @functools.cached_property
    def inv_diag_grid(self) -> torch.Tensor:
        d = self.K.diag()
        inv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)),
                          torch.ones_like(d))
        return self._grid(inv).contiguous()

    def solve(self, b: torch.Tensor, x0: torch.Tensor | None = None) -> torch.Tensor:
        """K_merged p = merge(M_L ∘ b): rhs merge, the solve, master → slave copy."""
        ns = self.K.ns
        to_master = (ns - 1, 0) if self.pair_axis == 0 else (0, ns - 1)
        to_slave = (1, 0) if self.pair_axis == 0 else (0, 1)

        def roll(X, dy, s):
            return torch.roll(X, shifts=(-dy, -s), dims=(-2, -1))

        bg = self._grid(b)
        x0g = torch.zeros_like(bg) if x0 is None else self._grid(x0)
        ml, act = self._grid(self.m_lumped), self.act_grid
        mm, sm = self._grid(self.master_mask), self._grid(self.slave_mask)
        rhs = ml * bg
        rhs = rhs + roll(rhs * sm, *to_master) * mm
        rhs = (rhs * act).contiguous()
        fn = pressure_cg_ref if self.plain else pressure_cg
        p = fn(self, rhs, (x0g * act).contiguous(), self.iters_count)
        return (p * (1.0 - sm) + roll(p * mm, *to_slave) * sm).reshape(-1)


def coarse_ref(solver: PressureGridCG, T: torch.Tensor) -> torch.Tensor:
    """The coarse correction P·A_c⁻¹·Pᵀ·T, times the active mask, with
    tpufem's float32 rounding: the row-block sums are taken in the field's
    precision and rounded, the lane-block sums of those float32 values are
    accumulated in float32 in lane order, and the coarse product is taken
    in the coarse inverse's precision (float32 for bfloat16) and rounded."""
    ns, blk, nc = solver.K.ns, solver.block, solver.n_blocks
    pad = nc * blk - ns
    Tp = torch.nn.functional.pad(T, (0, pad, 0, pad))
    r1 = Tp.reshape(nc, blk, nc * blk).sum(1).to(torch.float32)  # (nc, ns_pad) row-block sums
    r1 = r1.reshape(nc, nc, blk)
    flat = r1[..., 0]
    for j in range(1, blk):  # lane-block sums, float32, in lane order
        flat = flat + r1[..., j]
    flat = flat.reshape(-1)
    ai = solver.ac_inv
    if ai.dtype == torch.bfloat16:
        zc = ai.float() @ flat.to(torch.bfloat16).float()
    else:
        zc = (ai @ flat.to(ai.dtype)).to(torch.float32)
    Z = zc.to(T.dtype).reshape(nc, nc)
    Z = Z.repeat_interleave(blk, 0).repeat_interleave(blk, 1)[:ns, :ns]
    return Z * solver.act_grid


def pressure_cg_ref(solver: PressureGridCG, b: torch.Tensor, x0: torch.Tensor,
                    iters_out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain K3 on (ns, ns) planes (b is the prepared rhs): tpufem's
    ``_cg_core`` with the deflation projection and the two-level
    preconditioner.  With ``tol > 0`` the loop condition is read on the
    host each iteration."""
    K, act, invd = solver.K, solver.act_grid, solver.inv_diag_grid
    omega, iters, tol = solver.omega, solver.iters, solver.tol
    ww = torch.sum(act * act)

    def project(X):
        return X - (torch.sum(act * X) / ww) * act

    def precond(r):
        if not solver.use_coarse:
            return invd * r
        z1 = omega * (invd * r)
        z2 = z1 + coarse_ref(solver, r - K.matvec_grid(z1, round32=True))
        return z2 + omega * (invd * (r - K.matvec_grid(z2, round32=True)))

    b = project(b)
    r = project(b - K.matvec_grid(x0, round32=True))
    z = project(precond(r))
    x, p, rz = x0, z, torch.sum(r * z)
    atol2 = (tol * torch.clamp(torch.sqrt(torch.sum(b * b)), min=1e-30)) ** 2
    k = 0
    while k < iters and (tol <= 0 or bool(torch.sum(r * r) > atol2)):
        Ap = project(K.matvec_grid(p, round32=True))
        alpha = _ratio(rz, torch.sum(p * Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = project(precond(r))
        rz_new = torch.sum(r * z)
        beta = _ratio(rz_new, rz)
        p = z + beta * p
        rz = rz_new
        k += 1
    if iters_out is not None:
        iters_out += k
    return project(x)


def pressure_cg(solver: PressureGridCG, b: torch.Tensor, x0: torch.Tensor,
                iters_out: torch.Tensor | None = None) -> torch.Tensor:
    """K3 on (ns, ns) planes: the kernel on CUDA tensors, the plain version
    on CPU tensors.  ``b`` is the prepared rhs, ``x0`` the masked warm start."""
    K = solver.K
    _check_planes(K, b, x0)
    if b.shape != (K.ns, K.ns) or x0.shape != b.shape:
        raise ValueError(f"need b, x0 of shape ({K.ns}, {K.ns}); got {tuple(b.shape)}, "
                         f"{tuple(x0.shape)}")
    _check_counter(iters_out, b)
    if not _device_ok(b, "K3"):
        return pressure_cg_ref(solver, b, x0, iters_out)
    key = (b.dtype, solver.ac_inv.dtype)
    if key not in _PRESSURE:
        raise TypeError(f"K3 has no instance for fields {key[0]} with a {key[1]} coarse inverse")
    lib = _lib or build()
    n, nc = K.n, solver.n_blocks
    b, x0 = b.contiguous(), x0.contiguous()
    x = torch.empty_like(b)
    work = torch.empty(6 * n + _PARTIAL_VALUES, dtype=b.dtype, device=b.device)
    fwork = torch.empty(nc * K.ns + 2 * nc * nc, dtype=torch.float32, device=b.device)
    _launch(getattr(lib, _PRESSURE[key]), b.device, *_kernel_operator_args(K),
            solver.act_grid.data_ptr(), solver.inv_diag_grid.data_ptr(),
            solver.ac_inv.contiguous().data_ptr(), solver.block, nc, int(solver.use_coarse),
            b.data_ptr(), x0.data_ptr(), x.data_ptr(), work.data_ptr(), fwork.data_ptr(),
            float(solver.omega), int(solver.iters), float(solver.tol),
            None if iters_out is None else iters_out.data_ptr())
    pressure_cg.launches += 1
    return x


pressure_cg.launches = 0
