"""Whole-solve Krylov solvers on the grid-offset operator: kernels K2, K3, K4.

The counterpart of ``tpufem.solve.pallas_cg`` on ring-in-grid meshes
(N = ns²), over a :class:`~tpufem_torch.ops.gridop.GridOperator`:

* :class:`ViscousGridCG`: ``(m·(I + dtν·K)·m + (1−m)I) x = b`` for both
  velocity columns in lockstep, Jacobi-PCG, warm start, ``tol > 0`` early
  exit once every column has converged (kernel K2: two fused phases and two
  grid syncs an iteration, both columns in one apply);
* :class:`PressureGridCG`: the merged periodic pressure operator with
  constant-nullspace deflation on the active dofs and the two-level
  preconditioner (damped Jacobi ω = 1/λmax, block-aggregate restriction,
  dense coarse inverse, piecewise-constant prolongation), ``tol > 0`` early
  exit (kernel K3);
* :class:`NSGridBiCGStab`: the Navier–Stokes velocity system
  ``(m·(I + Δt·C(u) + νΔt·K)·m + (1−m)I) x = b``, nonsymmetric and refilled
  every step, right-preconditioned Jacobi-BiCGStab for both columns in
  lockstep with finite-or-zero guards, ``tol > 0`` early exit once every
  column has converged (kernel K4).

For each kernel there are three functions:

* the plain PyTorch version (:func:`viscous_cg_ref`, :func:`pressure_cg_ref`,
  :func:`ns_bicgstab_ref`), which follows tpufem's ``_cg_core_cols`` /
  ``_cg_core`` / ``_bicgstab_core_cols`` step for step: denominator guards,
  the loop condition, where the projections sit, and the float32 rounding
  (below);
* the wrapper (:func:`viscous_cg`, :func:`pressure_cg`, :func:`ns_bicgstab`),
  which launches the CUDA kernel in ``csrc/grid_cg.cu`` for CUDA tensors,
  takes the plain version for CPU tensors, and raises for anything else;
* the wrapper's launch count, ``<wrapper>.launches``; the wrappers also
  record their launch as a span, ``k2.launch``, ``k3.launch`` and
  ``k4.launch`` (:func:`tpufem_torch.metrics.span`).

The solves round to float32 where tpufem's kernels do, at every field
precision: the TPU kernels take ``preferred_element_type=float32`` in the
operator's remainder products (``pallas_cg.py:388-392``, so each remainder
source value and each target's remainder sum is a float32 value; an
operator without ``rest_round32``, the card split from 360,000 nodes where
tpufem's f64 runs CSR, keeps its remainder in the field's precision) and in
the two-level restriction and coarse products (``pallas_cg.py:1362``;
there the lane-block stage takes float32 operands and accumulates in
float32).  With a bfloat16 coarse inverse the restricted vector is rounded
to bfloat16 first and the product accumulates in float32.

The solvers' TPU-only fields (``stream_diags``, ``stream_loop``,
``hbm_io``, ``roll_cache``, ``stream_chunk``, ``lean``, K4's
``batch_cols``) are accepted so that configurations carry across, and
ignored; the port always runs the velocity columns in lockstep (tpufem's
``batch_cols=True``).  K3 has two more modes of tpufem's:

* ``precond_bf16``: the preconditioner's two applies read K̃, the
  operator with bfloat16 planes (:meth:`~tpufem_torch.ops.gridop.
  GridOperator.bf16_preconditioner`), while the CG's own apply keeps K.
  As in tpufem it is taken only with the two-level preconditioner in the
  streamed regime (``stream_diags``); :meth:`PressureGridCG.build` makes
  K̃ then (``K_pre``).  K3's instances ``pressure_cg_*_pb16`` run it.
* ``probe="nofma"|"nodma"|"exchange"``: measurement variants with wrong
  results by design (``roofline.probes``): every apply the remainder alone
  after loading and dropping its plane entries, or each plane replaced by
  its constant, the plane's mean, with no plane read; or (``exchange``, the
  port's own) no point visited between the grid barriers, so that an
  iteration is its syncs, reductions and coarse product and the solve
  returns its projected start.  Their kernels have f32 fields with an f32
  or bf16 coarse inverse, and f64 fields with an f64 one, and launch on the
  real kernel's blocks.

``plain=True`` (K2/K3) and ``interpret=True`` (K4, tpufem's name), set by
``cg_storage="grid_interpret"``, take the plain versions on every device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from tpufem_torch.metrics import span
from tpufem_torch.ops import _nvcc
from tpufem_torch.ops.gridop import GridDecompositionError, GridOperator
from tpufem_torch.solve.cg import bicgstab_core

SOURCE = _nvcc.CSRC / "grid_cg.cu"
_PARTIAL_VALUES = 2 * 4096 * 8  # kMaxBlocks × kSlots × 2 slots, as in the source
_VISCOUS = {torch.float32: "viscous_cg_f32", torch.float64: "viscous_cg_f64"}
_PRESSURE = {
    (torch.float32, torch.float32): "pressure_cg_f32",
    (torch.float32, torch.bfloat16): "pressure_cg_f32_bf16",
    (torch.float64, torch.float64): "pressure_cg_f64",
    (torch.float64, torch.bfloat16): "pressure_cg_f64_bf16",
}
_NS = {torch.float32: "ns_bicgstab_f32", torch.float64: "ns_bicgstab_f64"}
# K3's variants by (mode, field dtype, coarse inverse dtype): "pb16" (bf16
# preconditioner planes) and the probes
_PRESSURE_VARIANTS = {
    **{("pb16", *key): f"{name}_pb16" for key, name in _PRESSURE.items()},
    **{(probe, dt, cd): f"pressure_{probe}_{name}" for probe in ("nofma", "nodma", "exchange")
       for (dt, cd), name in (((torch.float32, torch.float32), "f32"),
                              ((torch.float32, torch.bfloat16), "f32_bf16"),
                              ((torch.float64, torch.float64), "f64"))},
}
PROBES = ("", "nofma", "nodma", "exchange")
_VISCOUS_PLANES = 4  # K2's work planes a column: r, q, and p twice (read one, write one)
_NS_PLANES = 7  # K4's work planes a column: r̂, r, t, and p and v twice (read one, write one)
_PRESSURE_PLANES = 6  # K3's work planes: r and p twice (read one, write the other), q, z
_MAX_BLOCK = 1024  # K3's widest aggregation block (kTile in the source)
_lib: ctypes.CDLL | None = None

_vp, _int, _dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# planes, shift tables, remainder, its rounding to float32
_OP_ARGS = [_vp, _vp, _vp, _int, _int, _vp, _vp, _vp, _vp, _int]
_VISCOUS_ARGTYPES = _OP_ARGS + [_vp] * 6 + [_int, _dbl, _int, _dbl, _vp, _vp]
_PRESSURE_ARGTYPES = _OP_ARGS + [_vp] * 3 + [_int] * 3 + [_vp] * 5 + [_dbl, _int, _dbl, _vp, _vp]
_VARIANT_ARGTYPES = {  # the second plane set and its remainder; the planes' constants
    "pb16": _OP_ARGS + [_vp] * 5 + _PRESSURE_ARGTYPES[len(_OP_ARGS):],
    "nofma": _PRESSURE_ARGTYPES,
    "nodma": _OP_ARGS + [_vp] + _PRESSURE_ARGTYPES[len(_OP_ARGS):],
    "exchange": _PRESSURE_ARGTYPES,
}
_NS_ARGTYPES = _OP_ARGS + [_vp] * 6 + [_int, _int, _dbl, _vp, _vp]


def load(source=SOURCE) -> ctypes.CDLL:
    """Compile ``source`` (unless cached) and load it with the argument
    types set of the entry points it has: the tree's K2/K3/K4 by default,
    or another copy of the source (a parent's, a variant) to time beside
    it."""
    lib = _nvcc.build(source)
    tables = [(_VISCOUS.values(), _VISCOUS_ARGTYPES), (_PRESSURE.values(), _PRESSURE_ARGTYPES),
              (_NS.values(), _NS_ARGTYPES)]
    tables += [([name], _VARIANT_ARGTYPES[key[0]]) for key, name in _PRESSURE_VARIANTS.items()]
    for names, argtypes in tables:
        for name in names:
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
    return lib


def build() -> ctypes.CDLL:
    """Compile (unless cached) and load the K2/K3/K4 library the wrappers
    launch (``_lib``)."""
    global _lib
    if _lib is None:
        with span("grid_cg.build"):
            _lib = load()
    return _lib


def library_path():
    return _nvcc.library_path(SOURCE)


def blocks_per_sm(lib: ctypes.CDLL | None = None) -> dict[str, int]:
    """Blocks per SM of each kernel instance in ``lib`` (default: the
    wrappers' library), as the cooperative launch finds them on the
    current card.  K2's instances carry the blocks per SM their register
    budget is set for (in f32 4 where an iteration streams from HBM, 5
    where it fits in L2)."""
    names = [f"{k} {t}" for k, types in (
        ("viscous_cg", ("f32 C=1 4/SM", "f32 C=1 5/SM", "f32 C=2 4/SM", "f32 C=2 5/SM",
                        "f64 C=1 2/SM", "f64 C=2 2/SM")),
        ("pressure_cg", ("f32", "f32 bf16", "f64", "f64 bf16")),
        ("ns_bicgstab", ("f32 C=1", "f32 C=2", "f64 C=1", "f64 C=2")),
        ("pressure_pb16", ("f32", "f32 bf16", "f64", "f64 bf16")),
        ("pressure_nofma", ("f32", "f32 bf16", "f64")),
        ("pressure_nodma", ("f32", "f32 bf16", "f64")),
        ("pressure_exchange", ("f32", "f32 bf16", "f64"))) for t in types]
    out = (ctypes.c_int * len(names))()
    got = (lib or build()).grid_cg_blocks_per_sm(out, len(names))
    return dict(zip(names[:got], out))


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
    the whole solve in one launch of K2 (each plane entry read once for
    both columns; p formed where the apply reads it, so two grid syncs an
    iteration)."""

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

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """The solved operator, ``m·(x + dtν·K(m·x)) + (1−m)·x``, on flat (N,)
        fields (plain tensor code)."""
        m = self.interior_mask
        return m * (x + self.dt_nu * self.K.matvec(m * x)) + (1.0 - m) * x

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
    (source row and lane offsets mod ns), the remainder and whether it
    rounds to float32."""
    rs = (ctypes.c_int * len(K.offsets))(*[dy % K.ns for dy, _ in K.offsets])
    ls = (ctypes.c_int * len(K.offsets))(*[s % K.ns for _, s in K.offsets])
    return [K.diags.data_ptr(), rs, ls, len(K.offsets), K.ns, K.rest_rowptr.data_ptr(),
            K.rest_lane.data_ptr(), K.rest_src.data_ptr(), K.rest_vals.data_ptr(),
            int(K.rest_round32)]


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
    with span("k2.launch"):
        x = torch.empty_like(b)
        work = torch.empty(_VISCOUS_PLANES * C * n + _PARTIAL_VALUES, dtype=b.dtype,
                           device=b.device)
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
    copy-back run as plain tensor code around it.

    Where ``K_pre`` is set (by :meth:`build` under ``precond_bf16``, on
    tpufem's gate) the preconditioner applies K̃, K with bfloat16 planes;
    ``probe`` selects a measurement variant (``roofline.probes``)."""

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
    probe: str = ""  # "", or a measurement variant: "nofma", "nodma", "exchange"
    K_pre: GridOperator | None = None  # K̃, the preconditioner's operator under precond_bf16

    def __post_init__(self):
        if self.probe not in PROBES:
            raise ValueError(f"unknown probe {self.probe!r}; expected one of {PROBES}")

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """The merged pressure operator ``K(x)`` on flat (N,) fields (plain
        tensor code)."""
        return self.K.matvec(x)

    @property
    def K_precond(self) -> GridOperator:
        """The operator the preconditioner's two applies read."""
        return self.K if self.K_pre is None else self.K_pre

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
        # tpufem's gate: the bf16 planes only for the streamed two-level solve
        bf16_planes = precond_bf16 and stream_diags and use_coarse

        def t(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        return cls(
            K=grid_op, m_lumped=t(m_lumped), active_mask=t(active_mask),
            master_mask=t(master_mask), slave_mask=t(slave_mask), iters=iters,
            ac_inv=t(ac_inv, coarse_dtype or dtype), block=blk, n_blocks=nc,
            omega=1.0 / float(lmax), tol=tol, plain=plain, pair_axis=pair_axis,
            use_coarse=use_coarse, stream_diags=stream_diags, stream_loop=stream_loop,
            hbm_io=hbm_io, roll_cache=roll_cache, stream_chunk=stream_chunk,
            K_pre=grid_op.bf16_preconditioner(K_merged_csr) if bf16_planes else None,
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

    @functools.cached_property
    def plane_constants(self) -> tuple[list, list]:
        """The "nodma" probe's constant for each plane of K and of the
        preconditioner's operator: the plane's mean in the field's dtype,
        as host floats (both versions use these values)."""
        return tuple(K.diags.to(K.rest_vals.dtype).mean(dim=(-2, -1)).tolist()
                     for K in (self.K, self.K_precond))

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
    Z = coarse_product(solver, flat.reshape(-1)).to(T.dtype).reshape(nc, nc)
    Z = Z.repeat_interleave(blk, 0).repeat_interleave(blk, 1)[:ns, :ns]
    return Z * solver.act_grid


def coarse_product(solver: PressureGridCG, flat: torch.Tensor) -> torch.Tensor:
    """A_c⁻¹·flat for the restricted vector ``flat`` (nc²,), as float32: the
    product in the coarse inverse's precision, rounded (with a bfloat16
    inverse, ``flat`` rounded to bfloat16 and the product taken in float32),
    as tpufem's ``preferred_element_type=float32`` coarse dot."""
    ai = solver.ac_inv
    if ai.dtype == torch.bfloat16:
        return ai.float() @ flat.to(torch.bfloat16).float()
    return (ai @ flat.to(ai.dtype)).to(torch.float32)


def _probe_apply(K: GridOperator, probe: str, constants: list):
    """X ↦ K·X (remainder rounded as the kernels round it) as a K3 apply
    under ``probe``: the operator's own, its remainder alone ("nofma"), or
    each plane replaced by its constant ("nodma")."""
    if probe == "nofma":
        return lambda X: K.rest_apply(X, round32=True) if K.n_rest else torch.zeros_like(X)
    if probe == "nodma":
        c = torch.tensor(constants, dtype=K.rest_vals.dtype, device=K.device)
        K = dataclasses.replace(K, diags=c[:, None, None].expand(len(K.offsets), K.ns, K.ns))
    return lambda X: K.matvec_grid(X, round32=True)


def pressure_cg_ref(solver: PressureGridCG, b: torch.Tensor, x0: torch.Tensor,
                    iters_out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain K3 on (ns, ns) planes (b is the prepared rhs): tpufem's
    ``_cg_core`` with the deflation projection and the two-level
    preconditioner, whose two applies read ``solver.K_precond`` (K̃ under
    ``precond_bf16``), and every apply as ``solver.probe`` has it.  With
    ``tol > 0`` the loop condition is read on the host each iteration."""
    act, invd = solver.act_grid, solver.inv_diag_grid
    omega, iters, tol = solver.omega, solver.iters, solver.tol
    ww = torch.sum(act * act)
    mv, mvp = (_probe_apply(K, solver.probe, c)
               for K, c in zip((solver.K, solver.K_precond), solver.plane_constants))

    def project(X):
        return X - (torch.sum(act * X) / ww) * act

    if solver.probe == "exchange":  # no point visited: r·r reads 0, so tol > 0 stops at once
        if iters_out is not None:
            iters_out += iters if tol <= 0 else 0
        return project(x0)

    def precond(r):
        if not solver.use_coarse:
            return invd * r
        z1 = omega * (invd * r)
        z2 = z1 + coarse_ref(solver, r - mvp(z1))
        return z2 + omega * (invd * (r - mvp(z2)))

    b = project(b)
    r = project(b - mv(x0))
    z = project(precond(r))
    x, p, rz = x0, z, torch.sum(r * z)
    atol2 = (tol * torch.clamp(torch.sqrt(torch.sum(b * b)), min=1e-30)) ** 2
    k = 0
    while k < iters and (tol <= 0 or bool(torch.sum(r * r) > atol2)):
        Ap = project(mv(p))
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


def _check_block(solver: PressureGridCG) -> None:
    if solver.block > _MAX_BLOCK:
        raise ValueError(f"K3 tiles the grid by aggregation blocks of at most {_MAX_BLOCK} lanes, "
                         f"not {solver.block}: ask for more coarse nodes")


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
    if solver.probe and solver.K_pre is not None:
        raise TypeError("K3 has no probe instance with bfloat16 preconditioner planes")
    variant = solver.probe or ("pb16" if solver.K_pre is not None else "")
    key = (b.dtype, solver.ac_inv.dtype)
    name = _PRESSURE.get(key) if not variant else _PRESSURE_VARIANTS.get((variant, *key))
    if name is None:
        raise TypeError(f"K3 has no {variant + ' ' if variant else ''}instance for fields "
                        f"{key[0]} with a {key[1]} coarse inverse")
    _check_block(solver)
    lib = _lib or build()
    extra = []  # the variant's arguments after the operator's
    if variant == "pb16":
        Kp = solver.K_pre
        if (Kp.offsets != K.offsets or Kp.diags.dtype != torch.bfloat16
                or Kp.rest_vals.dtype != b.dtype or Kp.device != b.device):
            raise ValueError("K_pre must hold bfloat16 planes on K's offsets and a remainder "
                             "in the field's dtype, on its device")
        extra = [Kp.diags.data_ptr(), Kp.rest_rowptr.data_ptr(), Kp.rest_lane.data_ptr(),
                 Kp.rest_src.data_ptr(), Kp.rest_vals.data_ptr()]
    elif variant == "nodma":
        c = solver.plane_constants[0]
        extra = [(ctypes.c_double * len(c))(*c)]
    n, nc = K.n, solver.n_blocks
    b, x0 = b.contiguous(), x0.contiguous()
    with span("k3.launch"):
        x = torch.empty_like(b)
        work = torch.empty(_PRESSURE_PLANES * n + _PARTIAL_VALUES, dtype=b.dtype,
                           device=b.device)
        fwork = torch.empty(2 * nc * nc, dtype=torch.float32, device=b.device)  # rc, zc
        _launch(getattr(lib, name), b.device, *_kernel_operator_args(K), *extra,
                solver.act_grid.data_ptr(), solver.inv_diag_grid.data_ptr(),
                solver.ac_inv.contiguous().data_ptr(), solver.block, nc,
                int(solver.use_coarse), b.data_ptr(), x0.data_ptr(), x.data_ptr(),
                work.data_ptr(), fwork.data_ptr(), float(solver.omega), int(solver.iters),
                float(solver.tol), None if iters_out is None else iters_out.data_ptr())
    pressure_cg.launches += 1
    if variant:
        pressure_cg.variant_launches[variant] += 1
    return x


pressure_cg.launches = 0
# launches of K3's variants, each also counted in pressure_cg.launches
pressure_cg.variant_launches = {"pb16": 0, "nofma": 0, "nodma": 0, "exchange": 0}


# ---------------------------------------------------------------------------
# K4: Navier–Stokes velocity solve (nonsymmetric)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NSGridBiCGStab:
    """``(m·(I + A)·m + (1−m)I) x = b`` with A = Δt·C(u) + νΔt·K refilled
    every step: right-preconditioned Jacobi-BiCGStab, both velocity columns
    in lockstep, the whole solve in one launch of K4 (three fused phases
    and three grid syncs an iteration; each plane entry of A read once for
    both columns).  A's layout is the :class:`~tpufem_torch.ops.gridop.
    GridRefill` template's: the card's split of the mesh pattern.

    Only the static configuration lives here (tpufem's fields); the
    operator, mask and inverse diagonal are arguments of :meth:`solve`.
    ``interpret=True`` (``cg_storage="grid_interpret"``) takes the plain
    version on every device."""

    ns: int
    offsets: tuple  # the GridRefill template's (dy, s) offsets
    n_rest: int
    iters: int
    tol: float = 0.0
    interpret: bool = False
    iters_count: torch.Tensor | None = None  # as ViscousGridCG.iters_count
    # accepted and ignored: the port always runs the columns in lockstep
    # (tpufem's batch_cols=True), and the rest are TPU memory layouts
    batch_cols: bool = True
    stream_diags: bool = False
    roll_cache: bool = True
    hbm_io: bool = False

    def solve(self, op: GridOperator, interior_mask: torch.Tensor, inv_diag: torch.Tensor,
              b: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
        """``op``: this step's A (refilled); ``b``, ``x0``: (N, C) → x (N, C)."""
        ns = self.ns
        if op.ns != ns or op.offsets != tuple(self.offsets) or op.n_rest != self.n_rest:
            raise ValueError("the operator's layout is not this solver's")
        cols = b.shape[1]

        def planes(v):
            return v.T.reshape(cols, ns, ns).contiguous()

        fn = ns_bicgstab_ref if self.interpret else ns_bicgstab
        xg = fn(self, op, interior_mask.reshape(ns, ns).contiguous(),
                inv_diag.reshape(ns, ns).contiguous(), planes(b), planes(x0), self.iters_count)
        return xg.reshape(cols, ns * ns).T


def ns_bicgstab_ref(solver: NSGridBiCGStab, op: GridOperator, mask: torch.Tensor,
                    inv_diag: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
                    iters_out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain K4 on (C, ns, ns) planes: tpufem's ``_bicgstab_core_cols``
    (per-column scalars, finite-or-zero guards, x += α·p̂ then += ω·ŝ) as
    :func:`~tpufem_torch.solve.cg.bicgstab_core` runs it, the remainder
    rounded to float32 as in K2.  With ``tol > 0`` it runs while any
    column's ‖r‖² exceeds its (tol·‖b‖)², read on the host."""
    def dot(a, c):  # one scalar a column, (C, 1, 1)
        return torch.sum(a * c, dim=(-2, -1), keepdim=True)

    def mv(X):
        return mask * (X + op.matvec_grid(mask * X, round32=True)) + (1.0 - mask) * X

    atol2 = (solver.tol * torch.clamp(torch.sqrt(dot(b, b)), min=1e-30)) ** 2
    x, _, k = bicgstab_core(mv, b, x0, iters=solver.iters, precond=lambda r: inv_diag * r,
                            tol=solver.tol, atol2=atol2, dot=dot)
    if iters_out is not None:
        iters_out += k
    return x


def ns_bicgstab(solver: NSGridBiCGStab, op: GridOperator, mask: torch.Tensor,
                inv_diag: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
                iters_out: torch.Tensor | None = None) -> torch.Tensor:
    """K4 on (C, ns, ns) planes, C ≤ 2: the kernel on CUDA tensors, the
    plain version on CPU tensors.  ``iters_out`` as in :func:`viscous_cg`."""
    _check_planes(op, b, x0, mask, inv_diag)
    if b.ndim != 3 or b.shape != x0.shape or b.shape[0] not in (1, 2):
        raise ValueError(f"need b, x0 of shape (C ≤ 2, ns, ns); got {tuple(b.shape)}, "
                         f"{tuple(x0.shape)}")
    if mask.shape != (op.ns, op.ns) or inv_diag.shape != mask.shape:
        raise ValueError("need an (ns, ns) mask and inverse diagonal")
    _check_counter(iters_out, b)
    if not _device_ok(b, "K4"):
        return ns_bicgstab_ref(solver, op, mask, inv_diag, b, x0, iters_out)
    lib = _lib or build()
    C, n = b.shape[0], op.n
    b, x0 = b.contiguous(), x0.contiguous()
    with span("k4.launch"):
        x = torch.empty_like(b)
        work = torch.empty(_NS_PLANES * C * n + _PARTIAL_VALUES, dtype=b.dtype, device=b.device)
        _launch(getattr(lib, _NS[b.dtype]), b.device, *_kernel_operator_args(op),
                mask.contiguous().data_ptr(), inv_diag.contiguous().data_ptr(), b.data_ptr(),
                x0.data_ptr(), x.data_ptr(), work.data_ptr(), C, int(solver.iters),
                float(solver.tol), None if iters_out is None else iters_out.data_ptr())
    ns_bicgstab.launches += 1
    return x


ns_bicgstab.launches = 0
