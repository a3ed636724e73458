// Kernels K2, K3 and K4: whole-solve Krylov solvers on the grid-offset
// operator of ring-in-grid meshes (N = ns² nodes), one launch per solve.
//
// Replaces the TPU kernels
//   K2  ViscousGridCG._solve_fn   (tpufem/solve/pallas_cg.py:825; kernel :862,
//       helpers _roll2 :44, _make_apply :89, _make_apply_cols :405,
//       _cg_core_cols :644): warm-started Jacobi-PCG on
//       (m(I + dtν K)m + (1−m)I) x = b, both velocity columns in lockstep;
//   K3  PressureGridCG._solve_fn  (pallas_cg.py:1275; kernel :1310,
//       _cg_core :597): PCG on the merged periodic pressure operator with
//       constant-nullspace deflation and the two-level preconditioner; with
//       precond_bf16 (:1147-1160, mvp :1349) the preconditioner's two
//       applies read bf16 planes (pressure_pb16_kernel below), and its
//       probes (pressure_nofma_kernel, pressure_nodma_kernel,
//       pressure_exchange_kernel) take out the plane products, the plane
//       reads, or every point between the grid barriers;
//   K4  NSGridBiCGStab._solve_fn  (pallas_cg.py:1844; kernels :1869/:1905,
//       _bicgstab_core_cols :1653): right-preconditioned Jacobi-BiCGStab on
//       the nonsymmetric Navier–Stokes velocity system
//       (m(I + Δt C(u) + νΔt K)m + (1−m)I) x = b, both columns in lockstep,
//       with the finite-or-zero guards on β, α and ω.  Its planes, remainder
//       values and inverse diagonal are new every step (GridRefill); only the
//       remainder pattern and the shift table are static.  One form: the
//       TPU's HBM-resident kernel_hbm exists for VMEM capacity only.
// All three exit early on the device when tol > 0.
//
// Operator: K·X = Σ_g d_g ⊙ X[(iy+dy_g) mod ns, (ix+s_g) mod ns] + R·x, both
// axes cyclic as tpufem's _roll2.  The (dy, s) table arrives as kernel
// parameters; the remainder R is a COO list sorted by target with row
// pointers, applied by target (the thread that owns a point sums its own
// entries in list order): no atomics, so every launch is deterministic.
//
// Design: one persistent cooperative launch per solve
// (cudaLaunchCooperativeKernel, occupancy × SM count blocks, grid-stride
// loops, cooperative_groups grid sync between dependent phases).  Every dot
// product is two-step: each block writes its partial sums, the grid syncs,
// and then every block sums all partials in the same fixed order and
// derives α, β and the stop test itself.  The early-exit decision is thus
// bit-identical in every block, which keeps the grid syncs uniform (a
// non-uniform exit would deadlock them).  Partials alternate between two
// slots, so no block overwrites a slot another block may still read.
//
// What bounds it on an H100 (3.35 TB/s HBM, 50 MB L2): the bytes an
// iteration moves.  Each apply streams the operator's planes once (n_off·N·4
// B in f32, evict-first) plus its remainder (12 B an entry).  The operators
// take the card's split (GridOperator.dense_split): at N = 1,048,576 the
// viscous and pressure operators keep their 5 dense planes (the diagonal and
// the four nearest neighbours, ~80 % filled); the other offsets, under 2 %
// full (tpufem's split carried 20 and 26 planes there, for its TPU's one-hot
// remainder), are ~8k remainder entries a lane search finds
// (grid_common.cuh).
//   K2 applies K once an iteration, both columns at once (apply_cols), in
//   two fused phases with one grid sync each (below): 10·C + 3 vector
//   passes (23 for two columns; the mask and D⁻¹ counted in each phase that
//   reads them), 21 + 96 MB and 0.035 ms an iteration at the HBM peak
//   (tpufem's 20 planes: 181 MB, 0.054 ms).  On the Taylor–Hood velocity
//   operator of n_side 192 (383² raster, 24 planes, 20,782 remainder
//   entries) an iteration's 28 MB sit in L2, and the gathers' latency and
//   the syncs set the pace, not HBM: there K2 runs more blocks per SM
//   (kInL2MinBlocks).  On an H100 a 288-iteration solve there took 8.56–8.94
//   ms against the three-phase, one-column-at-a-time first version's
//   10.84–10.88 (ab_grid_kernels.py; its VARIANTS hold the designs that
//   lost).
//   K3 applies K three times an iteration (once in CG, twice in the
//   preconditioner) in the fused iteration of grid_common.cuh: 4 grid syncs
//   (11 unfused) and 17 vector passes (35 unfused): 3 × 21 MB of planes,
//   71 MB of vectors and the 2 MB bf16 coarse inverse, 137 MB and 0.041 ms
//   an iteration (tpufem's 26 planes: 400 MB, 0.119 ms fused; 480 MB and
//   0.142 ms unfused).  With bf16 preconditioner planes 116 MB and 0.035
//   ms; an iteration took the same 0.125–0.128 ms either way on an H100:
//   bytes do not bind K3 (its probes put the planes' bytes at 21–23 % of an
//   iteration there).
//   K4 applies A twice an iteration, both columns at once (apply_cols: each
//   plane entry and remainder value loaded once for both, one lane search),
//   in three fused phases with one grid sync each (below): 17·C + 5 vector
//   passes (39 for two columns; the mask and D⁻¹ counted in each phase that
//   reads them).  Its template is the
//   card's split of the mesh pattern (GridRefill): at 1,048,576 nodes 9
//   planes (the diagonal, the four neighbours and the four (±1, ±1)
//   offsets, which carry C(u) across the raster's diagonals) and 1,848
//   remainder entries, so 2·9 + 39 = 57 planes of 4.19 MB, 239 MB and
//   0.071 ms an iteration at 3.35 TB/s (tpufem's 13 planes: 273 MB, 0.081
//   ms); an iteration took 0.129 ms there on an H100 (55 %), latency-bound
//   like K3 (4 blocks per SM, not 2: 0.129 against 0.183 ms).  The start
//   writes r̂ alone and the first iteration skips the zero p and v: a
//   warm-started NS solve takes one iteration, so the start is a large
//   share of it.
// Below ~10⁵ nodes the planes sit in L2 and the grid syncs dominate, a few µs
// each.  At f64 an entry on the remainder is applied with tpufem's float32
// rounding (below), so the card's split rounds the couplings tpufem's split
// kept on planes.

// Both kernels round to float where tpufem's do (preferred_element_type=
// float32), at every field precision: each remainder source value and each
// target's remainder sum (pallas_cg.py:388-392), and in K3 the row-block
// sums, the lane-block sums (float operands, float accumulation) and the
// coarse product (:1362); a bf16 coarse inverse takes a bf16-rounded
// restricted vector and accumulates in float.

// The operator apply, the reductions, K3's solve and the cooperative launch
// live in grid_common.cuh, which K5 (grid_step.cu) shares.
#include "grid_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

// Blocks per SM that the whole-solve kernels' register budgets are set for
// (__launch_bounds__): 64 registers a thread in f32, 128 in f64.  They are
// latency-bound, so warps in flight buy more than registers: at 1,048,576
// nodes on an H100 a K3 f32 iteration took 0.180 ms at 2 blocks per SM (118
// registers, no spills), 0.148 at 3 (80) and 0.131 at 4 (64, a few spill
// stores).
template <typename T>
constexpr int kFusedMinBlocks = sizeof(T) == 4 ? 4 : 2;

// K2's f32 budget where an iteration's operator and vectors fit in L2: 5
// blocks per SM (48 registers a thread, a few spill stores).  There the
// gathers' latency sets the pace and more warps in flight hide it; where
// they stream from HBM the spills cost more than the warps buy.  On an H100
// (ab_grid_kernels.py, f32, both columns): at the Taylor–Hood velocity
// raster of n_side 192 (28 MB an iteration) a 288-iteration solve took
// 8.56–8.94 ms at 5 blocks per SM, 9.00–9.10 at 6 (40 registers) and
// 9.48–9.49 at 4; at 1,048,576 nodes (117 MB) an iteration took 0.060–0.081
// ms at 5 and 0.056–0.064 at 4.
template <typename T>
constexpr int kInL2MinBlocks = sizeof(T) == 4 ? 5 : kFusedMinBlocks<T>;

// K2's and K4's phases walk the points in a grid-stride loop.  One
// contiguous run of the raster a block instead (so that the rows above and
// below a point are read by the same block) was slower: for K4 0.138–0.141
// against 0.128–0.129 ms an iteration on an H100 at 1,048,576 nodes (f32, 4
// blocks per SM), for K2 0.073 against 0.059 there (ab_grid_kernels.py,
// variant "one run a block").
template <typename B>
__device__ __forceinline__ void for_points(int n, B body) {
  const int stride = (int)gridDim.x * kThreads;
  for (int i = (int)blockIdx.x * kThreads + (int)threadIdx.x; i < n; i += stride) body(i);
}

template <typename T>
struct ViscousArgs {
  GridOp<T> op;
  const T* __restrict__ mask;
  const T* __restrict__ invd;
  const T* __restrict__ b;   // (C, N)
  const T* __restrict__ x0;  // (C, N)
  T* x;                      // (C, N) the solution
  T* r;                      // updated in place
  T* p[2];  // double-buffered: phase A reads one at its sources, writes the other
  T* q;
  T* partials;
  T dt_nu;
  T tol;
  int iters;
  int* iters_out;
};

// tpufem's _cg_core_cols, two phases and two grid syncs an iteration (p is
// computed where it is read, as K4 does):
//   A  p = D⁻¹r + β p_old at each source (D⁻¹r in the first iteration),
//      q = A p for both columns in one apply; p and q written; sums p·q
//                                                                  [reduce]
//   B  x += αp, r −= αq (in place); sums r·D⁻¹r and r·r             [reduce]
// Per point every value is the plain version's expression.  The start
// computes r = b − A x0 alone; the first iteration reads x0 as x.
template <typename T, int C, int MinBlocks>
__global__ void __launch_bounds__(kThreads, MinBlocks)
    viscous_cg_kernel(const __grid_constant__ ViscousArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  const int ns = a.op.ns, n = ns * ns;
  const T* __restrict__ mask = a.mask;
  const T* __restrict__ invd = a.invd;
  const T dt_nu = a.dt_nu;
  int slot = 0;

  // out = m_i·(X_i + dtν·K(m·X)_i) + (1 − m_i)·X_i for each column at point
  // i: xval(j, v) writes the C values of X at flat index j, xi holds those at i
  auto mv = [&](int i, auto xval, const T (&xi)[C], T (&out)[C]) {
    const int iy = i / ns, ix = i - iy * ns;
    T kx[C];
    apply_cols<C>(a.op, iy, ix, [&](int j, T (&v)[C]) {
      xval(j, v);
      const T mj = mask[j];
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = mj * v[c];
    }, kx);
    const T mi = mask[i];
#pragma unroll
    for (int c = 0; c < C; ++c) out[c] = mi * (xi[c] + dt_nu * kx[c]) + (T(1) - mi) * xi[c];
  };

  // r = b − A x0; sums b·b, r·D⁻¹r, r·r per column
  auto x0_at = [&](int j, T (&v)[C]) {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = a.x0[c * n + j];
  };
  T s0[3 * C] = {};
  for_points(n, [&](int i) {
    T xi[C], ax[C];
    x0_at(i, xi);
    mv(i, x0_at, xi, ax);
    const T di = invd[i];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int e = c * n + i;
      const T bv = a.b[e];
      const T rv = bv - ax[c];
      a.r[e] = rv;
      s0[c] += bv * bv;
      s0[C + c] += rv * (di * rv);
      s0[2 * C + c] += rv * rv;
    }
  });
  reduce_grid(grid, s0, a.partials, slot);
  T atol2[C], rz[C], rr[C], beta[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const T t = a.tol * tmax(tsqrt(s0[c]), T(1e-30));
    atol2[c] = t * t;
    rz[c] = s0[C + c];
    rr[c] = s0[2 * C + c];
    beta[c] = T(0);
  }

  int k = 0;
  for (;; ++k) {
    bool live = k < a.iters;
    if (live && a.tol > T(0)) {
      bool any = false;
#pragma unroll
      for (int c = 0; c < C; ++c) any = any || (rr[c] > atol2[c]);
      live = any;
    }
    if (!live) break;
    const bool first = k == 0;
    const T* pold = pick(a.p, (k & 1) ^ 1);
    T* pnew = pick(a.p, k & 1);

    // A: p = D⁻¹r + β p_old, q = A p; sums p·q
    auto p_at = [&](int j, T (&pv)[C]) {
      const T dj = invd[j];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = c * n + j;
        const T z = dj * a.r[e];
        pv[c] = first ? z : z + beta[c] * pold[e];
      }
    };
    T s1[C] = {};
    for_points(n, [&](int i) {
      T pv[C], qv[C];
      p_at(i, pv);
      mv(i, p_at, pv, qv);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = c * n + i;
        pnew[e] = pv[c];
        a.q[e] = qv[c];
        s1[c] += pv[c] * qv[c];
      }
    });
    reduce_grid(grid, s1, a.partials, slot);
    T alpha[C];
#pragma unroll
    for (int c = 0; c < C; ++c) alpha[c] = s1[c] != T(0) ? rz[c] / s1[c] : T(0);

    // B: x += αp, r −= αq; sums r·D⁻¹r, r·r
    const T* xold = first ? a.x0 : a.x;
    T s2[2 * C] = {};
    for_points(n, [&](int i) {
      const T di = invd[i];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = c * n + i;
        a.x[e] = xold[e] + alpha[c] * pnew[e];
        const T rv = a.r[e] - alpha[c] * a.q[e];
        a.r[e] = rv;
        s2[c] += rv * (di * rv);
        s2[C + c] += rv * rv;
      }
    });
    reduce_grid(grid, s2, a.partials, slot);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      beta[c] = rz[c] != T(0) ? s2[c] / rz[c] : T(0);
      rz[c] = s2[c];
      rr[c] = s2[C + c];
    }
  }
  if (k == 0) {  // no iteration ran: x = x0
    for_points(n, [&](int i) {
#pragma unroll
      for (int c = 0; c < C; ++c) a.x[c * n + i] = a.x0[c * n + i];
    });
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && a.iters_out) *a.iters_out += k;  // adds: a run's total
}

// ---------------------------------------------------------------------------
// K3 (its solve is in grid_common.cuh, which K5 shares)
// ---------------------------------------------------------------------------

template <typename T, typename A>
__global__ void __launch_bounds__(kThreads, kFusedMinBlocks<T>)
    pressure_cg_kernel(const __grid_constant__ PressureArgs<T, A> a) {
  cg::grid_group grid = cg::this_grid();
  int slot = 0;
  pressure_solve(a, grid, slot);
}

// K3's arguments when the preconditioner's two applies read K̃: bf16 planes
// on K's offsets and K̃'s own remainder (tpufem's cg_precond_bf16="on").
template <typename T, typename A>
using PbArgs = PressureArgs<T, A, GridOp<T>, GridOp<T, __nv_bfloat16>>;

template <typename T, typename A>
__global__ void __launch_bounds__(kThreads, kFusedMinBlocks<T>)
    pressure_pb16_kernel(const __grid_constant__ PbArgs<T, A> a) {
  cg::grid_group grid = cg::this_grid();
  int slot = 0;
  pressure_solve(a, grid, slot);
}

// K3's measurement variants (roofline.probes), replacing tpufem's
// PressureGridCG(probe="nofma"|"nodma") (pallas_cg.py:91, 210-220, 1144),
// whose streamed apply skips its FMAs ("nofma": the DMA pipeline alone) or
// its plane DMAs ("nodma": the roll and FMA loop on stale scratch).  Here
// they are deterministic (grid_common.cuh, ProbeOp): nofma loads every
// plane entry and drops it, so each apply is its remainder alone; nodma
// reads no plane byte and multiplies each gathered source by its plane's
// constant; exchange (tpufem has none) visits no point in phases A, B and
// D, so an iteration is its syncs, totals and coarse product.  Their
// results are wrong by design; nothing but the roofline reads them.  Each
// launches on the real instance's blocks.  Instances: f32 fields with the
// f32 and bf16 coarse inverses (the bench configuration's) and f64 fields
// with an f64 one, where their plain versions hold them tightly.
template <typename T, typename A, int Probe>
using ProbeArgs = PressureArgs<T, A, ProbeOp<T, Probe>>;

template <typename T, typename A>
__global__ void __launch_bounds__(kThreads, kFusedMinBlocks<T>)
    pressure_nofma_kernel(const __grid_constant__ ProbeArgs<T, A, kNoFma> a) {
  cg::grid_group grid = cg::this_grid();
  int slot = 0;
  pressure_solve(a, grid, slot);
}

template <typename T, typename A>
__global__ void __launch_bounds__(kThreads, kFusedMinBlocks<T>)
    pressure_nodma_kernel(const __grid_constant__ ProbeArgs<T, A, kNoDma> a) {
  cg::grid_group grid = cg::this_grid();
  int slot = 0;
  pressure_solve(a, grid, slot);
}

template <typename T, typename A>
__global__ void __launch_bounds__(kThreads, kFusedMinBlocks<T>)
    pressure_exchange_kernel(const __grid_constant__ ProbeArgs<T, A, kExchange> a) {
  cg::grid_group grid = cg::this_grid();
  int slot = 0;
  pressure_solve(a, grid, slot);
}

// Blocks per SM of K3's real instance, which its probes launch on.
template <typename T, typename A>
int real_per_sm() {
  int per_sm = 0;
  blocks_per_sm(pressure_cg_kernel<T, A>, &per_sm);
  return per_sm;
}

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T finite_or_zero(T v) { return isfinite(v) ? v : T(0); }

template <typename T>
struct NSArgs {
  GridOp<T> op;  // A = Δt·C(u) + νΔt·K, refilled every step
  const T* __restrict__ mask;
  const T* __restrict__ invd;
  const T* __restrict__ b;   // (C, N)
  const T* __restrict__ x0;  // (C, N)
  T* x;                      // (C, N) the solution
  T* rhat;                   // r̂ = r0 = b − A x0, the first iteration's r
  T* r;                      // r from the first X phase on, updated in place
  T* p[2];  // double-buffered: phase P reads one at its sources, writes the other
  T* v[2];
  T* t;
  T* partials;
  T tol;
  int iters;
  int* iters_out;
};

// tpufem's _bicgstab_core_cols, three phases and three grid syncs an
// iteration (the sources of each apply computed where they are read):
//   P  p = r + β(p_old − ω v_old) and p̂ = D⁻¹p at each source, v = A p̂;
//      p and v written (double-buffered); sums r̂·v                [reduce]
//   S  s = r − αv and ŝ = D⁻¹s at each source, t = A ŝ; t written;
//      sums t·t, t·s                                               [reduce]
//   X  x = (x + α p̂) + ω ŝ, r = s − ω t (in place); sums r·r (the stop
//      test) and r̂·r (the next ρ)                                 [reduce]
// Per point every value is the plain version's expression.  The start
// writes r̂ alone: the first iteration reads it as r, skips p_old and v_old
// (zero: β·(0 − ω·0) = 0) and reads x0 as x.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, kFusedMinBlocks<T>)
    ns_bicgstab_kernel(const __grid_constant__ NSArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  const int ns = a.op.ns, n = ns * ns;
  const T* __restrict__ mask = a.mask;
  const T* __restrict__ invd = a.invd;
  int slot = 0;

  // out = m_i·(X_i + A(m·X)_i) + (1 − m_i)·X_i for each column at point i:
  // xval(j, v) writes the C values of X at flat index j, xi holds those at i
  auto mv = [&](int i, auto xval, const T (&xi)[C], T (&out)[C]) {
    const int iy = i / ns, ix = i - iy * ns;
    T ax[C];
    apply_cols<C>(a.op, iy, ix, [&](int j, T (&v)[C]) {
      xval(j, v);
      const T mj = mask[j];
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = mj * v[c];
    }, ax);
    const T mi = mask[i];
#pragma unroll
    for (int c = 0; c < C; ++c) out[c] = mi * (xi[c] + ax[c]) + (T(1) - mi) * xi[c];
  };
  // X at each source, scaled by D⁻¹
  auto scaled = [&](auto xval) {
    return [=](int j, T (&v)[C]) {
      xval(j, v);
      const T dj = invd[j];
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = dj * v[c];
    };
  };

  // r̂ = r0 = b − A x0; sums b·b and r0·r0 (= r̂·r0) per column
  auto x0_at = [&](int j, T (&v)[C]) {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = a.x0[c * n + j];
  };
  T s0[2 * C] = {};
  for_points(n, [&](int i) {
    T xi[C], ax[C];
    x0_at(i, xi);
    mv(i, x0_at, xi, ax);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int e = c * n + i;
      const T bv = a.b[e];
      const T rv = bv - ax[c];
      a.rhat[e] = rv;
      s0[c] += bv * bv;
      s0[C + c] += rv * rv;
    }
  });
  reduce_grid(grid, s0, a.partials, slot);
  T atol2[C], rr[C], rho_new[C], rho[C], alpha[C], omega[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const T tl = a.tol * tmax(tsqrt(s0[c]), T(1e-30));
    atol2[c] = tl * tl;
    rr[c] = s0[C + c];
    rho_new[c] = s0[C + c];
    rho[c] = alpha[c] = omega[c] = T(1);
  }

  int k = 0;
  for (;; ++k) {
    bool live = k < a.iters;
    if (live && a.tol > T(0)) {
      bool any = false;
#pragma unroll
      for (int c = 0; c < C; ++c) any = any || (rr[c] > atol2[c]);
      live = any;
    }
    if (!live) break;
    const bool first = k == 0;
    const T* r = first ? a.rhat : a.r;
    const T* pold = pick(a.p, (k & 1) ^ 1);
    const T* vold = pick(a.v, (k & 1) ^ 1);
    T* pnew = pick(a.p, k & 1);
    T* vnew = pick(a.v, k & 1);

    // P: v = A p̂; sums r̂·v
    T beta[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      beta[c] = finite_or_zero((rho[c] != T(0) && omega[c] != T(0))
                                   ? (rho_new[c] / rho[c]) * (alpha[c] / omega[c])
                                   : T(0));
    auto p_at = [&](int j, T (&pv)[C]) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = c * n + j;
        pv[c] = first ? r[e] : r[e] + beta[c] * (pold[e] - omega[c] * vold[e]);
      }
    };
    T s1[C] = {};
    for_points(n, [&](int i) {
      T pv[C], ph[C], vv[C];
      p_at(i, pv);
      const T di = invd[i];
#pragma unroll
      for (int c = 0; c < C; ++c) ph[c] = di * pv[c];
      mv(i, scaled(p_at), ph, vv);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = c * n + i;
        pnew[e] = pv[c];
        vnew[e] = vv[c];
        s1[c] += a.rhat[e] * vv[c];
      }
    });
    reduce_grid(grid, s1, a.partials, slot);
#pragma unroll
    for (int c = 0; c < C; ++c) alpha[c] = finite_or_zero(s1[c] != T(0) ? rho_new[c] / s1[c] : T(0));

    // S: t = A ŝ; sums t·t, t·s
    auto s_at = [&](int j, T (&sv)[C]) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = c * n + j;
        sv[c] = r[e] - alpha[c] * vnew[e];
      }
    };
    T s2[2 * C] = {};
    for_points(n, [&](int i) {
      T sv[C], sh[C], tv[C];
      s_at(i, sv);
      const T di = invd[i];
#pragma unroll
      for (int c = 0; c < C; ++c) sh[c] = di * sv[c];
      mv(i, scaled(s_at), sh, tv);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        a.t[c * n + i] = tv[c];
        s2[c] += tv[c] * tv[c];
        s2[C + c] += tv[c] * sv[c];
      }
    });
    reduce_grid(grid, s2, a.partials, slot);
#pragma unroll
    for (int c = 0; c < C; ++c)
      omega[c] = finite_or_zero(s2[c] != T(0) ? s2[C + c] / s2[c] : T(0));

    // X: x = (x + α p̂) + ω ŝ, r = s − ω t; sums r·r and r̂·r
    const T* xold = first ? a.x0 : a.x;
    T s3[2 * C] = {};
    for_points(n, [&](int i) {
      const T di = invd[i];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = c * n + i;
        const T ph = di * pnew[e];
        const T sv = r[e] - alpha[c] * vnew[e];
        const T sh = di * sv;
        a.x[e] = xold[e] + alpha[c] * ph + omega[c] * sh;
        const T rv = sv - omega[c] * a.t[e];
        a.r[e] = rv;
        s3[c] += rv * rv;
        s3[C + c] += a.rhat[e] * rv;
      }
    });
    reduce_grid(grid, s3, a.partials, slot);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      rho[c] = rho_new[c];
      rr[c] = s3[c];
      rho_new[c] = s3[C + c];
    }
  }
  if (k == 0) {  // no iteration ran: x = x0
    for_points(n, [&](int i) {
#pragma unroll
      for (int c = 0; c < C; ++c) a.x[c * n + i] = a.x0[c * n + i];
    });
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && a.iters_out) *a.iters_out += k;  // adds: a run's total
}


template <typename T>
int viscous_cg(const T* diags, const int* rs, const int* ls, int n_off, int ns, const int* rowptr,
               const int* lane, const int* src, const T* val, int round_rest, const T* mask,
               const T* invd, const T* b, const T* x0, T* x, T* work, int C, double dt_nu,
               int iters, double tol, int* iters_out, void* stream) {
  ViscousArgs<T> a;
  cudaError_t err = make_op(a.op, diags, rs, ls, n_off, ns, rowptr, lane, src, val, round_rest);
  if (err != cudaSuccess) return (int)err;
  const size_t cn = (size_t)C * ns * ns;
  a.mask = mask;
  a.invd = invd;
  a.b = b;
  a.x0 = x0;
  a.x = x;
  a.r = work;
  a.p[0] = work + cn;
  a.p[1] = work + 2 * cn;
  a.q = work + 3 * cn;
  a.partials = work + 4 * cn;
  a.dt_nu = (T)dt_nu;
  a.tol = (T)tol;
  a.iters = iters;
  a.iters_out = iters_out;
  // the register budget: does an iteration's working set (the planes and
  // 10·C + 3 vector passes; the remainder is a few per cent) fit in L2?
  const int n = ns * ns;
  int dev = 0, l2 = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev)) != cudaSuccess)
    return (int)err;
  const bool in_l2 = (double)(n_off + 10 * C + 3) * n * sizeof(T) <= (double)l2;
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 1)
    return (int)(in_l2 ? launch_coop(viscous_cg_kernel<T, 1, kInL2MinBlocks<T>>, a, n, s)
                       : launch_coop(viscous_cg_kernel<T, 1, kFusedMinBlocks<T>>, a, n, s));
  if (C == 2)
    return (int)(in_l2 ? launch_coop(viscous_cg_kernel<T, 2, kInL2MinBlocks<T>>, a, n, s)
                       : launch_coop(viscous_cg_kernel<T, 2, kFusedMinBlocks<T>>, a, n, s));
  return (int)cudaErrorInvalidValue;
}

// Fill K3's arguments other than its operators (a.op, and a.pop where the
// preconditioner has its own) and launch `kernel`, an instance of K3's
// solve (pressure_cg_kernel or one of its variants), on at most
// `max_per_sm` blocks a SM where it is given.
template <typename T, typename A, typename... O>
int pressure_cg(void (*kernel)(PressureArgs<T, A, O...>), PressureArgs<T, A, O...>& a,
                const T* act, const T* invd, const A* ac_inv,
                int blk, int nc, int use_coarse, const T* b, const T* x0, T* x, T* work,
                float* fwork, double omega, int iters, double tol, int* iters_out,
                void* stream, int max_per_sm = 0) {
  const int ns = a.op.ns;
  if (!coarse_ok(blk, nc, ns)) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)ns * ns;
  a.act = act;
  a.invd = invd;
  a.ac_inv = ac_inv;
  a.b = b;
  a.x0 = x0;
  a.x = x;
  a.r[0] = work;
  a.r[1] = work + n;
  a.p[0] = work + 2 * n;
  a.p[1] = work + 3 * n;
  a.q = work + 4 * n;
  a.z = work + 5 * n;
  a.partials = work + 6 * n;
  a.rc = fwork;
  a.zc = fwork + (size_t)nc * nc;
  a.omega = (T)omega;
  a.tol = (T)tol;
  a.blk = blk;
  a.nc = nc;
  a.use_coarse = use_coarse;
  a.iters = iters;
  a.iters_out = iters_out;
  return (int)launch_coop(kernel, a, (int)n, (cudaStream_t)stream, max_per_sm);
}

template <typename T>
int ns_bicgstab(const T* diags, const int* rs, const int* ls, int n_off, int ns, const int* rowptr,
                const int* lane, const int* src, const T* val, int round_rest, const T* mask,
                const T* invd, const T* b, const T* x0, T* x, T* work, int C, int iters,
                double tol, int* iters_out, void* stream) {
  NSArgs<T> a;
  cudaError_t err = make_op(a.op, diags, rs, ls, n_off, ns, rowptr, lane, src, val, round_rest);
  if (err != cudaSuccess) return (int)err;
  const size_t cn = (size_t)C * ns * ns;
  a.mask = mask;
  a.invd = invd;
  a.b = b;
  a.x0 = x0;
  a.x = x;
  a.rhat = work;
  a.r = work + cn;
  a.p[0] = work + 2 * cn;
  a.p[1] = work + 3 * cn;
  a.v[0] = work + 4 * cn;
  a.v[1] = work + 5 * cn;
  a.t = work + 6 * cn;
  a.partials = work + 7 * cn;
  a.tol = (T)tol;
  a.iters = iters;
  a.iters_out = iters_out;
  const int n = ns * ns;
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 1) return (int)launch_coop(ns_bicgstab_kernel<T, 1>, a, n, s);
  if (C == 2) return (int)launch_coop(ns_bicgstab_kernel<T, 2>, a, n, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The operator as the C interface takes it: planes, shift tables, the
// remainder and whether its sources and sums round to float.
#define OP_PARAMS(T)                                                                    \
  const T *diags, const int *rs, const int *ls, int n_off, int ns, const int *rowptr, \
      const int *lane, const int *src, const T *val, int round_rest
#define OP_ARGS diags, rs, ls, n_off, ns, rowptr, lane, src, val, round_rest

#define VISCOUS_ENTRY(NAME, T)                                                                  \
  extern "C" int NAME(OP_PARAMS(T), const T* mask, const T* invd, const T* b, const T* x0,      \
                      T* x, T* work, int C, double dt_nu, int iters, double tol,                \
                      int* iters_out, void* stream) {                                           \
    return viscous_cg<T>(OP_ARGS, mask, invd, b, x0, x, work, C, dt_nu, iters, tol, iters_out, \
                         stream);                                                               \
  }

// K3's arguments after its operators
#define PRESSURE_PARAMS(T, A)                                                                \
  const T *act, const T *invd, const A *ac_inv, int blk, int nc, int use_coarse, const T *b, \
      const T *x0, T *x, T *work, float *fwork, double omega, int iters, double tol,        \
      int *iters_out, void *stream
#define PRESSURE_ARGS                                                                         \
  act, invd, ac_inv, blk, nc, use_coarse, b, x0, x, work, fwork, omega, iters, tol, iters_out, \
      stream

#define PRESSURE_ENTRY(NAME, T, A)                                            \
  extern "C" int NAME(OP_PARAMS(T), PRESSURE_PARAMS(T, A)) {                  \
    PressureArgs<T, A> a;                                                     \
    cudaError_t err = make_op(a.op, OP_ARGS);                                 \
    if (err != cudaSuccess) return (int)err;                                  \
    return pressure_cg(pressure_cg_kernel<T, A>, a, PRESSURE_ARGS);           \
  }

// K3 with precond_bf16: the preconditioner's two applies read K̃, bf16
// planes on the CG operator's offsets (pdiags) and its own remainder in the
// field's precision; the CG's apply and the initial residual read K.
#define PRESSURE_PB16_ENTRY(NAME, T, A)                                                      \
  extern "C" int NAME(OP_PARAMS(T), const __nv_bfloat16* pdiags, const int* prowptr,         \
                      const int* plane, const int* psrc, const T* pval,                      \
                      PRESSURE_PARAMS(T, A)) {                                               \
    PbArgs<T, A> a;                                                                          \
    cudaError_t err = make_op(a.op, OP_ARGS);                                                \
    if (err != cudaSuccess) return (int)err;                                                 \
    err = make_op(a.pop, pdiags, rs, ls, n_off, ns, prowptr, plane, psrc, pval, round_rest); \
    if (err != cudaSuccess) return (int)err;                                                 \
    return pressure_cg(pressure_pb16_kernel<T, A>, a, PRESSURE_ARGS);                        \
  }

#define NOFMA_ENTRY(NAME, T, A)                                           \
  extern "C" int NAME(OP_PARAMS(T), PRESSURE_PARAMS(T, A)) {              \
    ProbeArgs<T, A, kNoFma> a;                                            \
    cudaError_t err = make_op(a.op, OP_ARGS);                             \
    if (err != cudaSuccess) return (int)err;                              \
    a.op.probe.keep = 0u;                                                 \
    return pressure_cg(pressure_nofma_kernel<T, A>, a, PRESSURE_ARGS,     \
                       real_per_sm<T, A>());                              \
  }

// K3's nodma probe: plane_const holds n_off values on the host, one a plane
#define NODMA_ENTRY(NAME, T, A)                                                           \
  extern "C" int NAME(OP_PARAMS(T), const double* plane_const, PRESSURE_PARAMS(T, A)) {   \
    ProbeArgs<T, A, kNoDma> a;                                                            \
    cudaError_t err = make_op(a.op, OP_ARGS);                                             \
    if (err != cudaSuccess) return (int)err;                                              \
    for (int g = 0; g < n_off; ++g) a.op.probe.plane_const[g] = (T)plane_const[g];        \
    return pressure_cg(pressure_nodma_kernel<T, A>, a, PRESSURE_ARGS,                     \
                       real_per_sm<T, A>());                                              \
  }

#define EXCHANGE_ENTRY(NAME, T, A)                                             \
  extern "C" int NAME(OP_PARAMS(T), PRESSURE_PARAMS(T, A)) {                   \
    ProbeArgs<T, A, kExchange> a;                                              \
    cudaError_t err = make_op(a.op, OP_ARGS);                                  \
    if (err != cudaSuccess) return (int)err;                                   \
    return pressure_cg(pressure_exchange_kernel<T, A>, a, PRESSURE_ARGS,       \
                       real_per_sm<T, A>());                                   \
  }

#define NS_ENTRY(NAME, T)                                                                       \
  extern "C" int NAME(OP_PARAMS(T), const T* mask, const T* invd, const T* b, const T* x0,      \
                      T* x, T* work, int C, int iters, double tol, int* iters_out,              \
                      void* stream) {                                                           \
    return ns_bicgstab<T>(OP_ARGS, mask, invd, b, x0, x, work, C, iters, tol, iters_out,        \
                          stream);                                                              \
  }

VISCOUS_ENTRY(viscous_cg_f32, float)
VISCOUS_ENTRY(viscous_cg_f64, double)
PRESSURE_ENTRY(pressure_cg_f32, float, float)
PRESSURE_ENTRY(pressure_cg_f32_bf16, float, __nv_bfloat16)
PRESSURE_ENTRY(pressure_cg_f64, double, double)
PRESSURE_ENTRY(pressure_cg_f64_bf16, double, __nv_bfloat16)
PRESSURE_PB16_ENTRY(pressure_cg_f32_pb16, float, float)
PRESSURE_PB16_ENTRY(pressure_cg_f32_bf16_pb16, float, __nv_bfloat16)
PRESSURE_PB16_ENTRY(pressure_cg_f64_pb16, double, double)
PRESSURE_PB16_ENTRY(pressure_cg_f64_bf16_pb16, double, __nv_bfloat16)
NOFMA_ENTRY(pressure_nofma_f32, float, float)
NOFMA_ENTRY(pressure_nofma_f32_bf16, float, __nv_bfloat16)
NOFMA_ENTRY(pressure_nofma_f64, double, double)
NODMA_ENTRY(pressure_nodma_f32, float, float)
NODMA_ENTRY(pressure_nodma_f32_bf16, float, __nv_bfloat16)
NODMA_ENTRY(pressure_nodma_f64, double, double)
EXCHANGE_ENTRY(pressure_exchange_f32, float, float)
EXCHANGE_ENTRY(pressure_exchange_f32_bf16, float, __nv_bfloat16)
EXCHANGE_ENTRY(pressure_exchange_f64, double, double)
NS_ENTRY(ns_bicgstab_f32, float)
NS_ENTRY(ns_bicgstab_f64, double)

// Blocks per SM of each instance, in the order viscous f32 C=1 (HBM, L2),
// C=2 (HBM, L2), f64 C=1, C=2; pressure f32, f32 with a bf16 coarse inverse,
// f64, f64 bf16; BiCGStab f32 C=1, C=2, f64 C=1, C=2; pressure with bf16
// preconditioner planes f32, f32 bf16, f64, f64 bf16; the nofma probe f32,
// f32 bf16, f64; the nodma probe f32, f32 bf16, f64; the exchange probe f32,
// f32 bf16, f64 (each probe launches on the real instance's, at most):
// writes `cap` of them, returns the count.
extern "C" int grid_cg_blocks_per_sm(int* out, int cap) {
  int v[27] = {0};
  blocks_per_sm(viscous_cg_kernel<float, 1, kFusedMinBlocks<float>>, &v[0]);
  blocks_per_sm(viscous_cg_kernel<float, 1, kInL2MinBlocks<float>>, &v[1]);
  blocks_per_sm(viscous_cg_kernel<float, 2, kFusedMinBlocks<float>>, &v[2]);
  blocks_per_sm(viscous_cg_kernel<float, 2, kInL2MinBlocks<float>>, &v[3]);
  blocks_per_sm(viscous_cg_kernel<double, 1, kFusedMinBlocks<double>>, &v[4]);
  blocks_per_sm(viscous_cg_kernel<double, 2, kFusedMinBlocks<double>>, &v[5]);
  blocks_per_sm(pressure_cg_kernel<float, float>, &v[6]);
  blocks_per_sm(pressure_cg_kernel<float, __nv_bfloat16>, &v[7]);
  blocks_per_sm(pressure_cg_kernel<double, double>, &v[8]);
  blocks_per_sm(pressure_cg_kernel<double, __nv_bfloat16>, &v[9]);
  blocks_per_sm(ns_bicgstab_kernel<float, 1>, &v[10]);
  blocks_per_sm(ns_bicgstab_kernel<float, 2>, &v[11]);
  blocks_per_sm(ns_bicgstab_kernel<double, 1>, &v[12]);
  blocks_per_sm(ns_bicgstab_kernel<double, 2>, &v[13]);
  blocks_per_sm(pressure_pb16_kernel<float, float>, &v[14]);
  blocks_per_sm(pressure_pb16_kernel<float, __nv_bfloat16>, &v[15]);
  blocks_per_sm(pressure_pb16_kernel<double, double>, &v[16]);
  blocks_per_sm(pressure_pb16_kernel<double, __nv_bfloat16>, &v[17]);
  blocks_per_sm(pressure_nofma_kernel<float, float>, &v[18]);
  blocks_per_sm(pressure_nofma_kernel<float, __nv_bfloat16>, &v[19]);
  blocks_per_sm(pressure_nofma_kernel<double, double>, &v[20]);
  blocks_per_sm(pressure_nodma_kernel<float, float>, &v[21]);
  blocks_per_sm(pressure_nodma_kernel<float, __nv_bfloat16>, &v[22]);
  blocks_per_sm(pressure_nodma_kernel<double, double>, &v[23]);
  blocks_per_sm(pressure_exchange_kernel<float, float>, &v[24]);
  blocks_per_sm(pressure_exchange_kernel<float, __nv_bfloat16>, &v[25]);
  blocks_per_sm(pressure_exchange_kernel<double, double>, &v[26]);
  for (int i = 0; i < 27 && i < cap; ++i) out[i] = v[i];
  return 27;
}
