// Kernels K2 and K3: whole-solve preconditioned CG on the grid-offset
// operator of ring-in-grid meshes (N = ns² nodes), one launch per solve.
//
// Replaces the TPU kernels
//   K2  ViscousGridCG._solve_fn   (tpufem/solve/pallas_cg.py:825; kernel :862,
//       helpers _roll2 :44, _make_apply :89, _make_apply_cols :405,
//       _cg_core_cols :644): warm-started Jacobi-PCG on
//       (m(I + dtν K)m + (1−m)I) x = b, both velocity columns in lockstep;
//   K3  PressureGridCG._solve_fn  (pallas_cg.py:1275; kernel :1310,
//       _cg_core :597): PCG on the merged periodic pressure operator with
//       constant-nullspace deflation and the two-level preconditioner.
// Both exit early on the device when tol > 0.
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
// What bounds it on an H100 (3.35 TB/s HBM, 50 MB L2): the operator planes,
// n_off·N·4 B in f32 per K-apply, plus the CG vectors' passes.  K2 applies K
// once per iteration (both columns share one read of the planes), K3 three
// times (one in CG, two in the preconditioner).  At N = 1,048,576 the split
// has 20 viscous and 26 pressure planes (84 and 109 MB, beyond L2), so an
// iteration moves ~190 MB in K2 and ~480 MB in K3: 56 and 142 µs at the HBM
// peak.  Below ~10⁵ nodes the planes sit in L2 and the grid syncs dominate:
// K2 has 3 and K3 11 per iteration, a few µs each.  This first version is simple and correct: it reads each
// plane once per apply with coalesced loads and keeps the CG vectors in
// device memory; no TMA, no L2 residency control, no fused phases.
//
// Both kernels round to float where tpufem's do (preferred_element_type=
// float32), at every field precision: each remainder source value and each
// target's remainder sum (pallas_cg.py:388-392), and in K3 the row-block
// sums, the lane-block sums (float operands, float accumulation) and the
// coarse product (:1362); a bf16 coarse inverse takes a bf16-rounded
// restricted vector and accumulates in float.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOffsets = 64;
constexpr int kMaxBlocks = 4096;  // partial-sum slots per reduction (the wrapper allocates them)
constexpr int kSlots = 8;         // values reduced per phase, at most

struct Shifts {
  int rs[kMaxOffsets];  // source row offset, (dy mod ns)
  int ls[kMaxOffsets];  // source lane offset, (s mod ns)
};

template <typename T>
struct GridOp {
  const T* __restrict__ diags;  // (n_off, ns, ns)
  const int* __restrict__ rowptr;  // (ns+1) remainder entries per target row
  const int* __restrict__ lane;    // (m) target lane
  const int* __restrict__ src;     // (m) flat source index
  const T* __restrict__ val;       // (m)
  int n_off;
  int ns;
  Shifts sh;
};

__device__ __forceinline__ float tsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double tsqrt(double v) { return sqrt(v); }
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
// tpufem's kernels round the remainder products to float at every precision
__device__ __forceinline__ float round_f(float v) { return v; }
__device__ __forceinline__ double round_f(double v) { return (double)(float)v; }

// K·X at one point; src(j) gives the source value at flat index j.
template <typename T, typename F>
__device__ __forceinline__ T apply_at(const GridOp<T>& op, int iy, int ix, F src) {
  const int ns = op.ns;
  const long long n = (long long)ns * ns;
  const int i = iy * ns + ix;
  T y = T(0);
  for (int g = 0; g < op.n_off; ++g) {
    int sy = iy + op.sh.rs[g];
    sy -= (sy >= ns) ? ns : 0;
    int sx = ix + op.sh.ls[g];
    sx -= (sx >= ns) ? ns : 0;
    y += op.diags[g * n + i] * src(sy * ns + sx);
  }
  const int k0 = op.rowptr[iy], k1 = op.rowptr[iy + 1];
  if (k0 < k1) {
    T rest = T(0);
    for (int k = k0; k < k1; ++k)
      if (op.lane[k] == ix) rest += op.val[k] * round_f(src(op.src[k]));
    y += round_f(rest);
  }
  return y;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // the total is in lane 0
}

// Block sums of v[0..NV) into this block's row of the partials slot.
template <typename T, int NV>
__device__ void block_partials(const T (&v)[NV], T* out) {
  __shared__ T sm[kWarps][NV];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    T s = warp_sum(v[j]);
    if (lane == 0) sm[warp][j] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      T s = warp_sum(lane < kWarps ? sm[lane][j] : T(0));
      if (lane == 0) out[j] = s;
    }
  }
  __syncthreads();
}

// Every block sums all blocks' partials in the same order: identical bits.
template <typename T, int NV>
__device__ void grid_totals(const T* partials, T (&v)[NV]) {
  __shared__ T res[NV];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      T s = T(0);
      for (int b = lane; b < (int)gridDim.x; b += 32) s += partials[b * kSlots + j];
      s = warp_sum(s);
      if (lane == 0) res[j] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = res[j];
  __syncthreads();
}

// v ← the grid-wide sums of v (a grid sync inside).
template <typename T, int NV>
__device__ __forceinline__ void reduce_grid(cg::grid_group& grid, T (&v)[NV], T* partials,
                                            int& slot) {
  T* base = partials + (size_t)slot * kMaxBlocks * kSlots;
  block_partials<T, NV>(v, base + (size_t)blockIdx.x * kSlots);
  grid.sync();
  grid_totals<T, NV>(base, v);
  slot ^= 1;
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

template <typename T>
struct ViscousArgs {
  GridOp<T> op;
  const T* __restrict__ mask;
  const T* __restrict__ invd;
  const T* __restrict__ b;   // (C, N)
  const T* __restrict__ x0;  // (C, N)
  T* x;                      // (C, N) the solution
  T* r;
  T* p;
  T* q;
  T* partials;
  T dt_nu;
  T tol;
  int iters;
  int* iters_out;
};

template <typename T, int C>
__global__ void __launch_bounds__(kThreads) viscous_cg_kernel(ViscousArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  const int ns = a.op.ns, n = ns * ns;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const T dt_nu = a.dt_nu;
  int slot = 0;

  // m·(X + dtν·K(m·X)) + (1−m)·X at point i of plane X
  auto mv = [&](const T* X, int i, int iy, int ix) -> T {
    const T* m = a.mask;
    const T kx = apply_at(a.op, iy, ix, [&](int j) { return m[j] * X[j]; });
    const T mi = m[i], xi = X[i];
    return mi * (xi + dt_nu * kx) + (T(1) - mi) * xi;
  };

  // r = b − A x0, z = D⁻¹ r, p = z; sums b·b, r·z, r·r per column
  T s0[3 * C];
#pragma unroll
  for (int j = 0; j < 3 * C; ++j) s0[j] = T(0);
  for (int i = tid; i < n; i += stride) {
    const int iy = i / ns, ix = i - iy * ns;
    const T di = a.invd[i];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const T* x0 = a.x0 + c * n;
      const T bv = a.b[c * n + i];
      a.x[c * n + i] = x0[i];
      const T rv = bv - mv(x0, i, iy, ix);
      const T zv = di * rv;
      a.r[c * n + i] = rv;
      a.p[c * n + i] = zv;
      s0[c] += bv * bv;
      s0[C + c] += rv * zv;
      s0[2 * C + c] += rv * rv;
    }
  }
  reduce_grid(grid, s0, a.partials, slot);
  T atol2[C], rz[C], rr[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const T t = a.tol * tmax(tsqrt(s0[c]), T(1e-30));
    atol2[c] = t * t;
    rz[c] = s0[C + c];
    rr[c] = s0[2 * C + c];
  }

  int k = 0;
  for (;;) {
    bool live = k < a.iters;
    if (live && a.tol > T(0)) {
      bool any = false;
#pragma unroll
      for (int c = 0; c < C; ++c) any = any || (rr[c] > atol2[c]);
      live = any;
    }
    if (!live) break;

    // q = A p; sums p·q
    T s1[C];
#pragma unroll
    for (int c = 0; c < C; ++c) s1[c] = T(0);
    for (int i = tid; i < n; i += stride) {
      const int iy = i / ns, ix = i - iy * ns;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const T qv = mv(a.p + c * n, i, iy, ix);
        a.q[c * n + i] = qv;
        s1[c] += a.p[c * n + i] * qv;
      }
    }
    reduce_grid(grid, s1, a.partials, slot);
    T alpha[C];
#pragma unroll
    for (int c = 0; c < C; ++c) alpha[c] = s1[c] != T(0) ? rz[c] / s1[c] : T(0);

    // x += αp, r −= αq, z = D⁻¹ r; sums r·z, r·r
    T s2[2 * C];
#pragma unroll
    for (int j = 0; j < 2 * C; ++j) s2[j] = T(0);
    for (int i = tid; i < n; i += stride) {
      const T di = a.invd[i];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = c * n + i;
        a.x[e] = a.x[e] + alpha[c] * a.p[e];
        const T rv = a.r[e] - alpha[c] * a.q[e];
        a.r[e] = rv;
        const T zv = di * rv;
        s2[c] += rv * zv;
        s2[C + c] += rv * rv;
      }
    }
    reduce_grid(grid, s2, a.partials, slot);
    T beta[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      beta[c] = rz[c] != T(0) ? s2[c] / rz[c] : T(0);
      rz[c] = s2[c];
      rr[c] = s2[C + c];
    }

    // p = z + βp (each thread owns the points it updated above)
    for (int i = tid; i < n; i += stride) {
      const T di = a.invd[i];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = c * n + i;
        a.p[e] = di * a.r[e] + beta[c] * a.p[e];
      }
    }
    grid.sync();
    ++k;
  }
  if (tid == 0 && a.iters_out) *a.iters_out += k;  // adds: a run's total
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

template <typename A> struct CoarseAcc { using type = float; };
template <> struct CoarseAcc<double> { using type = double; };

__device__ __forceinline__ float coarse_val(float v) { return v; }
__device__ __forceinline__ double coarse_val(double v) { return v; }
__device__ __forceinline__ float coarse_val(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename A> __device__ __forceinline__ typename CoarseAcc<A>::type coarse_rhs(float v) {
  return v;
}
template <> __device__ __forceinline__ float coarse_rhs<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, typename A>
struct PressureArgs {
  GridOp<T> op;
  const T* __restrict__ act;
  const T* __restrict__ invd;
  const A* __restrict__ ac_inv;  // (nc², nc²)
  const T* __restrict__ b;       // the prepared rhs
  const T* __restrict__ x0;
  T* x;
  T* r;
  T* p;
  T* q;
  T* z1;
  T* z;
  T* t;
  float* r1;  // (nc, ns) row-block sums
  float* rc;  // (nc²) restricted vector
  float* zc;  // (nc²) coarse correction
  T* partials;
  T omega;
  T tol;
  int blk;
  int nc;
  int use_coarse;
  int iters;
  int* iters_out;
};

// z ← project(precond(r)); returns r·z and r·r (grid syncs inside).
template <typename T, typename A>
__device__ void precond_project(const PressureArgs<T, A>& a, cg::grid_group& grid, int& slot,
                                T ww, T& rz, T& rr) {
  const int ns = a.op.ns, n = ns * ns;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const T omega = a.omega;
  T s[1] = {T(0)};
  if (!a.use_coarse) {
    for (int i = tid; i < n; i += stride) {
      const T zv = a.invd[i] * a.r[i];
      a.z[i] = zv;
      s[0] += a.act[i] * zv;
    }
  } else {
    const int blk = a.blk, nc = a.nc;
    for (int i = tid; i < n; i += stride) a.z1[i] = omega * (a.invd[i] * a.r[i]);
    grid.sync();
    // t = r − K z1
    for (int i = tid; i < n; i += stride) {
      const int iy = i / ns, ix = i - iy * ns;
      const T* z1 = a.z1;
      a.t[i] = a.r[i] - apply_at(a.op, iy, ix, [&](int j) { return z1[j]; });
    }
    grid.sync();
    // restriction, rows then lanes, each rounded to float
    for (int it = tid; it < nc * ns; it += stride) {
      const int cr = it / ns, ix = it - cr * ns;
      const int y1 = min(ns, (cr + 1) * blk);
      T acc = T(0);
      for (int y = cr * blk; y < y1; ++y) acc += a.t[y * ns + ix];
      a.r1[it] = (float)acc;
    }
    grid.sync();
    for (int it = tid; it < nc * nc; it += stride) {
      const int cr = it / nc, cl = it - cr * nc;
      const int x1 = min(ns, (cl + 1) * blk);
      float acc = 0.f;  // float operands, float accumulation, lane order
      for (int xx = cl * blk; xx < x1; ++xx) acc += a.r1[cr * ns + xx];
      a.rc[it] = acc;
    }
    grid.sync();
    // coarse product, one warp per row of ac_inv
    {
      using Acc = typename CoarseAcc<A>::type;
      const int m = nc * nc;
      const int lane = threadIdx.x & 31;
      for (int row = tid >> 5; row < m; row += stride >> 5) {
        Acc acc = Acc(0);
        for (int j = lane; j < m; j += 32)
          acc += coarse_val(a.ac_inv[(size_t)row * m + j]) * coarse_rhs<A>(a.rc[j]);
        acc = warp_sum(acc);
        if (lane == 0) a.zc[row] = (float)acc;
      }
    }
    grid.sync();
    // z2 = z1 + P zc ⊙ act, into t (whose restriction is done)
    for (int i = tid; i < n; i += stride) {
      const int iy = i / ns, ix = i - iy * ns;
      a.t[i] = a.z1[i] + (T)a.zc[(iy / blk) * nc + ix / blk] * a.act[i];
    }
    grid.sync();
    // z = z2 + ω D⁻¹ (r − K z2)
    for (int i = tid; i < n; i += stride) {
      const int iy = i / ns, ix = i - iy * ns;
      const T* z2 = a.t;
      const T kz = apply_at(a.op, iy, ix, [&](int j) { return z2[j]; });
      const T zv = z2[i] + omega * (a.invd[i] * (a.r[i] - kz));
      a.z[i] = zv;
      s[0] += a.act[i] * zv;
    }
  }
  reduce_grid(grid, s, a.partials, slot);
  const T coef = s[0] / ww;
  T s2[2] = {T(0), T(0)};
  for (int i = tid; i < n; i += stride) {
    const T zv = a.z[i] - coef * a.act[i];
    a.z[i] = zv;
    const T rv = a.r[i];
    s2[0] += rv * zv;
    s2[1] += rv * rv;
  }
  reduce_grid(grid, s2, a.partials, slot);
  rz = s2[0];
  rr = s2[1];
}

template <typename T, typename A>
__global__ void __launch_bounds__(kThreads) pressure_cg_kernel(PressureArgs<T, A> a) {
  cg::grid_group grid = cg::this_grid();
  const int ns = a.op.ns, n = ns * ns;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  int slot = 0;

  // act·act and act·b; x = x0
  T s0[2] = {T(0), T(0)};
  for (int i = tid; i < n; i += stride) {
    const T ai = a.act[i];
    s0[0] += ai * ai;
    s0[1] += ai * a.b[i];
    a.x[i] = a.x0[i];
  }
  reduce_grid(grid, s0, a.partials, slot);
  const T ww = s0[0];
  const T cb = s0[1] / ww;

  // b' = project(b); r = b' − K x0; sums b'·b', act·r
  T s1[2] = {T(0), T(0)};
  for (int i = tid; i < n; i += stride) {
    const int iy = i / ns, ix = i - iy * ns;
    const T bp = a.b[i] - cb * a.act[i];
    const T* x0 = a.x0;
    const T rv = bp - apply_at(a.op, iy, ix, [&](int j) { return x0[j]; });
    a.r[i] = rv;
    s1[0] += bp * bp;
    s1[1] += a.act[i] * rv;
  }
  reduce_grid(grid, s1, a.partials, slot);
  const T tl = a.tol * tmax(tsqrt(s1[0]), T(1e-30));
  const T atol2 = tl * tl;
  const T cr = s1[1] / ww;
  for (int i = tid; i < n; i += stride) a.r[i] = a.r[i] - cr * a.act[i];
  T rz, rr;
  precond_project(a, grid, slot, ww, rz, rr);
  for (int i = tid; i < n; i += stride) a.p[i] = a.z[i];
  grid.sync();

  int k = 0;
  while (k < a.iters && (a.tol <= T(0) || rr > atol2)) {
    // q = project(K p); p·q
    T s2[1] = {T(0)};
    for (int i = tid; i < n; i += stride) {
      const int iy = i / ns, ix = i - iy * ns;
      const T* p = a.p;
      const T qv = apply_at(a.op, iy, ix, [&](int j) { return p[j]; });
      a.q[i] = qv;
      s2[0] += a.act[i] * qv;
    }
    reduce_grid(grid, s2, a.partials, slot);
    const T cq = s2[0] / ww;
    T s3[1] = {T(0)};
    for (int i = tid; i < n; i += stride) {
      const T qv = a.q[i] - cq * a.act[i];
      a.q[i] = qv;
      s3[0] += a.p[i] * qv;
    }
    reduce_grid(grid, s3, a.partials, slot);
    const T alpha = s3[0] != T(0) ? rz / s3[0] : T(0);
    for (int i = tid; i < n; i += stride) {
      a.x[i] = a.x[i] + alpha * a.p[i];
      a.r[i] = a.r[i] - alpha * a.q[i];
    }
    T rz_new;
    precond_project(a, grid, slot, ww, rz_new, rr);
    const T beta = rz != T(0) ? rz_new / rz : T(0);
    rz = rz_new;
    for (int i = tid; i < n; i += stride) a.p[i] = a.z[i] + beta * a.p[i];
    grid.sync();
    ++k;
  }

  // x = project(x)
  T s4[1] = {T(0)};
  for (int i = tid; i < n; i += stride) s4[0] += a.act[i] * a.x[i];
  reduce_grid(grid, s4, a.partials, slot);
  const T cx = s4[0] / ww;
  for (int i = tid; i < n; i += stride) a.x[i] = a.x[i] - cx * a.act[i];
  if (tid == 0 && a.iters_out) *a.iters_out += k;  // adds: a run's total
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t make_op(GridOp<T>& op, const T* diags, const int* rs, const int* ls, int n_off,
                    int ns, const int* rowptr, const int* lane, const int* src, const T* val) {
  if (n_off < 1 || n_off > kMaxOffsets || ns < 1) return cudaErrorInvalidValue;
  op.diags = diags;
  op.rowptr = rowptr;
  op.lane = lane;
  op.src = src;
  op.val = val;
  op.n_off = n_off;
  op.ns = ns;
  for (int g = 0; g < n_off; ++g) {
    op.sh.rs[g] = rs[g];
    op.sh.ls[g] = ls[g];
  }
  return cudaSuccess;
}

// Launch `kernel` cooperatively on as many blocks as fit on the card at
// once (and no more than the points need, nor than kMaxBlocks).
template <typename Args>
cudaError_t launch_coop(void (*kernel)(Args), Args& args, int n, cudaStream_t stream) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  int blocks = per_sm * sms;
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  const int need = (n + kThreads - 1) / kThreads;
  blocks = blocks < need ? blocks : need;
  blocks = blocks > 0 ? blocks : 1;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(kThreads), params, 0,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int viscous_cg(const T* diags, const int* rs, const int* ls, int n_off, int ns, const int* rowptr,
               const int* lane, const int* src, const T* val, const T* mask, const T* invd,
               const T* b, const T* x0, T* x, T* work, int C, double dt_nu, int iters, double tol,
               int* iters_out, void* stream) {
  ViscousArgs<T> a;
  cudaError_t err = make_op(a.op, diags, rs, ls, n_off, ns, rowptr, lane, src, val);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)ns * ns;
  a.mask = mask;
  a.invd = invd;
  a.b = b;
  a.x0 = x0;
  a.x = x;
  a.r = work;
  a.p = work + C * n;
  a.q = work + 2 * C * n;
  a.partials = work + 3 * C * n;
  a.dt_nu = (T)dt_nu;
  a.tol = (T)tol;
  a.iters = iters;
  a.iters_out = iters_out;
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 1) return (int)launch_coop(viscous_cg_kernel<T, 1>, a, (int)n, s);
  if (C == 2) return (int)launch_coop(viscous_cg_kernel<T, 2>, a, (int)n, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename A>
int pressure_cg(const T* diags, const int* rs, const int* ls, int n_off, int ns,
                const int* rowptr, const int* lane, const int* src, const T* val, const T* act,
                const T* invd, const A* ac_inv, int blk, int nc, int use_coarse, const T* b,
                const T* x0, T* x, T* work, float* fwork, double omega, int iters, double tol,
                int* iters_out, void* stream) {
  PressureArgs<T, A> a;
  cudaError_t err = make_op(a.op, diags, rs, ls, n_off, ns, rowptr, lane, src, val);
  if (err != cudaSuccess) return (int)err;
  if (blk < 1 || nc < 1 || (size_t)nc * blk < (size_t)ns) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)ns * ns;
  a.act = act;
  a.invd = invd;
  a.ac_inv = ac_inv;
  a.b = b;
  a.x0 = x0;
  a.x = x;
  a.r = work;
  a.p = work + n;
  a.q = work + 2 * n;
  a.z1 = work + 3 * n;
  a.z = work + 4 * n;
  a.t = work + 5 * n;
  a.partials = work + 6 * n;
  a.r1 = fwork;
  a.rc = fwork + (size_t)nc * ns;
  a.zc = fwork + (size_t)nc * ns + (size_t)nc * nc;
  a.omega = (T)omega;
  a.tol = (T)tol;
  a.blk = blk;
  a.nc = nc;
  a.use_coarse = use_coarse;
  a.iters = iters;
  a.iters_out = iters_out;
  return (int)launch_coop(pressure_cg_kernel<T, A>, a, (int)n, (cudaStream_t)stream);
}

}  // namespace

#define VISCOUS_ENTRY(NAME, T)                                                                  \
  extern "C" int NAME(const T* diags, const int* rs, const int* ls, int n_off, int ns,          \
                      const int* rowptr, const int* lane, const int* src, const T* val,         \
                      const T* mask, const T* invd, const T* b, const T* x0, T* x, T* work,     \
                      int C, double dt_nu, int iters, double tol, int* iters_out,               \
                      void* stream) {                                                           \
    return viscous_cg<T>(diags, rs, ls, n_off, ns, rowptr, lane, src, val, mask, invd, b, x0,   \
                         x, work, C, dt_nu, iters, tol, iters_out, stream);                     \
  }

#define PRESSURE_ENTRY(NAME, T, A)                                                              \
  extern "C" int NAME(const T* diags, const int* rs, const int* ls, int n_off, int ns,          \
                      const int* rowptr, const int* lane, const int* src, const T* val,         \
                      const T* act, const T* invd, const A* ac_inv, int blk, int nc,            \
                      int use_coarse, const T* b, const T* x0, T* x, T* work, float* fwork,     \
                      double omega, int iters, double tol, int* iters_out, void* stream) {      \
    return pressure_cg<T, A>(diags, rs, ls, n_off, ns, rowptr, lane, src, val, act, invd,       \
                             ac_inv, blk, nc, use_coarse, b, x0, x, work, fwork, omega, iters,  \
                             tol, iters_out, stream);                                           \
  }

VISCOUS_ENTRY(viscous_cg_f32, float)
VISCOUS_ENTRY(viscous_cg_f64, double)
PRESSURE_ENTRY(pressure_cg_f32, float, float)
PRESSURE_ENTRY(pressure_cg_f32_bf16, float, __nv_bfloat16)
PRESSURE_ENTRY(pressure_cg_f64, double, double)
PRESSURE_ENTRY(pressure_cg_f64_bf16, double, __nv_bfloat16)
