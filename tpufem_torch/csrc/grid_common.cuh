// Device helpers shared by the whole-solve kernels (grid_cg.cu: K2, K3, K4)
// and the whole-step kernel (grid_step.cu: K5): the grid-offset operator
// apply, the deterministic grid-wide reductions, K3's pressure solve and its
// two-level preconditioner, and the cooperative launch.  Each source that
// includes it gets its own copy (anonymous namespace).

#pragma once

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
// K3: pressure solve (also run inside K5)
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
  // b and x0 are not __restrict__: K5 rewrites them between its solves, and a
  // restricted const pointer may be read through the non-coherent cache
  const T* b;  // the prepared rhs
  const T* x0;
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

// K3's whole solve: b is the prepared rhs, x0 the masked warm start; the
// solution lands in x, projected.  No grid sync after the last write of x.
template <typename T, typename A>
__device__ __forceinline__ void pressure_solve(const PressureArgs<T, A>& a, cg::grid_group& grid,
                                               int& slot) {
  const int ns = a.op.ns, n = ns * ns;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;

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

}  // namespace
