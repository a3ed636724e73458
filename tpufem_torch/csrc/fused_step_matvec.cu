// Fused-step matvec y = M·x + b for the dense Stokes regime (Hopper, sm_90a).
//
// Replaces the TPU kernel `_pallas_matvec` in tpufem/ops/pallas_kernels.py
// (K1), which `projection_step` in tpufem/workloads/stokes.py calls once per
// step.  M is the host-composed (2N, 2N) whole-step matrix (viscous inverse
// -> BC row surgery -> double projection), x the stacked velocity [ux; uy]
// and b the composed affine offset.
//
// What bounds it.  A GEMV does 2 flops per element of M it reads, so it is
// bound by the bytes of M, never by arithmetic.  At the bench mesh (2N =
// 1704, f32) M is 11.6 MB and stays in the 50 MB L2 across the step loop,
// so the kernel runs at L2 bandwidth (plus launch latency).  At the top of
// the dense regime (~4k nodes, 2N ~ 8k) M is 256 MB in f32 and the kernel
// is bound by HBM bandwidth (3.35 TB/s on an H100 SXM at 700 W).  Measured
// on an H100 80GB HBM3 at 700 W, f32: 4.3 µs at 2N = 1704 and 59 µs at
// 2N = 6200 (2.6 TB/s, 78 % of the HBM peak).
//
// Design.  One warp per row, eight rows per block.  Each lane reads
// 16-byte vectors of its row (float4 / double2: neighbouring lanes on
// neighbouring addresses, so one warp load is 512 coalesced bytes) when the
// row stride and the pointers allow it, with a scalar tail otherwise.  x is
// staged once per block in shared memory when it fits the 48 KB that a block
// may use without opting in (C <= 12,288 f32 or 6,144 f64), else it is read
// through the read-only path from L2.  Lanes accumulate in the input type
// and a warp-shuffle tree reduces them; b is added in the epilogue.  No
// padding of M is needed: R and C are free.
//
// The plain C interface is bound with ctypes (tpufem_torch/ops/fused_matvec.py).
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so a refused launch is reported at once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int64_t kStageLimitBytes = 48 * 1024;

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int width = 4;
  __device__ static float dot(float acc, const float4& m, const float4& x) {
    acc = fmaf(m.x, x.x, acc);
    acc = fmaf(m.y, x.y, acc);
    acc = fmaf(m.z, x.z, acc);
    return fmaf(m.w, x.w, acc);
  }
};

template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int width = 2;
  __device__ static double dot(double acc, const double2& m, const double2& x) {
    acc = fma(m.x, x.x, acc);
    return fma(m.y, x.y, acc);
  }
};

template <typename T, bool kStageX, bool kVec>
__global__ void __launch_bounds__(kThreads)
fused_step_matvec_kernel(const T* __restrict__ M, const T* __restrict__ x,
                         const T* __restrict__ b, T* __restrict__ y,
                         int64_t R, int64_t C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* xr = x;
  if constexpr (kStageX) {
    T* xs = reinterpret_cast<T*>(smem_raw);
    for (int64_t j = threadIdx.x; j < C; j += kThreads) xs[j] = __ldg(x + j);
    __syncthreads();
    xr = xs;
  }

  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;  // whole warps leave together, after the barrier
  const T* mrow = M + row * C;

  T acc = T(0);
  int64_t tail = 0;
  if constexpr (kVec) {
    using V = typename Vec16<T>::type;
    constexpr int W = Vec16<T>::width;
    const int64_t nv = C / W;
    const V* mv = reinterpret_cast<const V*>(mrow);
    const V* xv = reinterpret_cast<const V*>(xr);
    for (int64_t k = lane; k < nv; k += 32) {
      const V m = __ldg(mv + k);
      V xx;
      if constexpr (kStageX) {
        xx = xv[k];
      } else {
        xx = __ldg(xv + k);
      }
      acc = Vec16<T>::dot(acc, m, xx);
    }
    tail = nv * W;
  }
  for (int64_t j = tail + lane; j < C; j += 32) {
    T xj;
    if constexpr (kStageX) {
      xj = xr[j];
    } else {
      xj = __ldg(xr + j);
    }
    acc = fma(__ldg(mrow + j), xj, acc);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) y[row] = acc + b[row];
}

template <typename T>
int launch(const void* M, const void* x, const void* b, void* y, int64_t R,
           int64_t C, void* stream) {
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int W = Vec16<T>::width;
  const bool stage = C * static_cast<int64_t>(sizeof(T)) <= kStageLimitBytes;
  // 16-byte loads need every row start aligned: the base pointer and the
  // row stride; x needs it too unless it is read from shared memory.
  const bool vec = (C % W == 0) &&
                   (reinterpret_cast<uintptr_t>(M) % 16 == 0) &&
                   (stage || reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const dim3 grid(static_cast<unsigned>((R + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kThreads);
  const size_t smem = stage ? static_cast<size_t>(C) * sizeof(T) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* m = static_cast<const T*>(M);
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  if (stage && vec) {
    fused_step_matvec_kernel<T, true, true><<<grid, block, smem, s>>>(m, xp, bp, yp, R, C);
  } else if (stage) {
    fused_step_matvec_kernel<T, true, false><<<grid, block, smem, s>>>(m, xp, bp, yp, R, C);
  } else if (vec) {
    fused_step_matvec_kernel<T, false, true><<<grid, block, 0, s>>>(m, xp, bp, yp, R, C);
  } else {
    fused_step_matvec_kernel<T, false, false><<<grid, block, 0, s>>>(m, xp, bp, yp, R, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fused_step_matvec_f32(const void* M, const void* x, const void* b, void* y,
                          int64_t R, int64_t C, void* stream) {
  return launch<float>(M, x, b, y, R, C, stream);
}

int fused_step_matvec_f64(const void* M, const void* x, const void* b, void* y,
                          int64_t R, int64_t C, void* stream) {
  return launch<double>(M, x, b, y, R, C, stream);
}

}  // extern "C"
