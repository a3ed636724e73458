// The Navier–Stokes step's per-step refill of the advection C(u) onto the
// velocity operator's offset planes (Hopper, sm_90a): kernels E and G.
//
// Replaces no TPU kernel.  tpufem builds the same values with XLA: the
// element values of C(u) as a fused elementwise program and their sum onto
// the planes as an XLA scatter (tpufem/ops/gridop.py, GridRefill).  The
// port ran them as about thirty plain-torch launches a step and one
// index_add_ with atomics; the two kernels here replace those, behind the
// functions the step calls (ops/assembly.element_convection_flat and
// ops/gridop.GridRefill.refill_flat), which keep their plain versions for
// CPU tensors.
//
// E, ns_convection_flat: one thread an element t.  It loads the element's
// three corners of u as one 8- (16-) byte vector each, forms the centroid
// velocity (u0 + u1 + u2)·fl(1/3) (the rounding of `total / 3.0` on a CUDA
// tensor: PyTorch multiplies by the scalar's reciprocal there), and
// w_j = row · (ūx · gx_j + ūy · gy_j) for j = 0, 1, 2, each operation
// rounded on its own (the _rn intrinsics: no multiply-add is contracted),
// in the plain code's order.  It writes w_j to entries (3i + j)·T + t,
// i = 0, 1, 2: the (9·T,) k-major layout, the row index uniform.  The
// per-element constants are built once on the device by the plain code's
// own torch operations (ops/assembly.convection_constants): tris (3, T)
// int32 and geo (7, T) = gx0, gy0, gx1, gy1, gx2, gy2, row, struct-of-
// arrays, so neighbouring threads read neighbouring words.  The output is
// bit-equal to the plain version on the card.
//
// G, ns_segment_sum: one thread a flat slot s (a plane slot g·N + row, or
// remainder entry k).  index (E,) int32 lists the positions of vals summed
// into each slot, slot by slot, each slot's in entry order (the stable sort
// of the refill's slot map), and ptr (n + 1,) int32 bounds each slot's
// run.  The thread loads up to eight terms of its run at once (index, then
// vals: the loads of one term depend on each other, those of different
// terms do not, so a thread waits for three loads and not for two a term),
// sums them from 0 in run order and writes the slot; an empty run writes
// 0.  That is the order the CPU's index_add_ adds in, so G is bit-equal to
// the plain version on the CPU, every slot is written (no zero fill) and
// nothing is summed with atomics: two refills of one state are bit-equal.
//
// What bounds them.  Both are memory-bound.  At 1,048,576 nodes, f32
// (T = 1,681,036 elements, E = 9·T = 15.1M entries, n = 9,439,032 slots):
// E reads 40 B an element (12 of indices, 28 of constants) and u once and
// writes 36 B, 136 MB or 41 µs at 3.35 TB/s; G reads 4 B of index and 4 B
// of value an entry and 4 B of pointer a slot and writes 4 B a slot,
// 197 MB or 59 µs.  G's reads of vals are a gather, and the mesh numbers
// its elements in its generator's order, which follows no slot order: each
// term reads a 32-byte sector of its own, 15.1M sectors or 484 MB, and the
// reuse of a sector is half a pass away, past what the L2 holds.  That puts
// G's floor near (484 + 136) MB, ~185 µs; it runs at ~176 µs on the H100.
// Issuing a run's loads together took it from ~185 µs; evict-first loads
// of the streams, to keep vals in the L2, made it slower.  A numbering of
// the elements along the raster would make the gather a few sector runs a
// warp.
//
// The plain C interface is bound with ctypes (tpufem_torch/ops/
// ns_refill.py).  Each entry point launches on the caller's stream,
// allocates nothing and returns cudaGetLastError() (or
// cudaErrorInvalidValue for sizes it cannot take).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;  // G's terms loaded at once: a P1 slot's run is up to ~8 elements

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
convection_flat_kernel(const int32_t* __restrict__ tris, const T* __restrict__ geo,
                       const typename Pair<T>::type* __restrict__ u, T* __restrict__ out,
                       int64_t n) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const auto a = u[tris[t]];
  const auto b = u[tris[n + t]];
  const auto c = u[tris[2 * n + t]];
  constexpr T third = T(1) / T(3);  // fl(1/3), as PyTorch's reciprocal of the scalar 3.0
  const T ux = mul_rn(add_rn(add_rn(a.x, b.x), c.x), third);
  const T uy = mul_rn(add_rn(add_rn(a.y, b.y), c.y), third);
  const T row = geo[6 * n + t];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T w = mul_rn(row, add_rn(mul_rn(ux, geo[2 * j * n + t]),
                                   mul_rn(uy, geo[(2 * j + 1) * n + t])));
    out[j * n + t] = w;
    out[(3 + j) * n + t] = w;
    out[(6 + j) * n + t] = w;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ vals, const int32_t* __restrict__ index,
                   const int32_t* __restrict__ ptr, T* __restrict__ out, int64_t n) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const int32_t end = ptr[s + 1];
  T acc = T(0);
  for (int32_t k0 = ptr[s]; k0 < end; k0 += kRun) {
    // a run's loads issued together, then summed in order: a chain of
    // three dependent loads (ptr, index, vals) a thread, not 1 + 2 a term
    int32_t at[kRun];
    T v[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) at[i] = k0 + i < end ? index[k0 + i] : -1;
#pragma unroll
    for (int i = 0; i < kRun; ++i) v[i] = at[i] >= 0 ? vals[at[i]] : T(0);
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (k0 + i < end) acc = add_rn(acc, v[i]);
    }
  }
  out[s] = acc;
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

constexpr int64_t kMaxItems = int64_t(kThreads) * 0x7fffffff;

template <typename T>
int convection_flat(const void* tris, const void* geo, const void* u, void* out, int64_t n,
                    void* stream) {
  if (n < 0 || n > kMaxItems) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  convection_flat_kernel<T><<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const int32_t*>(tris), static_cast<const T*>(geo),
      static_cast<const typename Pair<T>::type*>(u), static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int segment_sum(const void* vals, const void* index, const void* ptr, void* out, int64_t n,
                void* stream) {
  if (n < 0 || n > kMaxItems) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  segment_sum_kernel<T><<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const T*>(vals), static_cast<const int32_t*>(index),
      static_cast<const int32_t*>(ptr), static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ns_convection_flat_f32(const void* tris, const void* geo, const void* u, void* out,
                           int64_t n_tris, void* stream) {
  return convection_flat<float>(tris, geo, u, out, n_tris, stream);
}

int ns_convection_flat_f64(const void* tris, const void* geo, const void* u, void* out,
                           int64_t n_tris, void* stream) {
  return convection_flat<double>(tris, geo, u, out, n_tris, stream);
}

int ns_segment_sum_f32(const void* vals, const void* index, const void* ptr, void* out,
                       int64_t n_slots, void* stream) {
  return segment_sum<float>(vals, index, ptr, out, n_slots, stream);
}

int ns_segment_sum_f64(const void* vals, const void* index, const void* ptr, void* out,
                       int64_t n_slots, void* stream) {
  return segment_sum<double>(vals, index, ptr, out, n_slots, stream);
}

}  // extern "C"
