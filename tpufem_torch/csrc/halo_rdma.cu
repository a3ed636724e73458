// Ring halo exchange of row strips for the sharded grid solvers (Hopper, sm_90a).
//
// Replaces the TPU kernel `make_halo_rdma` in
// tpufem/parallel/grid_remote_dma.py (K6), the remote-DMA halo of the
// space-sharded grid solvers (tpufem/parallel/grid_sharded.py under
// halo="rdma"): every matvec of those solvers, and the two row rolls of each
// pressure solve, extend each shard's (h, ns) strip of the (ns, ns) grid
// image to (h + 2d, ns) with d rows from each ring neighbour:
//
//   out_i[d : d+h]    = x_i
//   out_i[0 : d]      = x_{i-1}[h-d : h]   ("from_prev")
//   out_i[d+h : h+2d] = x_{i+1}[0 : d]     ("from_next"),  indices mod S,
//
// so the ring reproduces the grid's cyclic row wrap exactly.
//
// Form.  The TPU kernel is a push: each shard copies its centre, then DMAs
// its last d rows into its right neighbour's out[0:d] and its first d rows
// into its left neighbour's out[d+h:], after a barrier that makes sure the
// neighbours' buffers exist.  Here shard i stores through the per-shard
// pointers it is given: x_i into out_i, its edges into out_{i+1} and
// out_{i-1}.  All shards that share a device go in one launch (blockIdx.y
// indexes the launch's list of shards); a neighbour's out on another card is
// written through peer access (halo_rdma_enable_peer), over NVLink.  The
// launching stream is ordered after the kernels that wrote x and after the
// allocation of every out it writes (on another card: by an event the
// caller records there), which is what the TPU barrier gives; the stream of
// each out's card waits for every launch that writes into it (the receive
// semaphores).  Every element of every out is written exactly once, by one
// thread, so there are no races and no atomics.  It is pure data movement:
// the result is bit-equal to the plain version (torch.cat).
//
// What bounds it.  Each call reads S·h·ns values and writes S·(h+2d)·ns:
// memory-bound, 8.4 MB at 1,048,576 nodes f32 in 4 shards (about 2.5 µs at
// 3.35 TB/s).  Each shard's three pieces are contiguous runs of the strip
// and of the outputs, copied in 16-byte vectors (float4 / double2) when the
// row length in bytes and every pointer allow it (then every piece starts
// on a 16-byte boundary), one value at a time otherwise; a grid-stride loop
// over the pieces' units, neighbouring threads on neighbouring addresses.
//
// The plain C interface is bound with ctypes
// (tpufem_torch/parallel/grid_remote_dma.py).  Each entry point launches on
// the caller's stream, allocates nothing and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it cannot take).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxShards = 64;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksPerShard = 1024;

template <typename U>
struct Ring {
  const U* x[kMaxShards];  // shard i's (h, ns) strip
  U* out[kMaxShards];      // shard i's (h + 2d, ns) output
  int local[kMaxShards];   // the shards this launch pushes, one per blockIdx.y
};

// Units are values (U = T) or 16-byte vectors of them; `row` is the units
// in one grid row.
template <typename U>
__global__ void __launch_bounds__(kThreads)
halo_push_kernel(const __grid_constant__ Ring<U> ring, int S, int64_t h, int64_t d,
                 int64_t row) {
  const int s = ring.local[blockIdx.y];
  const int64_t centre = h * row;
  const int64_t edge = d * row;
  const int64_t units = centre + 2 * edge;
  const U* __restrict__ x = ring.x[s];
  U* mine = ring.out[s];
  U* next = ring.out[s + 1 == S ? 0 : s + 1];
  U* prev = ring.out[s == 0 ? S - 1 : s - 1];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; u < units;
       u += stride) {
    if (u < centre) {
      mine[edge + u] = x[u];  // the centre
    } else if (u < centre + edge) {
      const int64_t v = u - centre;
      next[v] = x[centre - edge + v];  // last d rows -> next shard's from_prev
    } else {
      const int64_t v = u - centre - edge;
      prev[edge + centre + v] = x[v];  // first d rows -> previous shard's from_next
    }
  }
}

template <typename U>
int launch_units(const void* const* x, void* const* out, int S, const int* local, int n_local,
                 int64_t h, int64_t d, int64_t row, cudaStream_t stream) {
  Ring<U> ring;
  for (int i = 0; i < S; ++i) {
    ring.x[i] = static_cast<const U*>(x[i]);
    ring.out[i] = static_cast<U*>(out[i]);
  }
  for (int j = 0; j < n_local; ++j) ring.local[j] = local[j];
  const int64_t units = (h + 2 * d) * row;
  int64_t blocks = (units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocksPerShard) blocks = kMaxBlocksPerShard;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_local));
  halo_push_kernel<U><<<grid, kThreads, 0, stream>>>(ring, S, h, d, row);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename V>
int launch(const void* const* x, void* const* out, int S, const int* local, int n_local,
           int64_t h, int64_t ns, int64_t d, void* stream) {
  if (S < 1 || S > kMaxShards || n_local < 1 || n_local > S || h < 1 || ns < 1 || d < 1 ||
      d > h) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int j = 0; j < n_local; ++j) {
    if (local[j] < 0 || local[j] >= S) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool vec = (ns * static_cast<int64_t>(sizeof(T))) % sizeof(V) == 0;
  for (int i = 0; vec && i < S; ++i) {
    vec = reinterpret_cast<uintptr_t>(x[i]) % sizeof(V) == 0 &&
          reinterpret_cast<uintptr_t>(out[i]) % sizeof(V) == 0;
  }
  if (vec) {
    return launch_units<V>(x, out, S, local, n_local, h, d, ns * sizeof(T) / sizeof(V), s);
  }
  return launch_units<T>(x, out, S, local, n_local, h, d, ns, s);
}

}  // namespace

extern "C" {

// x, out: the S shards' strips and outputs (device pointers, any card);
// local: the n_local shards whose strips lie on the launching stream's card.
int halo_rdma_f32(const void* const* x, void* const* out, int S, const int* local, int n_local,
                  int64_t h, int64_t ns, int64_t d, void* stream) {
  return launch<float, float4>(x, out, S, local, n_local, h, ns, d, stream);
}

int halo_rdma_f64(const void* const* x, void* const* out, int S, const int* local, int n_local,
                  int64_t h, int64_t ns, int64_t d, void* stream) {
  return launch<double, double2>(x, out, S, local, n_local, h, ns, d, stream);
}

// Let kernels on `device` store into memory on `peer` (NVLink peer access);
// already enabled counts as success.  Restores the calling thread's device.
int halo_rdma_enable_peer(int device, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int can = 0;
  err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err == cudaSuccess && !can) err = cudaErrorPeerAccessUnsupported;
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear it: PyTorch may have enabled the pair first
      err = cudaSuccess;
    }
    cudaSetDevice(prev);
  }
  return static_cast<int>(err);
}

}  // extern "C"
