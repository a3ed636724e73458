// Device helpers shared by the whole-solve kernels (grid_cg.cu: K2, K3, K4)
// and the whole-step kernel (grid_step.cu: K5): the grid-offset operator
// apply (one column; several at once in K2's and K4's apply_cols), the
// deterministic grid-wide reductions, K3's pressure solve and its two-level
// preconditioner, and the cooperative launch.  Each source that includes it
// gets its own copy (anonymous namespace).
//
// The operator apply streams the offset planes with evict-first loads
// (__ldcs), so that the vectors the gathers reuse stay in L2, and finds a
// point's remainder entries by a binary search for its lane in its target
// row (the COO list is sorted by target, stably, so a row's lanes ascend and
// one target's entries sit together in input order): the same entries in
// the same order as a scan of the whole row, so every sum is bit-equal to
// the scan's, at a cost of log2(row length) loads instead of the row length.
//
// K3's pressure iteration (pressure_solve) is fused for this card: four grid
// syncs an iteration instead of eleven, and 17 vector passes instead of 35
// (z1, t, z2 and the projected q, z and p are computed where they are read,
// never stored):
//
//   A  q = K p with p = (z − coef·act) + β·p_old computed at each source;
//      p and q written; sums act·q, p·q, p·act                     [reduce]
//   B  r = r_old − α(q − cq·act) and z1 = ω D⁻¹ r computed at each source;
//      t = r − K z1 into a shared-memory tile of whole coarse aggregates
//      and restricted there (row-block sums in row order, rounded to float;
//      lane-block sums in float, lane order); r and x += α p written [sync]
//   C  zc = A_c⁻¹ rc, one warp a coarse row                         [sync]
//   D  z = z2 + ω D⁻¹ (r − K z2) with z2 = z1 + zc[agg]·act computed at
//      each source; z written; sums act·z, r·z, r·act, r·r        [reduce]
//
// A, B and D walk the same tiles, units of whole coarse aggregates (a band
// of blk rows and up to kLanes lanes), a slab of rows at a time; a source
// value is computed at each source from device memory (its neighbours'
// loads hit L1 and L2).  Staging each slab's sources and their halo in
// shared memory once was measured and bought nothing: at 1,048,576 nodes on
// an H100 an f32 iteration took 0.129 ms staged against 0.121 unstaged, at
// 4 blocks per SM, whose register budget the staged form overran.  r and p
// are double-buffered: a phase reads the old copy at its neighbours while it
// writes the new one at its own points.  Per point every value is the same
// floating-point expression as in the unfused form (and the plain version);
// the dot products differ in order and in two places in form:
// p·(q − cq·act) = p·q − cq·(p·act) and r·(z − coef·act) = r·z − coef·(r·act)
// (p and r are projected, so p·act and r·act are roundoff).
//
// The exchange at the grid barriers is the part of an iteration that does
// not scale with the grid: its 4 grid syncs, the totals of its two
// reductions, and phase C (K3's `exchange` probe, roofline.probes, times it
// alone).  Each block stores its partial sums value-major
// ([slot][value][kMaxBlocks]); after the sync warp j of every block sums
// value j, each lane loading kTotalRuns 16-byte runs of consecutive blocks'
// partials before its first add: one L2 round trip up to 640 blocks at f32.
// On an H100 at 1,048,576 nodes (528 blocks) that took an iteration's two
// totals from ~5 µs to ~2 and its exchange from 12.6–14.3 µs to 9.8–10.9
// (the block-major [block][kSlots] store it replaced was read by warp 0 of
// every block, 17 loads a lane at a 32-byte stride for each value).  What is
// left is the 4 grid syncs (6.1–7.0 µs together) and phase C (1.6–1.9 µs).
// Phase C spread over every resident block (a few rows a block, each split
// over the block's warps, rc staged in shared memory or read from L2 beside
// the inverse) took as long as one warp a row on the first 128 blocks, so it
// stays so.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOffsets = 64;
constexpr int kUnrolled = 8;      // offsets whose loads K3's apply starts together
constexpr int kMaxBlocks = 4096;  // partial-sum slots per reduction (the wrapper allocates them)
constexpr int kSlots = 8;         // values reduced per phase, at most
constexpr int kTile = 1024;       // K3's tiles: points a slab and lanes a unit, at most
constexpr int kLanes = 256;       // K3's tiles: lanes a unit where blk ≤ kLanes
constexpr int kTotalRuns = 5;     // 16-byte runs a lane of grid_totals loads at once

struct Shifts {
  int rs[kMaxOffsets];  // source row offset, (dy mod ns)
  int ls[kMaxOffsets];  // source lane offset, (s mod ns)
};

// The operator on fields of type T.  Its planes may be stored narrower (P:
// K3's bf16 preconditioner planes); a plane entry is widened to T where it
// is read, so the products and sums stay in T.
template <typename T, typename P = T>
struct GridOp {
  using value_type = T;
  static constexpr int kProbe = 0;  // a real apply (ProbeOp below)
  const P* __restrict__ diags;  // (n_off, ns, ns)
  const int* __restrict__ rowptr;  // (ns+1) remainder entries per target row
  const int* __restrict__ lane;    // (m) target lane, ascending within a row
  const int* __restrict__ src;     // (m) flat source index
  const T* __restrict__ val;       // (m)
  int n_off;
  int ns;
  int round_rest;  // round each remainder source and sum to float (tpufem's kernels)
  Shifts sh;
};

// K3's measurement variants (roofline.probes; wrong results by design),
// compile-time, so that the real apply gains no branch:
//   kNoFma  loads every plane entry and drops it: the loaded bits are folded
//           into an integer that is masked by `keep` (0 at run time) and added
//           to y as +0.0, which leaves y as it was (y is never −0.0 there);
//           no source is gathered and no product is formed, so the apply is
//           the remainder alone;
//   kNoDma  reads no plane bytes: each gathered source is multiplied by its
//           plane's constant (`plane_const`, the plane's mean), so the
//           gathers and the FMAs stay.
//   (in both the remainder, the syncs, the vector passes and the coarse
//   solve are the real kernel's)
//   kExchange  phases A, B and D visit no points: an iteration is its grid
//              syncs, its two reductions' totals and the coarse product
//              (on whatever rc holds), the exchange alone.
// A probe launches on as many blocks as the real kernel (launch_coop).
constexpr int kNoFma = 1;
constexpr int kNoDma = 2;
constexpr int kExchange = 3;

template <typename T, int Probe> struct ProbeParams;
template <typename T> struct ProbeParams<T, kNoFma> { unsigned keep; };
template <typename T> struct ProbeParams<T, kNoDma> { T plane_const[kMaxOffsets]; };
template <typename T> struct ProbeParams<T, kExchange> {};

template <typename T, int Probe>
struct ProbeOp : GridOp<T> {
  static constexpr int kProbe = Probe;
  ProbeParams<T, Probe> probe;
};

template <typename T> __device__ __forceinline__ T plane_val(T v) { return v; }
template <typename T> __device__ __forceinline__ T plane_val(__nv_bfloat16 v) {
  return (T)__bfloat162float(v);
}
__device__ __forceinline__ unsigned probe_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned probe_bits(double v) {
  return (unsigned)__double_as_longlong(v);
}

__device__ __forceinline__ float tsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double tsqrt(double v) { return sqrt(v); }
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
// tpufem's kernels round the remainder products to float at every precision;
// the operators that mirror its split do too (GridOp::round_rest)
__device__ __forceinline__ float round_f(float v) { return v; }
__device__ __forceinline__ double round_f(double v) { return (double)(float)v; }

// The first remainder entry in [k0, k1) (one target row) whose lane is not
// below ix.
template <typename T, typename P>
__device__ __forceinline__ int lane_search(const GridOp<T, P>& op, int k0, int k1, int ix) {
  int lo = k0, hi = k1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (op.lane[mid] < ix) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// y += the remainder's sum at (iy, ix), if the row has entries (each source
// value and the sum rounded to float where op.round_rest); src(j, jy, jx)
// gives the source value at flat index j.
template <typename T, typename P, typename F>
__device__ __forceinline__ void add_rest(const GridOp<T, P>& op, int iy, int ix, F src, T& y) {
  const int k0 = op.rowptr[iy], k1 = op.rowptr[iy + 1];
  if (k0 < k1) {
    const int lo = lane_search(op, k0, k1, ix);
    T rest = T(0);
    for (int k = lo; k < k1 && op.lane[k] == ix; ++k) {
      const int j = op.src[k];
      const int jy = j / op.ns;
      const T v = src(j, jy, j - jy * op.ns);
      rest += op.val[k] * (op.round_rest ? round_f(v) : v);
    }
    y += op.round_rest ? round_f(rest) : rest;
  }
}

// K·X at one point; src(j, jy, jx) gives the source value at flat index
// j = jy·ns + jx.  Planes in offset order, then the point's remainder sum.
// Unroll: start the loads of the first kUnrolled offsets together (K3's
// phases; K5's other phases keep the plain loop).  Op is a GridOp, or a
// ProbeOp for K3's measurement variants.
template <bool Unroll, typename Op, typename F>
__device__ __forceinline__ typename Op::value_type apply_yx(const Op& op, int iy, int ix, F src) {
  using T = typename Op::value_type;
  const int ns = op.ns;
  const long long n = (long long)ns * ns;
  const int i = iy * ns + ix;
  T y = T(0);
  [[maybe_unused]] unsigned sink = 0u;
  auto plane = [&](int g) {
    if constexpr (Op::kProbe == kNoFma) {
      sink ^= probe_bits(__ldcs(op.diags + g * n + i));
    } else {
      int sy = iy + op.sh.rs[g];
      sy -= (sy >= ns) ? ns : 0;
      int sx = ix + op.sh.ls[g];
      sx -= (sx >= ns) ? ns : 0;
      if constexpr (Op::kProbe == kNoDma)
        y += op.probe.plane_const[g] * src(sy * ns + sx, sy, sx);
      else
        y += plane_val<T>(__ldcs(op.diags + g * n + i)) * src(sy * ns + sx, sy, sx);
    }
  };
  if constexpr (Unroll) {
#pragma unroll
    for (int g = 0; g < kUnrolled; ++g)
      if (g < op.n_off) plane(g);
    for (int g = kUnrolled; g < op.n_off; ++g) plane(g);
  } else {
    for (int g = 0; g < op.n_off; ++g) plane(g);
  }
  if constexpr (Op::kProbe == kNoFma) y += (T)__uint_as_float(sink & op.probe.keep);
  add_rest(op, iy, ix, src, y);
  return y;
}

// K·X at one point; src(j) gives the source value at flat index j.
template <typename Op, typename F>
__device__ __forceinline__ typename Op::value_type apply_at(const Op& op, int iy, int ix, F src) {
  return apply_yx<false>(op, iy, ix, [&](int j, int, int) { return src(j); });
}

// K·X for C columns at one point (K2, K4): each plane entry and each remainder
// value is loaded once and feeds every column, and the lane search runs
// once; src(j, v) writes the C columns' source values at flat index j into
// v.  Per column the same products in the same order as apply_at's.
template <int C, typename T, typename F>
__device__ __forceinline__ void apply_cols(const GridOp<T>& op, int iy, int ix, F src,
                                           T (&y)[C]) {
  const int ns = op.ns;
  const long long n = (long long)ns * ns;
  const int i = iy * ns + ix;
#pragma unroll
  for (int c = 0; c < C; ++c) y[c] = T(0);
  for (int g = 0; g < op.n_off; ++g) {
    int sy = iy + op.sh.rs[g];
    sy -= (sy >= ns) ? ns : 0;
    int sx = ix + op.sh.ls[g];
    sx -= (sx >= ns) ? ns : 0;
    const T d = __ldcs(op.diags + g * n + i);
    T v[C];
    src(sy * ns + sx, v);
#pragma unroll
    for (int c = 0; c < C; ++c) y[c] += d * v[c];
  }
  const int k0 = op.rowptr[iy], k1 = op.rowptr[iy + 1];
  if (k0 < k1) {
    T rest[C];
#pragma unroll
    for (int c = 0; c < C; ++c) rest[c] = T(0);
    for (int k = lane_search(op, k0, k1, ix); k < k1 && op.lane[k] == ix; ++k) {
      const T w = op.val[k];
      T v[C];
      src(op.src[k], v);
#pragma unroll
      for (int c = 0; c < C; ++c) rest[c] += w * (op.round_rest ? round_f(v[c]) : v[c]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) y[c] += op.round_rest ? round_f(rest[c]) : rest[c];
  }
}

struct Add {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};

// v combined over the warp's lanes by op, in a fixed order
template <typename T, typename Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;  // the result is in lane 0
}

// Values of T in a 16-byte run.
template <typename T> constexpr int kRun = 16 / (int)sizeof(T);

// The block's v[0..NV) combined by op into its column of the partials
// slot: value j at out[j·kMaxBlocks].  The last block also zeroes the slots
// after it up to a whole number of runs, so that the totals read whole runs.
template <typename T, int NV, typename Op>
__device__ void block_partials(const T (&v)[NV], T* out, Op op) {
  __shared__ T sm[kWarps][NV];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    T s = warp_reduce(v[j], op);
    if (lane == 0) sm[warp][j] = s;
  }
  __syncthreads();
  if (warp == 0) {
    const int nb = gridDim.x, pad = (nb + kRun<T> - 1) / kRun<T> * kRun<T> - nb;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      T s = warp_reduce(lane < kWarps ? sm[lane][j] : T(0), op);
      if (lane == 0) out[(size_t)j * kMaxBlocks] = s;
      if (blockIdx.x == nb - 1 && lane >= 1 && lane <= pad)
        out[(size_t)j * kMaxBlocks + lane] = T(0);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

// x = the run p[i..i+V) where i < end, zeros where not: one 16-byte load
// where `vec` (p 16-byte aligned, i and end multiples of V), else a load an
// element, each below end.  Both read the same elements.
template <typename T, int V>
__device__ __forceinline__ void load_run(const T* p, int i, int end, bool vec, T (&x)[V]) {
  static_assert(V * sizeof(T) == 16, "a run is 16 bytes");
  if (vec) {
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (i < end) w = *reinterpret_cast<const uint4*>(p + i);
    memcpy(&x, &w, sizeof(w));
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = i + e < end ? p[i + e] : T{};
  }
}

// Every block combines all blocks' partials in the same order: identical
// bits.  Warp j takes value j, whose partials lie contiguous: its lanes load
// kTotalRuns runs each, 32 runs apart, before the first combine, a chunk of
// 32·kTotalRuns runs at a time, then the warp combines its lanes.
template <typename T, int NV, typename Op>
__device__ void grid_totals(const T* partials, T (&v)[NV], Op op) {
  static_assert(NV <= kWarps, "a warp a value");
  constexpr int V = kRun<T>, kChunk = 32 * V * kTotalRuns;
  __shared__ T res[NV];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < NV) {
    const T* p = partials + (size_t)warp * kMaxBlocks;
    const bool vec = aligned16(partials);
    const int end = ((int)gridDim.x + V - 1) / V * V;  // block_partials zeroed the pad
    T s = T(0);
    for (int c = 0; c < end; c += kChunk) {
      T x[kTotalRuns][V];
#pragma unroll
      for (int u = 0; u < kTotalRuns; ++u) load_run(p, c + (u * 32 + lane) * V, end, vec, x[u]);
#pragma unroll
      for (int u = 0; u < kTotalRuns; ++u)
#pragma unroll
        for (int e = 0; e < V; ++e) s = op(s, x[u][e]);
    }
    s = warp_reduce(s, op);
    if (lane == 0) res[warp] = s;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = res[j];
  __syncthreads();
}

// v ← the grid-wide sums of v, or its combination by op (K5's
// NaN-propagating max; 0 starts every combination), a grid sync inside.
template <typename T, int NV, typename Op = Add>
__device__ __forceinline__ void reduce_grid(cg::grid_group& grid, T (&v)[NV], T* partials,
                                            int& slot, Op op = Op()) {
  static_assert(NV <= kSlots, "kSlots values a slot");
  T* base = partials + (size_t)slot * kMaxBlocks * kSlots;
  block_partials(v, base + blockIdx.x, op);
  grid.sync();
  grid_totals(base, v, op);
  slot ^= 1;
}

// ---------------------------------------------------------------------------
// K3: pressure solve (also run inside K5)
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

// ⌊v / d⌋ for 0 ≤ v < 2²² and d ≥ 1, from the float reciprocal inv ≈ 1/d,
// corrected to the exact quotient.
__device__ __forceinline__ int div_by(int v, int d, float inv) {
  int q = __float2int_rz((float)v * inv);
  q += ((q + 1) * d <= v) ? 1 : 0;
  q -= (q * d > v) ? 1 : 0;
  return q;
}

// The preconditioner's own planes where they differ from the CG's (K3 with
// precond_bf16: POp = GridOp<T, __nv_bfloat16>, its own remainder too);
// empty, and no bytes, otherwise.
template <typename Op, typename POp> struct PrecondPlanes { POp pop; };
template <typename Op> struct PrecondPlanes<Op, Op> {};

template <typename T, typename A, typename Op = GridOp<T>, typename POp = Op>
struct PressureArgs : PrecondPlanes<Op, POp> {
  Op op;  // the CG's apply and the initial residual's (and the preconditioner's, unless POp)
  const T* __restrict__ act;
  const T* __restrict__ invd;
  const A* __restrict__ ac_inv;  // (nc², nc²)
  // b and x0 are not __restrict__: K5 rewrites them between its solves, and a
  // restricted const pointer may be read through the non-coherent cache
  const T* b;  // the prepared rhs
  const T* x0;
  T* x;
  T* r[2];  // double-buffered: a phase reads one at its neighbours, writes the other
  T* p[2];
  T* q;
  T* z;
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

// The operator the preconditioner's two applies (phases B and D) read.
template <typename T, typename A, typename Op, typename POp>
__device__ __forceinline__ const POp& precond_op(const PressureArgs<T, A, Op, POp>& a) {
  if constexpr (std::is_same_v<Op, POp>) return a.op;
  else return a.pop;
}

// v[k] of a two-copy buffer, k ∈ {0, 1}, without indexing the argument struct
template <typename P>
__device__ __forceinline__ P pick(P const (&v)[2], int k) { return k ? v[1] : v[0]; }

// Where the solve stands between phases: the scalars every block derived
// from the same reductions, and which copy of r and p is current.
template <typename T>
struct PressureState {
  T ww;           // act·act
  T alpha, cq;    // r ← r − α(q − cq·act)  (init: r ← r − cr·act, cr in cq)
  T coef, beta;   // p ← (z − coef·act) + β·p
  T rz, rr;
  int cur_r, cur_p;
  bool first;     // no p yet: p = z − coef·act
};

// The block's shared memory for K3's restriction.
template <typename T>
struct Scratch {
  T* slab;    // (kTile) a slab's t = r − K z1, then its row-block sums as float
  T* colacc;  // (kTile) the unit's row-block sums so far
};

// K3's tiles: units of `per` whole coarse aggregates along the lanes (at
// most kLanes lanes where blk ≤ kLanes) by one band of blk rows, walked a
// slab of slab_rows rows (at most kTile points) at a time.
struct Units {
  int blk, nc, per, chunks, slab_rows, count;
};

__device__ __forceinline__ Units make_units(int blk, int nc) {
  Units u;
  u.blk = blk;
  u.nc = nc;
  u.per = max(1, min(kLanes / blk, kTile / (blk * blk)));
  u.chunks = (nc + u.per - 1) / u.per;
  u.slab_rows = max(1, kTile / (u.per * blk));
  u.count = nc * u.chunks;
  return u;
}

// For each point of unit k: body(pt, iy, ix, (K·S)(iy, ix), S(iy, ix)), pt
// its index in the slab; after each slab, done(W, rows) (block-uniform,
// between two block barriers).  S(j, jy, jx) is the source function.
template <typename Op, typename S, typename B, typename E>
__device__ void apply_unit(const Op& op, const Units& u, int k, S src, B body, E done) {
  const int ns = op.ns;
  const int cr = k / u.chunks, cl0 = (k - cr * u.chunks) * u.per;
  const int y0 = cr * u.blk, y1 = min(ns, y0 + u.blk);
  const int x0 = cl0 * u.blk, W = min(ns, min(u.nc, cl0 + u.per) * u.blk) - x0;
  for (int ys = y0; ys < y1; ys += u.slab_rows) {
    const int rows = min(u.slab_rows, y1 - ys);
    for (int pt = threadIdx.x; pt < rows * W; pt += kThreads) {
      const int dy = pt / W;
      const int iy = ys + dy, ix = x0 + (pt - dy * W);
      body(pt, iy, ix, apply_yx<true>(op, iy, ix, src), src(iy * ns + ix, iy, ix));
    }
    __syncthreads();
    done(W, rows);
    __syncthreads();
  }
}

// Phase A: p = (z − coef·act) + β·p_old (into the other copy), q = K p;
// sums act·q, p·q, p·act.
template <typename T, typename A, typename... O>
__device__ void phase_a(const PressureArgs<T, A, O...>& a, const PressureState<T>& s, const Units& u,
                        T (&sums)[3]) {
  if constexpr (decltype(a.op)::kProbe == kExchange) return;
  const int ns = a.op.ns;
  const T* __restrict__ act = a.act;
  const T* z = a.z;
  const T* pold = pick(a.p, s.cur_p);
  T* pnew = pick(a.p, s.cur_p ^ 1);
  const T coef = s.coef, beta = s.beta;
  const bool first = s.first;
  auto p_at = [&](int j, int, int) -> T {
    const T zp = z[j] - coef * act[j];
    return first ? zp : zp + beta * pold[j];
  };
  for (int k = blockIdx.x; k < u.count; k += gridDim.x)
    apply_unit(a.op, u, k, p_at, [&](int, int iy, int ix, T qv, T pv) {
      const int i = iy * ns + ix;
      pnew[i] = pv;
      a.q[i] = qv;
      sums[0] += act[i] * qv;
      sums[1] += pv * qv;
      sums[2] += pv * act[i];
    }, [](int, int) {});
}

// Phase B (two-level) or the Jacobi phase: r ← r − α(q − cq·act) (read r_old
// at r[s.cur_r], written to the other copy), x += α·p unless `init`.
// Two-level: t = r − K z1 restricted into rc.  Jacobi: z = D⁻¹ r and the sums
// act·z, r·z, r·act, r·r into `sums`.
template <typename T, typename A, typename... O>
__device__ void update_r(const PressureArgs<T, A, O...>& a, const PressureState<T>& s, const Units& u,
                         const Scratch<T>& sm, bool init, T (&sums)[4]) {
  if constexpr (decltype(a.op)::kProbe == kExchange) return;
  const int ns = a.op.ns;
  const T* __restrict__ act = a.act;
  const T* __restrict__ invd = a.invd;
  const T* rold = pick(a.r, s.cur_r);
  T* rnew = pick(a.r, s.cur_r ^ 1);
  const T* q = a.q;
  const T* pn = pick(a.p, s.cur_p);
  const T alpha = s.alpha, cq = s.cq, omega = a.omega;
  // init: r = r_tmp − cr·act (q unused); else r − α(q − cq·act)
  auto r_at = [&](int j) -> T {
    return init ? rold[j] - cq * act[j] : rold[j] - alpha * (q[j] - cq * act[j]);
  };
  if (!a.use_coarse) {
    const int n = ns * ns;
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    for (int i = tid; i < n; i += gridDim.x * blockDim.x) {
      const T rv = r_at(i);
      rnew[i] = rv;
      if (!init) a.x[i] = a.x[i] + alpha * pn[i];
      const T zv = invd[i] * rv;
      a.z[i] = zv;
      sums[0] += act[i] * zv;
      sums[1] += rv * zv;
      sums[2] += rv * act[i];
      sums[3] += rv * rv;
    }
    return;
  }
  const int blk = u.blk, nc = u.nc;
  auto z1 = [&](int j, int, int) -> T { return omega * (invd[j] * r_at(j)); };
  for (int k = blockIdx.x; k < u.count; k += gridDim.x) {
    const int cr = k / u.chunks, cl0 = (k - cr * u.chunks) * u.per;
    const int n_agg = min(nc, cl0 + u.per) - cl0;
    for (int c = threadIdx.x; c < kTile; c += kThreads) sm.colacc[c] = T(0);
    __syncthreads();
    int width = 0;
    apply_unit(precond_op(a), u, k, z1, [&](int pt, int iy, int ix, T kz, T) {
      const int i = iy * ns + ix;
      const T rv = r_at(i);
      rnew[i] = rv;
      if (!init) a.x[i] = a.x[i] + alpha * pn[i];
      sm.slab[pt] = rv - kz;
    }, [&](int W, int rows) {
      width = W;
      for (int c = threadIdx.x; c < W; c += kThreads) {
        T acc = sm.colacc[c];  // row order, in the field's precision
        for (int r = 0; r < rows; ++r) acc += sm.slab[r * W + c];
        sm.colacc[c] = acc;
      }
    });
    float* r1 = reinterpret_cast<float*>(sm.slab);  // the slab is free now
    for (int c = threadIdx.x; c < width; c += kThreads) r1[c] = (float)sm.colacc[c];
    __syncthreads();
    for (int g = threadIdx.x; g < n_agg; g += kThreads) {
      const int xa = g * blk, xb = min(width, xa + blk);
      float acc = 0.f;  // float operands, float accumulation, lane order
      for (int xx = xa; xx < xb; ++xx) acc += r1[xx];
      a.rc[cr * nc + cl0 + g] = acc;
    }
    __syncthreads();
  }
}

// Phase C: zc = A_c⁻¹ rc, one warp a row of ac_inv.
template <typename T, typename A, typename... O>
__device__ void coarse_solve(const PressureArgs<T, A, O...>& a) {
  using Acc = typename CoarseAcc<A>::type;
  const int m = a.nc * a.nc;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  for (int row = tid >> 5; row < m; row += (gridDim.x * blockDim.x) >> 5) {
    Acc acc = Acc(0);
    for (int j = lane; j < m; j += 32)
      acc += coarse_val(a.ac_inv[(size_t)row * m + j]) * coarse_rhs<A>(a.rc[j]);
    acc = warp_reduce(acc, Add{});
    if (lane == 0) a.zc[row] = (float)acc;
  }
}

// Phase D: z = z2 + ω D⁻¹ (r − K z2), z2 = ω D⁻¹ r + zc[agg]·act at each
// source, r the current copy; sums act·z, r·z, r·act, r·r.
template <typename T, typename A, typename... O>
__device__ void smooth_z(const PressureArgs<T, A, O...>& a, const PressureState<T>& s, const Units& u,
                         T (&sums)[4]) {
  if constexpr (decltype(a.op)::kProbe == kExchange) return;
  const int ns = a.op.ns;
  const T* __restrict__ act = a.act;
  const T* __restrict__ invd = a.invd;
  const T* r = pick(a.r, s.cur_r);
  const float* zc = a.zc;
  const T omega = a.omega;
  const int blk = u.blk, nc = u.nc;
  const float inv_blk = 1.f / (float)blk;
  auto z2 = [&](int j, int jy, int jx) -> T {
    const T z1 = omega * (invd[j] * r[j]);
    return z1 + (T)zc[div_by(jy, blk, inv_blk) * nc + div_by(jx, blk, inv_blk)] * act[j];
  };
  for (int k = blockIdx.x; k < u.count; k += gridDim.x)
    apply_unit(precond_op(a), u, k, z2, [&](int, int iy, int ix, T kz, T z2i) {
      const int i = iy * ns + ix;
      const T rv = r[i];
      const T zv = z2i + omega * (invd[i] * (rv - kz));
      a.z[i] = zv;
      sums[0] += act[i] * zv;
      sums[1] += rv * zv;
      sums[2] += rv * act[i];
      sums[3] += rv * rv;
    }, [](int, int) {});
}

// z ← precond(r) after r's update (phases B–D, or the Jacobi phase); then
// coef, the new r·z' and r·r, where z' = z − coef·act.
template <typename T, typename A, typename... O>
__device__ void precond_update(const PressureArgs<T, A, O...>& a, cg::grid_group& grid, int& slot,
                               PressureState<T>& s, const Units& u, const Scratch<T>& sm,
                               bool init) {
  T sums[4] = {T(0), T(0), T(0), T(0)};
  update_r(a, s, u, sm, init, sums);
  s.cur_r ^= 1;
  if (a.use_coarse) {
    grid.sync();
    coarse_solve(a);
    grid.sync();
    smooth_z(a, s, u, sums);
  }
  reduce_grid(grid, sums, a.partials, slot);
  s.coef = sums[0] / s.ww;
  s.rz = sums[1] - s.coef * sums[2];
  s.rr = sums[3];
}

// K3's whole solve: b is the prepared rhs, x0 the masked warm start; the
// solution lands in x, projected.  No grid sync after the last write of x.
template <typename T, typename A, typename... O>
__device__ __forceinline__ void pressure_solve(const PressureArgs<T, A, O...>& a, cg::grid_group& grid,
                                               int& slot) {
  const int ns = a.op.ns, n = ns * ns;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const T* __restrict__ act = a.act;
  __shared__ T slab[kTile];
  __shared__ T colacc[kTile];
  const Scratch<T> sm{slab, colacc};
  const Units u = make_units(a.blk, a.nc);
  PressureState<T> s;

  // act·act and act·b; x = x0
  T s0[2] = {T(0), T(0)};
  for (int i = tid; i < n; i += stride) {
    const T ai = act[i];
    s0[0] += ai * ai;
    s0[1] += ai * a.b[i];
    a.x[i] = a.x0[i];
  }
  reduce_grid(grid, s0, a.partials, slot);
  s.ww = s0[0];
  const T cb = s0[1] / s.ww;

  // b' = project(b); r = b' − K x0 (into r[0]); sums b'·b', act·r
  T s1[2] = {T(0), T(0)};
  for (int i = tid; i < n; i += stride) {
    const int iy = i / ns, ix = i - iy * ns;
    const T bp = a.b[i] - cb * act[i];
    const T* x0 = a.x0;
    const T rv = bp - apply_at(a.op, iy, ix, [&](int j) { return x0[j]; });
    a.r[0][i] = rv;
    s1[0] += bp * bp;
    s1[1] += act[i] * rv;
  }
  reduce_grid(grid, s1, a.partials, slot);
  const T tl = a.tol * tmax(tsqrt(s1[0]), T(1e-30));
  const T atol2 = tl * tl;
  s.cur_r = 0;
  s.cur_p = 0;
  s.alpha = T(1);
  s.cq = s1[1] / s.ww;  // r = r − cr·act, then z = precond(r)
  precond_update(a, grid, slot, s, u, sm, true);
  s.first = true;
  s.beta = T(0);

  int k = 0;
  while (k < a.iters && (a.tol <= T(0) || s.rr > atol2)) {
    // A: p = (z − coef·act) + β·p_old, q = K p; cq and α
    T s2[3] = {T(0), T(0), T(0)};
    phase_a(a, s, u, s2);
    reduce_grid(grid, s2, a.partials, slot);
    s.cur_p ^= 1;
    s.first = false;
    s.cq = s2[0] / s.ww;
    const T pq = s2[1] - s.cq * s2[2];  // p·(q − cq·act)
    s.alpha = pq != T(0) ? s.rz / pq : T(0);
    // B–D: r −= α(q − cq·act), x += α p, z = precond(r); coef, r·z', r·r
    const T rz = s.rz;
    precond_update(a, grid, slot, s, u, sm, false);
    s.beta = rz != T(0) ? s.rz / rz : T(0);
    ++k;
  }

  // x = project(x)
  T s4[1] = {T(0)};
  for (int i = tid; i < n; i += stride) s4[0] += act[i] * a.x[i];
  reduce_grid(grid, s4, a.partials, slot);
  const T cx = s4[0] / s.ww;
  for (int i = tid; i < n; i += stride) a.x[i] = a.x[i] - cx * act[i];
  if (tid == 0 && a.iters_out) *a.iters_out += k;  // adds: a run's total
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, typename P>
cudaError_t make_op(GridOp<T, P>& op, const P* diags, const int* rs, const int* ls, int n_off,
                    int ns, const int* rowptr, const int* lane, const int* src, const T* val,
                    int round_rest) {
  if (n_off < 1 || n_off > kMaxOffsets || ns < 1) return cudaErrorInvalidValue;
  op.diags = diags;
  op.rowptr = rowptr;
  op.lane = lane;
  op.src = src;
  op.val = val;
  op.n_off = n_off;
  op.ns = ns;
  op.round_rest = round_rest;
  for (int g = 0; g < n_off; ++g) {
    op.sh.rs[g] = rs[g];
    op.sh.ls[g] = ls[g];
  }
  return cudaSuccess;
}

// The coarse aggregation K3's tiles take: blocks of at most kTile lanes,
// covering the grid.
inline bool coarse_ok(int blk, int nc, int ns) {
  return blk >= 1 && blk <= kTile && nc >= 1 && (size_t)nc * blk >= (size_t)ns;
}

template <typename Args>
cudaError_t blocks_per_sm(void (*kernel)(Args), int* per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, 0);
}

// Launch `kernel` cooperatively on as many blocks as fit on the card at
// once (and no more than the points need, nor than kMaxBlocks, nor than
// `max_per_sm` a SM where it is given: a probe takes the real kernel's).
template <typename Args>
cudaError_t launch_coop(void (*kernel)(Args), Args& args, int n, cudaStream_t stream,
                        int max_per_sm = 0) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = blocks_per_sm(kernel, &per_sm)) != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  if (max_per_sm > 0 && max_per_sm < per_sm) per_sm = max_per_sm;
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
