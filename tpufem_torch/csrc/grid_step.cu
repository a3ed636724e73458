// Kernel K5: the whole squirmer double-projection Stokes step on the grid
// storage (ring-in-grid or renumbered meshes, N = ns² nodes), K steps per
// launch.
//
// Replaces the TPU kernel GridStokesStep._step_fn
// (tpufem/solve/pallas_step.py:146; kernel :175, launch :375), which runs
//
//   viscous CG (x, then y) → BCs → div → pressure PCG → grad update → BCs →
//   div → second pressure PCG → interior-only grad update → final div →
//   metrics
//
// in one launch per K steps.  Per step, in this order:
//   1. viscous solve: warm-started Jacobi-CG on (m(I + dtν K)m + (1−m)I) u* =
//      u + dt·f for both columns in one pass (each plane read shared), each
//      column with its own stop test (tpufem solves x, then y, each exiting
//      on its own: pallas_step.py:246-289, 327-332); a column's arithmetic
//      is that of the sequential form.  The raw u* stays as the next warm
//      start;
//   2. BCs on u* into `stage`: periodic copy (slave ← master by a cyclic
//      shift along the pairing axis) → walls → inner squirmer values
//      (:305-316);
//   3. d = div(stage) through the Gdx/Gdy planes; max|d| is the step's
//      div_star_max;
//   4. two projections, each: the pressure rhs −d/dt times the lumped mass,
//      merged onto the masters and masked to the active dofs; K3's whole
//      pressure solve (grid_common.cuh, the two-level preconditioner and
//      constant deflation), warm-started from the previous step's p (resp.
//      p2); the slave copy-back (:291-300).  The first updates
//      stage ← BCs(stage − dt·G p) and takes d = div(stage); the second
//      u = stage − dt·G p2 on the interior nodes only (:349-350);
//   5. final_div_max = max|div u| and max_u = max|u|.
// The metrics are grid-wide max reductions, deterministic.  Rounding to
// float follows tpufem's (pallas_cg.py:388-392, :1362): apply_at rounds the
// remainder of every operator, Gdx/Gdy included, and K3 its restriction and
// coarse product.
//
// Design: one persistent cooperative launch per call, the way K2–K4 are
// built: grid-stride loops, a grid sync between dependent phases, every dot
// product a two-step reduction that every block finishes itself, so the
// early exits are uniform.  The arguments live in the kernel's parameter
// space (__grid_constant__), so the operators' shift tables are read there.
//
// What bounds it on an H100 (3.35 TB/s HBM, 50 MB L2): the bytes each
// phase moves, the operator planes streamed once per apply (evict-first).
// The pressure solves run K3's fused iteration (grid_common.cuh: 4 grid
// syncs and 17 vector passes an iteration, 137 MB and 0.041 ms at 1,048,576
// nodes on the card's 5-plane split, against 480 MB and 0.142 ms unfused on
// tpufem's 26 planes).  A viscous iteration reads the viscous planes once for
// both columns (as K2), a div or grad the Gdx/Gdy planes; those phases are
// not fused beyond the column pass.  All four operators take the card's
// split (GridOperator.dense_split), so the remainders are small everywhere
// and the lane search finds each point's entries (below 360k nodes and on
// renumbered meshes tpufem's split left ~560 entries on each periodic row,
// which the first version's row scan made every point read).

#include "grid_common.cuh"

namespace {

template <typename T, typename A>
struct StepArgs {
  GridOp<T> visc;           // K of the viscous solve
  GridOp<T> dx;             // Gdx: div's x part and grad's x component
  GridOp<T> dy;             // Gdy
  PressureArgs<T, A> pres;  // K3's solve on the rhs, warm-start and solution planes below
  const T* __restrict__ vmask;  // viscous interior mask
  const T* __restrict__ vinvd;  // viscous inverse diagonal
  const T* __restrict__ ml;     // lumped mass
  const T* __restrict__ mmask;  // periodic masters
  const T* __restrict__ smask;  // periodic slaves
  const T* __restrict__ wall;
  const T* __restrict__ inner;
  const T* __restrict__ ivx;  // squirmer values on the inner nodes
  const T* __restrict__ ivy;
  const T* __restrict__ int2;  // interior nodes of the second projection
  const T* __restrict__ u_in;  // (2, N) the state coming in
  const T* __restrict__ us_in;
  const T* __restrict__ p_in;
  const T* __restrict__ p2_in;
  T* u;  // (2, N) the state going out; the carries between steps
  T* us;
  T* p;
  T* p2;
  T* met;  // (steps, 3): div_star_max, final_div_max, max_u
  T* vr;   // (2, N) viscous CG work
  T* vp;
  T* vq;
  T* stage;  // (2, N) the velocity between the BCs and the next update
  T* d;      // (N) a divergence
  T* rhs;    // (N) the pressure solve's prepared rhs (pres.b)
  T* px0;    // (N) its masked warm start (pres.x0)
  T* px;     // (N) its solution (pres.x)
  T dt;
  T dt_nu;
  T bfx;  // dt·f
  T bfy;
  T ox;  // wall velocity
  T oy;
  T tol_v;
  int iters_v;
  int pair_axis;
  int n_steps;
  int* iters_v_out;
};

// NaN-propagating max, as jnp.max
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) { return (a > b || a != a) ? a : b; }

struct NanMax {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return nan_max(a, b); }
};

// The flat index `shift` grid points along the pairing axis, cyclic:
// +1 reaches a slave's master, −1 a master's slave.
__device__ __forceinline__ int along_pairs(int iy, int ix, int ns, int pair_axis, int shift) {
  if (pair_axis == 0) {
    int y = iy + shift;
    y += y < 0 ? ns : 0;
    y -= y >= ns ? ns : 0;
    return y * ns + ix;
  }
  int x = ix + shift;
  x += x < 0 ? ns : 0;
  x -= x >= ns ? ns : 0;
  return iy * ns + x;
}

// Column c of the BCs at point i of plane X (source of a slave: j):
// periodic copy → walls → inner.
template <typename T, typename A>
__device__ __forceinline__ T bcs_at(const StepArgs<T, A>& a, const T* X, int c, int i, int j) {
  const T s = a.smask[i];
  T v = X[i] * (T(1) - s) + (X[j] * a.mmask[j]) * s;
  const T w = a.wall[i];
  v = v * (T(1) - w) + w * (c ? a.oy : a.ox);
  const T m = a.inner[i];
  return v * (T(1) - m) + m * (c ? a.ivy : a.ivx)[i];
}

// div(X, Y) at one point, through the Gdx/Gdy planes
template <typename T, typename A>
__device__ __forceinline__ T div_at(const StepArgs<T, A>& a, const T* X, const T* Y, int iy,
                                    int ix) {
  return apply_at(a.dx, iy, ix, [&](int j) { return X[j]; }) +
         apply_at(a.dy, iy, ix, [&](int j) { return Y[j]; });
}

// u* ← the viscous solve of both columns from the warm start in u*, with
// right-hand side u + dt·f; each column stops on its own test.
template <typename T, typename A>
__device__ void viscous_solve(const StepArgs<T, A>& a, cg::grid_group& grid, int& slot) {
  const int ns = a.visc.ns, n = ns * ns;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const T dt_nu = a.dt_nu;

  // m·(X + dtν·K(m·X)) + (1−m)·X at point i of plane X
  auto mv = [&](const T* X, int i, int iy, int ix) -> T {
    const T* m = a.vmask;
    const T kx = apply_at(a.visc, iy, ix, [&](int j) { return m[j] * X[j]; });
    const T mi = m[i], xi = X[i];
    return mi * (xi + dt_nu * kx) + (T(1) - mi) * xi;
  };

  // r = b − A x0, p = z = D⁻¹ r; sums b·b, r·z, r·r per column
  T s0[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  for (int i = tid; i < n; i += stride) {
    const int iy = i / ns, ix = i - iy * ns;
    const T di = a.vinvd[i];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const T bv = a.u[c * n + i] + (c ? a.bfy : a.bfx);
      const T rv = bv - mv(a.us + c * n, i, iy, ix);
      const T zv = di * rv;
      a.vr[c * n + i] = rv;
      a.vp[c * n + i] = zv;
      s0[c] += bv * bv;
      s0[2 + c] += rv * zv;
      s0[4 + c] += rv * rv;
    }
  }
  reduce_grid(grid, s0, a.pres.partials, slot);
  T atol2[2], rz[2], rr[2];
  int k[2] = {0, 0};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const T t = a.tol_v * tmax(tsqrt(s0[c]), T(1e-30));
    atol2[c] = t * t;
    rz[c] = s0[2 + c];
    rr[c] = s0[4 + c];
  }

  for (;;) {
    bool live[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) live[c] = k[c] < a.iters_v && (a.tol_v <= T(0) || rr[c] > atol2[c]);
    if (!live[0] && !live[1]) break;

    // q = A p; sums p·q
    T s1[2] = {T(0), T(0)};
    for (int i = tid; i < n; i += stride) {
      const int iy = i / ns, ix = i - iy * ns;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (!live[c]) continue;
        const T qv = mv(a.vp + c * n, i, iy, ix);
        a.vq[c * n + i] = qv;
        s1[c] += a.vp[c * n + i] * qv;
      }
    }
    reduce_grid(grid, s1, a.pres.partials, slot);
    T alpha[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) alpha[c] = s1[c] != T(0) ? rz[c] / s1[c] : T(0);

    // x += αp, r −= αq, z = D⁻¹ r; sums r·z, r·r
    T s2[4] = {T(0), T(0), T(0), T(0)};
    for (int i = tid; i < n; i += stride) {
      const T di = a.vinvd[i];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (!live[c]) continue;
        const int e = c * n + i;
        a.us[e] = a.us[e] + alpha[c] * a.vp[e];
        const T rv = a.vr[e] - alpha[c] * a.vq[e];
        a.vr[e] = rv;
        const T zv = di * rv;
        s2[c] += rv * zv;
        s2[2 + c] += rv * rv;
      }
    }
    reduce_grid(grid, s2, a.pres.partials, slot);
    T beta[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      beta[c] = rz[c] != T(0) ? s2[c] / rz[c] : T(0);
      if (live[c]) {
        rz[c] = s2[c];
        rr[c] = s2[2 + c];
      }
    }

    // p = z + βp (each thread owns the points it updated above)
    for (int i = tid; i < n; i += stride) {
      const T di = a.vinvd[i];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (!live[c]) continue;
        const int e = c * n + i;
        a.vp[e] = di * a.vr[e] + beta[c] * a.vp[e];
      }
    }
    grid.sync();
#pragma unroll
    for (int c = 0; c < 2; ++c) k[c] += live[c] ? 1 : 0;
  }
  // the iterations of the two-column solve, as K2 counts them
  if (tid == 0 && a.iters_v_out) *a.iters_v_out += k[0] > k[1] ? k[0] : k[1];
}

// Blocks per SM that K5's register budget is set for (__launch_bounds__),
// as K3's: 64 registers a thread in f32 (warm steps at 1,048,576 nodes on an
// H100: 506 steps/s at 2 blocks per SM, 565 at 3, 653 at 4), 128 in f64.
template <typename T>
constexpr int kStepMinBlocks = sizeof(T) == 4 ? 4 : 2;

template <typename T, typename A>
__global__ void __launch_bounds__(kThreads, kStepMinBlocks<T>)
    grid_step_kernel(const __grid_constant__ StepArgs<T, A> a) {
  cg::grid_group grid = cg::this_grid();
  const int ns = a.visc.ns, n = ns * ns;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const T dt = a.dt;
  const T* act = a.pres.act;
  int slot = 0;

  for (int i = tid; i < 2 * n; i += stride) {
    a.u[i] = a.u_in[i];
    a.us[i] = a.us_in[i];
  }
  for (int i = tid; i < n; i += stride) {
    a.p[i] = a.p_in[i];
    a.p2[i] = a.p2_in[i];
  }
  grid.sync();

  for (int step = 0; step < a.n_steps; ++step) {
    // 1. u* (raw, kept as the next warm start)
    viscous_solve(a, grid, slot);

    // 2. stage = BCs(u*)
    for (int i = tid; i < n; i += stride) {
      const int iy = i / ns, ix = i - iy * ns;
      const int j = along_pairs(iy, ix, ns, a.pair_axis, 1);
#pragma unroll
      for (int c = 0; c < 2; ++c) a.stage[c * n + i] = bcs_at(a, a.us + c * n, c, i, j);
    }
    grid.sync();

    // 3. d = div(stage); div_star_max
    T m0[1] = {T(0)};
    for (int i = tid; i < n; i += stride) {
      const int iy = i / ns, ix = i - iy * ns;
      const T dv = div_at(a, a.stage, a.stage + n, iy, ix);
      a.d[i] = dv;
      m0[0] = nan_max(m0[0], dv < T(0) ? -dv : dv);
    }
    reduce_grid(grid, m0, a.pres.partials, slot, NanMax{});
    if (tid == 0) a.met[step * 3 + 0] = m0[0];

    // 4. the two projections
    for (int proj = 0; proj < 2; ++proj) {
      T* P = proj ? a.p2 : a.p;
      // rhs = act ⊙ merge(ml ⊙ (−d/dt)); warm start P ⊙ act
      for (int i = tid; i < n; i += stride) {
        const int iy = i / ns, ix = i - iy * ns;
        const int j = along_pairs(iy, ix, ns, a.pair_axis, -1);
        const T ri = a.ml[i] * (-a.d[i] / dt);
        const T rj = a.ml[j] * (-a.d[j] / dt);
        a.rhs[i] = (ri + (rj * a.smask[j]) * a.mmask[i]) * act[i];
        a.px0[i] = P[i] * act[i];
      }
      grid.sync();
      pressure_solve(a.pres, grid, slot);
      grid.sync();
      // P = the solution with the slaves copied from their masters
      for (int i = tid; i < n; i += stride) {
        const int iy = i / ns, ix = i - iy * ns;
        const int j = along_pairs(iy, ix, ns, a.pair_axis, 1);
        const T s = a.smask[i];
        P[i] = a.px[i] * (T(1) - s) + (a.px[j] * a.mmask[j]) * s;
      }
      grid.sync();
      if (proj == 0) {
        // u = stage − dt·G p, then stage = BCs(u), d = div(stage)
        for (int i = tid; i < n; i += stride) {
          const int iy = i / ns, ix = i - iy * ns;
          a.u[i] = a.stage[i] - dt * apply_at(a.dx, iy, ix, [&](int j) { return P[j]; });
          a.u[n + i] = a.stage[n + i] - dt * apply_at(a.dy, iy, ix, [&](int j) { return P[j]; });
        }
        grid.sync();
        for (int i = tid; i < n; i += stride) {
          const int iy = i / ns, ix = i - iy * ns;
          const int j = along_pairs(iy, ix, ns, a.pair_axis, 1);
#pragma unroll
          for (int c = 0; c < 2; ++c) a.stage[c * n + i] = bcs_at(a, a.u + c * n, c, i, j);
        }
        grid.sync();
        for (int i = tid; i < n; i += stride) {
          const int iy = i / ns, ix = i - iy * ns;
          a.d[i] = div_at(a, a.stage, a.stage + n, iy, ix);
        }
        grid.sync();
      } else {
        // u = stage − (dt·G p2) ⊙ interior2
        for (int i = tid; i < n; i += stride) {
          const int iy = i / ns, ix = i - iy * ns;
          const T w = a.int2[i];
          a.u[i] = a.stage[i] - (dt * apply_at(a.dx, iy, ix, [&](int j) { return P[j]; })) * w;
          a.u[n + i] =
              a.stage[n + i] - (dt * apply_at(a.dy, iy, ix, [&](int j) { return P[j]; })) * w;
        }
        grid.sync();
      }
    }

    // 5. final_div_max, max_u
    T m1[2] = {T(0), T(0)};
    for (int i = tid; i < n; i += stride) {
      const int iy = i / ns, ix = i - iy * ns;
      const T dv = div_at(a, a.u, a.u + n, iy, ix);
      m1[0] = nan_max(m1[0], dv < T(0) ? -dv : dv);
      const T ux = a.u[i], uy = a.u[n + i];
      m1[1] = nan_max(m1[1], nan_max(ux < T(0) ? -ux : ux, uy < T(0) ? -uy : uy));
    }
    reduce_grid(grid, m1, a.pres.partials, slot, NanMax{});
    if (tid == 0) {
      a.met[step * 3 + 1] = m1[0];
      a.met[step * 3 + 2] = m1[1];
    }
  }
}

#define OP_PARAMS(T, P)                                                            \
  const T *P##diags, const int *P##rs, const int *P##ls, int P##noff, int P##ns, \
      const int *P##rowptr, const int *P##lane, const int *P##src, const T *P##val, \
      int P##round
#define OP_ARGS(P) \
  P##diags, P##rs, P##ls, P##noff, P##ns, P##rowptr, P##lane, P##src, P##val, P##round

template <typename T, typename A>
int grid_step(OP_PARAMS(T, v_), OP_PARAMS(T, p_), OP_PARAMS(T, dx_), OP_PARAMS(T, dy_),
              const T* vmask, const T* vinvd, const T* ml, const T* act, const T* mmask,
              const T* smask, const T* pinvd, const A* ac_inv, int blk, int nc, int use_coarse,
              const T* wall,
              const T* inner, const T* ivx, const T* ivy, const T* int2, const T* u_in,
              const T* us_in, const T* p_in, const T* p2_in, T* u, T* us, T* p, T* p2, T* met,
              T* work, float* fwork, double dt, double dt_nu, double bfx, double bfy, double ox,
              double oy, double omega, int iters_v, double tol_v, int iters_p, double tol_p,
              int pair_axis, int n_steps, int* iters_v_out, int* iters_p_out, void* stream) {
  StepArgs<T, A> a;
  cudaError_t err;
  if ((err = make_op(a.visc, OP_ARGS(v_))) != cudaSuccess) return (int)err;
  if ((err = make_op(a.pres.op, OP_ARGS(p_))) != cudaSuccess) return (int)err;
  if ((err = make_op(a.dx, OP_ARGS(dx_))) != cudaSuccess) return (int)err;
  if ((err = make_op(a.dy, OP_ARGS(dy_))) != cudaSuccess) return (int)err;
  const int ns = v_ns;
  if (p_ns != ns || dx_ns != ns || dy_ns != ns || n_steps < 1 || (pair_axis & ~1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (!coarse_ok(blk, nc, ns)) {  // K3's tiles are its aggregates, with or without the coarse level
    return (int)cudaErrorInvalidValue;
  }
  const size_t n = (size_t)ns * ns;
  PressureArgs<T, A>& pr = a.pres;
  pr.act = act;
  pr.invd = pinvd;
  pr.ac_inv = ac_inv;
  pr.r[0] = work;
  pr.r[1] = work + n;
  pr.p[0] = work + 2 * n;
  pr.p[1] = work + 3 * n;
  pr.q = work + 4 * n;
  pr.z = work + 5 * n;
  a.rhs = work + 6 * n;
  a.px0 = work + 7 * n;
  a.px = work + 8 * n;
  pr.b = a.rhs;
  pr.x0 = a.px0;
  pr.x = a.px;
  a.vr = work + 9 * n;
  a.vp = work + 11 * n;
  a.vq = work + 13 * n;
  a.stage = work + 15 * n;
  a.d = work + 17 * n;
  pr.partials = work + 18 * n;
  pr.rc = fwork;
  pr.zc = fwork + (size_t)nc * nc;
  pr.omega = (T)omega;
  pr.tol = (T)tol_p;
  pr.blk = blk;
  pr.nc = nc;
  pr.use_coarse = use_coarse;
  pr.iters = iters_p;
  pr.iters_out = iters_p_out;
  a.vmask = vmask;
  a.vinvd = vinvd;
  a.ml = ml;
  a.mmask = mmask;
  a.smask = smask;
  a.wall = wall;
  a.inner = inner;
  a.ivx = ivx;
  a.ivy = ivy;
  a.int2 = int2;
  a.u_in = u_in;
  a.us_in = us_in;
  a.p_in = p_in;
  a.p2_in = p2_in;
  a.u = u;
  a.us = us;
  a.p = p;
  a.p2 = p2;
  a.met = met;
  a.dt = (T)dt;
  a.dt_nu = (T)dt_nu;
  a.bfx = (T)bfx;
  a.bfy = (T)bfy;
  a.ox = (T)ox;
  a.oy = (T)oy;
  a.tol_v = (T)tol_v;
  a.iters_v = iters_v;
  a.pair_axis = pair_axis;
  a.n_steps = n_steps;
  a.iters_v_out = iters_v_out;
  return (int)launch_coop(grid_step_kernel<T, A>, a, (int)n, (cudaStream_t)stream);
}

}  // namespace

#define STEP_ENTRY(NAME, T, A)                                                                 \
  extern "C" int NAME(OP_PARAMS(T, v_), OP_PARAMS(T, p_), OP_PARAMS(T, dx_),                  \
                      OP_PARAMS(T, dy_),                                                       \
                      const T* vmask, const T* vinvd, const T* ml, const T* act,               \
                      const T* mmask, const T* smask, const T* pinvd, const A* ac_inv, int blk, \
                      int nc, int use_coarse, const T* wall, const T* inner, const T* ivx,     \
                      const T* ivy, const T* int2, const T* u_in, const T* us_in,              \
                      const T* p_in, const T* p2_in, T* u, T* us, T* p, T* p2, T* met,         \
                      T* work, float* fwork, double dt, double dt_nu, double bfx, double bfy,  \
                      double ox, double oy, double omega, int iters_v, double tol_v,           \
                      int iters_p, double tol_p, int pair_axis, int n_steps, int* iters_v_out, \
                      int* iters_p_out, void* stream) {                                        \
    return grid_step<T, A>(OP_ARGS(v_), OP_ARGS(p_), OP_ARGS(dx_), OP_ARGS(dy_), vmask, vinvd, \
                           ml, act, mmask, smask, pinvd, ac_inv, blk, nc, use_coarse, wall,     \
                           inner, ivx, ivy, int2, u_in, us_in, p_in, p2_in, u, us, p, p2, met, \
                           work, fwork, dt, dt_nu, bfx, bfy, ox, oy, omega, iters_v, tol_v,    \
                           iters_p, tol_p, pair_axis, n_steps, iters_v_out, iters_p_out,       \
                           stream);                                                            \
  }

STEP_ENTRY(grid_step_f32, float, float)
STEP_ENTRY(grid_step_f32_bf16, float, __nv_bfloat16)
STEP_ENTRY(grid_step_f64, double, double)
STEP_ENTRY(grid_step_f64_bf16, double, __nv_bfloat16)

// Blocks per SM of each instance, in the order f32, f32 with a bf16 coarse
// inverse, f64, f64 bf16: writes `cap` of them, returns the count.
extern "C" int grid_step_blocks_per_sm(int* out, int cap) {
  int v[4] = {0};
  blocks_per_sm(grid_step_kernel<float, float>, &v[0]);
  blocks_per_sm(grid_step_kernel<float, __nv_bfloat16>, &v[1]);
  blocks_per_sm(grid_step_kernel<double, double>, &v[2]);
  blocks_per_sm(grid_step_kernel<double, __nv_bfloat16>, &v[3]);
  for (int i = 0; i < 4 && i < cap; ++i) out[i] = v[i];
  return 4;
}
