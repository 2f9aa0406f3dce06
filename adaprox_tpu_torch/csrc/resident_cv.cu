// K7d and K7c for Hopper: whole Condat-Vu solves of the f = 0 composite family in one
// cooperative kernel launch,
//
//     min lam ||x||_1 + h(A x),   h = Translate(inner, -bv),   inner = NormL2 or NormL1,
//
// the square-root lasso (NormL2) and the least absolute deviation (NormL1) of
// experiments/square_root_lasso/runme.jl, with the fixed steps (gamma, sigma).
//
// Replaces the Pallas TPU kernel adaprox_tpu/ops/resident.py::resident_condat_vu
// (_cv_kernel[_rec] over _cv_core on _f0_ops). A is stored as f32 or bf16; every
// iterate, reduction and scalar is f32.
//
// K7c, the same kernel, replaces adaprox_tpu/ops/resident.py::resident_cv_grid
// (_cv_grid_kernel_rec over _cv_core): the same solve for each of D datasets zero-padded
// to one common (m, n) (A (D, m, n), bv (D, m); each its own lam, gamma and sigma), one
// launch for all D. K7d is its launch at D = 1.
//
// The iteration (_cv_core, the engine's order with FixedStepsize, rho = 1, f = 0):
//     a_x    = A x
//     primal = (v - x) / gamma + A'y_prev
//     w      = y_prev + sigma (2 a_x - a_x_prev)
//     y      = prox_{sigma h*}(w) = w - sigma (p + bv),  p = prox_{inner / sigma}(w / sigma - bv)
//     dual   = (w - y) / sigma - a_x;   norm_res = sqrt(||primal||^2 + ||dual||^2)
//     v = x - gamma A'y;  x' = soft(v, gamma lam)
// The record row (before the second half): norm_res and the objective lam ||x||_1 +
// h(a_x) at the iteration's x. On convergence the x of the check is returned, not the
// extra prox step. From x0 = 0, y0 = 0: A x0 = 0 and A'y0 = 0, so the warm-up is
// elementwise.
//
// What bounds it on the card. A and A' are read from device memory once (4 MB each at
// cpusmall_scale's 8192 x 128 f32) and then stay in the 50 MB L2; an iteration does
// 4 m n flops (0.06 us at 8192 x 128 on 67 TFLOP/s of f32 outside the tensor cores).
// So the grid-wide barriers and the phases' latency set the pace, as for K6: two
// barriers an iteration with NormL1, three with NormL2.
//
// Design (first, simple version; resident_f0.cuh has the block dot, the dual prox
// pieces and the launch, which K7a/K7b's cores share):
//   * One persistent cooperative launch, at most one CTA per SM, enough warps for the
//     longer of m and n (housing_scale's 512 x 128 takes 32 CTAs of 16 warps). A, A',
//     bv and every vector stay in global memory, so any shape runs.
//   * P1, one warp a row i of A: a_x_i = A_i . x (16-byte loads, n = 128 is one load a
//     lane); lane 0 forms w_i, keeps a_x_i, and adds to this CTA's partials of the
//     objective's h term; NormL1: y_i and the dual residual's partial at once; NormL2:
//     w_i and the partial of ||z||^2. The threads of the grid also add the primal
//     residual's and ||x||_1's partials, elementwise over n. A grid sync.
//   * NormL2 only: every CTA sums the partials of ||z||^2 in one fixed order (no
//     atomics) and so gets the same block scale; then elementwise y_i and the dual
//     residual's partial. A grid sync. (The global norm inside the iteration is what
//     costs NormL2 its third barrier.)
//   * The step: every CTA sums the partials in the same fixed order (warp k sums
//     partial k over the CTAs), so every CTA takes the same norm_res and the same stop
//     decision (else a barrier deadlocks). Then P2, one CTA a row j of A': at_y_j =
//     A'_j . y by all 512 threads (16-byte loads, a fixed-order block reduce), and
//     thread 0 forms v_j and x'_j. A grid sync, unless the solve stops.
//   * Every partial is written after the barrier that ends the last read of its slot:
//     P1's after the previous iteration's last barrier, the NormL2 dual residual's
//     (its own slot) after the first.
//   * IEEE semantics as K2 and K6 (no fast math, IEEE division and square root,
//     NaN-propagating max like jnp.maximum, jnp.sign's signed zero; -fmad=false, so each
//     elementwise expression rounds after every operation as the plain PyTorch version
//     does; the dot products use explicit fmaf).

#include "resident_f0.cuh"

namespace {

// Per-CTA partial sums: part[k * grid + cta]. kDual2 is last: with NormL2 the dual
// phase writes it after the first barrier, when the others may still be read.
enum CvPart { kPrimal2 = 0, kZ2, kAbsX, kHVal, kDual2, kCvParts };

// The solve's scalars and outputs.
struct CvArgs {
  float gamma, sigma, tol;
  int maxit, record;
  float* x_out;  // (n,)
  float* stats;  // (3,): numit, norm_res, converged
  float* hist;   // (2, hist_len): norm_res, the objective; zero past numit
};

// One whole Condat-Vu solve (_cv_core), run by every thread of the grid, once a dataset.
// p and r come by value: each thread's own copy of the dataset's problem (which the
// kernel keeps in shared memory) lets the compiler hold them in registers; read by
// reference from shared memory, the iteration ran 2-7% slower.
template <typename T, int V>
__device__ void cv_solve(const F0Problem p, const CvArgs r) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float warp_part[kCvParts][kWarps];
  __shared__ float s_red[kWarps];
  __shared__ float s_sum[kCvParts];
  __shared__ float s_scale;
  __shared__ int s_go, s_conv, s_numit;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * kThreads;
  const long long gwarp = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  const long long m = p.m, n = p.n;
  const long long hl = p.hist_len;
  const bool l1 = p.h_kind == kHL1;
  const float gamma = r.gamma, sigma = r.sigma;
  const T* __restrict__ a = static_cast<const T*>(p.a);
  const T* __restrict__ at = static_cast<const T*>(p.at);
  const float* __restrict__ bv = p.bv;
  // the partials P1 writes: all five with NormL1, all but the dual residual's with NormL2
  const int p1_parts = l1 ? kCvParts : kDual2;

  // warm-up (_cv_core :1585-1590): x0 = 0, y0 = 0, so A x0 = 0, A'y0 = 0,
  // v = x0 - gamma A'y0, x = soft(v, gamma lam)
  for (long long j = gtid; j < n; j += nthreads) {
    const float vj = 0.f - gamma * 0.f;
    p.v[j] = vj;
    p.at_y[j] = 0.f;
    p.xs[j] = soft(vj, gamma * p.lam);
  }
  for (long long i = gtid; i < m; i += nthreads) {
    p.y[i] = 0.f;
    p.ax[i] = 0.f;
  }
  grid.sync();

  // the carry: thread 0 of every CTA holds it, the same bits in every CTA
  float norm_res = f32_inf();
  int it = 0;
  int par = 0;  // x = xs[par]; the next x goes to xs[1 - par]
  bool go = 0 < r.maxit && norm_res > r.tol;
  bool conv = norm_res <= r.tol;
  if (!go) {
    for (long long j = gtid; j < n; j += nthreads) r.x_out[j] = p.xs[j];
  }

  while (go) {
    const float* x = p.xs + par * n;
    float acc[kCvParts] = {};
    // P1: a_x_i a warp a row; lane 0 the dual step's first half and the h term
    for (long long i = gwarp; i < m; i += nwarps) {
      const float axi = warp_dot<T, V>(a + i * n, x, n, lane);
      if (lane == 0) {
        const float b = bv[i];
        const float w = p.y[i] + sigma * (2.f * axi - p.ax[i]);  // rho = 1
        p.ax[i] = axi;
        const float z = dual_z(w, sigma, b);
        if (l1) {
          const float yi = dual_y(w, sigma, b, soft(z, 1.f / sigma));
          p.y[i] = yi;
          const float d = (w - yi) / sigma - axi;
          acc[kDual2] += d * d;
        } else {
          p.w[i] = w;
          acc[kZ2] += z * z;
        }
        const float diff = axi - b;
        acc[kHVal] += l1 ? fabsf(diff) : diff * diff;
      }
    }
    // the primal residual and ||x||_1, elementwise
    for (long long j = gtid; j < n; j += nthreads) {
      const float xj = x[j];
      const float pr = (p.v[j] - xj) / gamma + p.at_y[j];
      acc[kPrimal2] += pr * pr;
      acc[kAbsX] += fabsf(xj);
    }
#pragma unroll
    for (int k = 0; k < kCvParts; ++k) {
      const float s = warp_sum(acc[k]);
      if (lane == 0) warp_part[k][warp] = s;
    }
    write_partials(warp_part, p.part, 0, p1_parts);
    grid.sync();

    // P1's sums: warp k sums partial k over the CTAs, the same order in every CTA
    if (warp < p1_parts) {
      const float total = sum_part(p.part, warp, lane);
      if (lane == 0) s_sum[warp] = total;
    }
    __syncthreads();
    if (!l1) {
      // NormL2: the block scale from ||z||, then y and the dual residual elementwise
      if (threadIdx.x == 0) s_scale = l2_scale(s_sum[kZ2], sigma);
      __syncthreads();
      const float scale = s_scale;
      float dacc = 0.f;
      for (long long i = gtid; i < m; i += nthreads) {
        const float w = p.w[i];
        const float b = bv[i];
        const float yi = dual_y(w, sigma, b, scale * dual_z(w, sigma, b));
        p.y[i] = yi;
        const float d = (w - yi) / sigma - p.ax[i];
        dacc += d * d;
      }
      dacc = warp_sum(dacc);
      if (lane == 0) warp_part[kDual2][warp] = dacc;
      write_partials(warp_part, p.part, kDual2, kDual2 + 1);
      grid.sync();
      if (warp == 0) {
        const float total = sum_part(p.part, kDual2, lane);
        if (lane == 0) s_sum[kDual2] = total;
      }
      __syncthreads();
    }

    // the step: thread 0 of every CTA, from the same sums
    if (threadIdx.x == 0) {
      norm_res = sqrtf(s_sum[kPrimal2] + s_sum[kDual2]);
      if (r.record && blockIdx.x == 0) {
        r.hist[it] = norm_res;
        const float h = l1 ? s_sum[kHVal] : sqrtf(s_sum[kHVal]);
        r.hist[hl + it] = p.lam * s_sum[kAbsX] + h;
      }
      ++it;
      s_go = it < r.maxit && norm_res > r.tol;  // a NaN residual stops
      s_conv = norm_res <= r.tol;
    }
    __syncthreads();
    go = s_go != 0;
    conv = s_conv != 0;

    // P2: at_y_j a CTA a row of A'; thread 0 the next point
    float* x_new = p.xs + (1 - par) * n;
    for (long long j = blockIdx.x; j < n; j += gridDim.x) {
      const float aty = block_dot<T, V>(at + j * m, p.y, m, s_red);
      if (threadIdx.x == 0) {
        p.at_y[j] = aty;
        const float xj = x[j];
        const float vj = xj - gamma * aty;
        p.v[j] = vj;
        const float xn = soft(vj, gamma * p.lam);
        x_new[j] = xn;
        // converged: the iterate at the check, not the extra prox step
        if (!go) r.x_out[j] = conv ? xj : xn;
      }
    }
    if (go) grid.sync();
    par ^= 1;
  }

  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) {
      r.stats[0] = static_cast<float>(it);
      r.stats[1] = norm_res;
      r.stats[2] = conv ? 1.f : 0.f;
    }
    if (r.record) {
      // histories are zero past numit; thread 0's it is every thread's
      if (threadIdx.x == 0) s_numit = it;
      __syncthreads();
      for (long long i = s_numit + threadIdx.x; i < hl; i += kThreads) {
        r.hist[i] = 0.f;
        r.hist[hl + i] = 0.f;
      }
    }
  }
}

// The per-dataset entries of JAX's (D, 4) scalar table [gamma, sigma, lam, tol]; tol
// and the rest come in CvArgs.
struct CvSets {
  const float* gammas;  // (D,) on the device
  const float* sigmas;  // (D,)
  const float* lams;    // (D,)
  int dcount;
};

// The datasets one after another, a grid sync between two (the next solve reuses the
// scratch that other CTAs may still read). Each solve's problem and arguments are copies
// in shared memory with its dataset's a, at and bv slices (64-bit offsets), lam, gamma,
// sigma and outputs, written by thread 0 from the device tables and published by the
// block barrier. So each dataset's solve equals the D = 1 launch on its slice bit for
// bit.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1) resident_cv_grid_kernel(const F0Problem p,
                                                                      const CvArgs r,
                                                                      const CvSets g) {
  __shared__ F0Problem cp;
  __shared__ CvArgs cr;
  const long long mn = p.m * p.n;
  for (int i = 0; i < g.dcount; ++i) {
    // also a block barrier: every thread is done with the previous solve's cp and cr
    if (i > 0) cg::this_grid().sync();
    if (threadIdx.x == 0) {
      const long long d = i;
      cp = p;
      cp.a = static_cast<const T*>(p.a) + d * mn;
      cp.at = static_cast<const T*>(p.at) + d * mn;
      cp.bv = p.bv + d * p.m;
      cp.lam = g.lams[d];
      cr = r;
      cr.gamma = g.gammas[d];
      cr.sigma = g.sigmas[d];
      cr.x_out = r.x_out + d * p.n;
      cr.stats = r.stats + 3 * d;
      cr.hist = r.hist ? r.hist + 2 * d * p.hist_len : nullptr;
    }
    __syncthreads();
    cv_solve<T, V>(cp, cr);
  }
}

ADAPROX_PICK_F0(resident_cv_grid_kernel)

}  // namespace

extern "C" {

// The partials a CTA needs: part holds this many floats for each CTA of the grid.
int adaprox_resident_f0_parts() { return kCvParts; }

// K7c, and K7d at dcount 1: dcount Condat-Vu solves, one a dataset. a (dcount, m, n) and
// at (dcount, n, m) row-major, f32 (a_is_bf16 = 0) or bf16; vec: 1, or 4 (f32) / 8
// (bf16) when m and n are multiples of it and a and at are 16-byte aligned. bv (dcount, m);
// lams, gammas and sigmas (dcount) on the device. xs (2, n), v (n), at_y (n), y (m), ax
// (m), w (m), part (part_len): f32 device buffers the caller owns. h_kind: 0 NormL2, 1
// NormL1. x_out (dcount, n); stats (dcount, 3): numit, norm_res, converged; hist (dcount,
// 2, hist_len), hist_len = maxit rounded up to 128: norm_res and the objective, zero past
// numit (read only when record). Returns the cudaError_t of the launch (0 on success).
int adaprox_resident_cv_grid(const void* a, const void* at, int a_is_bf16, int vec, long long m,
                             long long n, const float* bv, int h_kind, const float* lams,
                             const float* gammas, const float* sigmas, int dcount, float* xs,
                             float* v, float* at_y, float* y, float* ax, float* w, float* part,
                             long long part_len, float tol, int maxit, int record,
                             float* x_out, float* stats, float* hist, void* stream_ptr) {
  const void* kernel = pick_resident_cv_grid_kernel(a_is_bf16, vec);
  if (kernel == nullptr || !lams || !gammas || !sigmas || m < 1 || n < 1 ||
      (h_kind != kHL2 && h_kind != kHL1) || dcount < 1 || maxit < 0 || !x_out || !stats ||
      (record && maxit > 0 && !hist)) {
    return cudaErrorInvalidValue;
  }
  const int hist_len = (maxit + 127) / 128 * 128;  // _hist_len(maxit)
  // lam, gamma, sigma and the outputs are each dataset's; the launch's are placeholders
  F0Problem prob{a, at, bv, xs, v, at_y, y, ax, w, part, m, n, h_kind, 0.f, hist_len};
  CvArgs args{0.f, 0.f, tol, maxit, record, x_out, stats, record ? hist : nullptr};
  CvSets sets{gammas, sigmas, lams, dcount};
  void* kargs[] = {&prob, &args, &sets};
  return static_cast<int>(launch_f0(kernel, kargs, m, n, kCvParts, part_len, stream_ptr));
}

const char* adaprox_resident_cv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
