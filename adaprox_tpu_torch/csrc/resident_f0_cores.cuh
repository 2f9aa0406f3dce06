// The solve routines of the f = 0 composite family's linesearch cores, run by K7a (the
// t-sweep) and K7b (the dataset x t grid), both one kernel in resident_f0_grid.cu: one
// whole early-exit Malitsky-Pock solve (mp_solve, JAX's _mpls_core) or AdaPDM+ solve
// (adapdmp_solve, _adapdmp_core) run by every thread of a cooperative grid, the problem,
// the row's scalars and its outputs handed in by the caller,
//
//     min lam ||x||_1 + h(A x),   h = Translate(inner, -bv),   inner = NormL2 or NormL1.
//
// A is stored as f32 or bf16; every iterate, reduction and scalar is f32.
//
// The Malitsky-Pock core (_mpls_core), from x0 = 0, y0 = 0 (A x0 = 0, A'y0 = 0):
//     w = y + sigma a_x;  y = prox_{sigma h*}(w);  at_y = A'y;  s = sigma sqrt(2)
//     trial: theta = s / sigma_prev, gamma = t t s,
//            v = x_prev - gamma ((1 + theta) at_y - theta at_y_prev),  x = soft(v, gamma lam)
//            a_x = A x;  lhs = gamma s ||a_x - a_x_prev||^2
//     halve s while lhs > 0.95 ||x - x_prev||^2 and fewer than 101 trials ran (a test still
//     failing at the cap is latched into ls_failed);
//     norm_res = sqrt(||(v - x)/gamma + at_y||^2 + ||(w - y)/sigma_prev - a_x||^2)
// The record row: gamma, s, norm_res, trials, lam ||x||_1 + h(a_x). x returned is the
// last accepted trial's (final.x).
//
// The AdaPDM+ core (_adapdmp_core, big_delta = 0 as f = 0), from x0 = 0, y0 = 0,
// gamma0 = 1 / (2 Theta t eta0), x1 = soft(-gamma0 A'y0, gamma0 lam):
//     a_x = A x;  primal = (v - x)/gamma + at_y;  xi = t gamma eta delta1
//     trial at e (0.95 eta, then doubled): gamma' = min(gamma sqrt(1 + gamma/gamma_prev),
//            1/(2 Theta t e), gamma sqrt((1 - 4 xi^2) / (2 delta1 sqrt((1 - 4 xi^2)(t e gamma)^2))))
//            rho = gamma'/gamma, sigma = t t gamma', w = y + sigma((1 + rho) a_x - rho a_x_prev)
//            y' = prox_{sigma h*}(w), at_y' = A'y'
//     accept when e >= sqrt(||at_y' - at_y||^2) / sqrt(||y' - y||^2) (0/0 fails), at most
//     101 trials; norm_res = sqrt(||primal||^2 + ||(w - y')/sigma - a_x||^2)
//     v = x - gamma' at_y';  x' = soft(v, gamma' lam)
// The record row: gamma', sigma, norm_res, trials, lam ||x||_1 + h(a_x) at the
// iteration's x; on convergence the x of the check is returned.
//
// What bounds it on the card. A and A' are read from device memory once (4 MB each at
// cpusmall_scale's 8192 x 128 f32) and then stay in the 50 MB L2; an MP trial or an
// AdaPDM+ trial does 2 m n flops, an iteration 4 m n at one trial (0.06 us at 8192 x
// 128 on 67 TFLOP/s of f32 outside the tensor cores). So, as for K7d, the grid-wide
// barriers and the phases' latency set the pace.
//
// Design (first, simple version, on K7d's pieces in resident_f0.cuh):
//   * A solve runs on a persistent cooperative grid (launch_f0: at most one CTA per SM,
//     enough warps for the longer of m and n). A, A', bv and every vector stay in
//     global memory, so any shape runs.
//   * The phases, each ended by a grid sync: D (the dual step, elementwise over m; with
//     NormL2 a second phase takes the block scale from ||z||^2 over all m), P1 (A x, a
//     warp a row of A), P2 (A'y, a CTA a row of A', as K7d), T (MP's trial x,
//     elementwise over n).
//       MP, an iteration:      D [D2] | P2 + the first trial's x | P1 | (T | P1) a further trial
//       AdaPDM+, an iteration: P1 + the first trial's D | [D2] | P2 + the candidate x' |
//                              (D | [D2] | P2) a further trial
//     So an iteration at one trial waits at 3 grid syncs (MP) or 2 (AdaPDM+) with NormL1,
//     4 or 3 with NormL2, and each further trial at 2 (3 for AdaPDM+ with NormL2).
//   * The decisions: warp k of every CTA sums partial k over the CTAs in one fixed order
//     (no atomics), so every thread takes the accept, halve/inflate or cap decision, and
//     the stop decision, from the same bits; a CTA that decided otherwise would wait at a
//     barrier the others never reach. NaN compares false, as in jnp.
//   * Every partial is written in a phase that ends in a grid sync and read right after
//     that sync, before the next one; no slot is written again until a further sync has
//     passed, so one slot set does.
//   * x, A'y and (AdaPDM+) y are two buffers each, swapped by parity on acceptance, and A
//     x alternates by iteration: no copies.
//   * IEEE semantics as K7d (no fast math, IEEE division and square root, NaN-propagating
//     min/max like jnp.minimum / jnp.maximum, jnp.sign's signed zero; -fmad=false, so each
//     elementwise expression rounds after every operation as the plain PyTorch version
//     does; the dot products use explicit fmaf).
//
// Every function is deterministic: one fixed order of every sum, no atomics, so a solve
// gives the same bits whichever launch runs it on a grid of the same size.

#pragma once

#include "resident_f0.cuh"

namespace {

// The cores (the entries' argument; each picks its own kernel).
enum Core { kCoreMp = 0, kCoreAdapdmp = 1 };
// the initial trial and up to 100 halvings or inflations (the engines' _MAX_TRIALS = 100)
constexpr int kMaxTrials = 101;
// AdaPDM+'s constants as the JAX core rounds them: Python doubles, then the f32 of the
// iterates (1 + 1e-8 rounds to 1)
constexpr double kDelta = 1e-8, kThetaBig = 1.2;
constexpr float kRUp = 2.f, kRDown = 0.95f;

// Per-CTA partial sums: part[k * grid + cta]. kZ2: ||z||^2 of NormL2's dual prox; the
// rest by phase: MP's P1 writes [kPrimal2, kDax2], AdaPDM+'s P1 [kZ2, kHVal] and its P2
// [kDual2, kDaty2].
enum SwPart { kZ2 = 0, kPrimal2, kAbsX, kHVal, kDual2, kDy2, kDaty2, kDx2, kDax2, kSwParts };

// The problem and the scratch of a launch; each cell's copy has its dataset's a, at, bv
// and lam. Every vector is f32.
struct SwProblem {
  const void* a;    // (m, n) row-major, f32 or bf16
  const void* at;   // (n, m) row-major: the same values transposed
  const float* bv;  // (m,)
  float* xs;        // (2, n): x by parity (MP: x_prev and the trial x; AdaPDM+: x and x')
  float* v;         // (n,): the pre-prox point
  float* at_ys;     // (2, n): A'y by parity
  float* ys;        // (2, m): AdaPDM+: y and the trial y' by parity; MP: y in ys[0]
  float* axs;       // (2, m): A x by parity
  float* w;         // (m,): the dual pre-prox point
  float* part;      // (kSwParts, grid)
  long long m, n;
  int h_kind;
  float lam;
  int hist_len;     // maxit rounded up to 128 (the JAX kernels' _hist_len)
};

// A dataset's rows: `count` rows, one t each; the other entries of JAX's per-row scalar
// table (sigma0 or eta0, lam, tol) are the same for every row of a dataset (each cell's
// copy carries its dataset's p2).
struct SwRows {
  const float* ts;  // (count,) on the device
  int count;
  float p2;         // sigma0 (MP) or eta0 (AdaPDM+)
  float tol;
  int maxit, record;
  float* x_out;  // (count, n)
  float* stats;  // (count, 4): numit, norm_res, converged, ls_failed
  float* hist;   // (count, 5, hist_len): gamma, sigma, norm_res, trials, objective
};

// One row's arguments and the block's scratch, in shared memory.
struct SwShared {
  float t;
  float* x_out;
  float* stats;
  float* hist;
  float warp_part[kSwParts][kWarps];
  float s_red[kWarps];
  float s_sum[kSwParts];
  int numit;
};

// Index helpers of a thread, a warp and the grid.
struct Lanes {
  int lane, warp;
  long long gtid, nthreads, gwarp, nwarps;
  __device__ Lanes()
      : lane(threadIdx.x & 31),
        warp(threadIdx.x >> 5),
        gtid(static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x),
        nthreads(static_cast<long long>(gridDim.x) * kThreads),
        gwarp(static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)),
        nwarps(static_cast<long long>(gridDim.x) * kWarps) {}
};

// This CTA's partials [k0, k1) of acc: a shuffle tree a warp, then the warps in order.
__device__ __forceinline__ void flush(SwShared& sm, const float* acc, float* part, int k0,
                                      int k1, int lane, int warp) {
#pragma unroll
  for (int k = 0; k < kSwParts; ++k) {
    if (k < k0 || k >= k1) continue;
    const float s = warp_sum(acc[k]);
    if (lane == 0) sm.warp_part[k][warp] = s;
  }
  write_partials(sm.warp_part, part, k0, k1);
}

// The sums over the CTAs of partials [k0, k1) into sm.s_sum, the same bits in every
// CTA (warp k - k0 sums partial k); ends with a block barrier.
__device__ __forceinline__ void read_sums(SwShared& sm, const float* part, int k0, int k1,
                                          int lane, int warp) {
  if (warp < k1 - k0) {
    const float total = sum_part(part, k0 + warp, lane);
    if (lane == 0) sm.s_sum[k0 + warp] = total;
  }
  __syncthreads();
}

// The objective lam ||x||_1 + h(a_x) from the sums of |x| and of |diff| or diff^2.
__device__ __forceinline__ float objective(const SwProblem& p, float abs_x, float h_sum) {
  return p.lam * abs_x + (p.h_kind == kHL1 ? h_sum : sqrtf(h_sum));
}

// The row's outputs: stats, and the histories zeroed past numit (block 0).
__device__ void finish_row(const SwProblem& p, SwShared& sm, int it, float norm_res, float tol,
                           bool ls_failed, int record) {
  if (blockIdx.x != 0) return;
  const long long hl = p.hist_len;
  if (threadIdx.x == 0) {
    sm.stats[0] = static_cast<float>(it);
    sm.stats[1] = norm_res;
    sm.stats[2] = norm_res <= tol ? 1.f : 0.f;
    sm.stats[3] = ls_failed ? 1.f : 0.f;
    sm.numit = it;
  }
  __syncthreads();
  if (record) {
    for (long long i = sm.numit + threadIdx.x; i < hl; i += kThreads) {
#pragma unroll
      for (int k = 0; k < 5; ++k) sm.hist[k * hl + i] = 0.f;
    }
  }
}

__device__ __forceinline__ void record_row(const SwProblem& p, SwShared& sm, int record, int it,
                                           float gamma, float sigma, float norm_res, int trials,
                                           float obj) {
  if (record && blockIdx.x == 0 && threadIdx.x == 0) {
    const long long hl = p.hist_len;
    sm.hist[it] = gamma;
    sm.hist[hl + it] = sigma;
    sm.hist[2 * hl + it] = norm_res;
    sm.hist[3 * hl + it] = static_cast<float>(trials);
    sm.hist[4 * hl + it] = obj;
  }
}

// One whole Malitsky-Pock solve (_mpls_core), run by every thread of the grid. Every
// thread carries the same scalars and takes the same branches.
template <typename T, int V>
__device__ void mp_solve(const SwProblem& p, const SwRows& r, SwShared& sm) {
  cg::grid_group grid = cg::this_grid();
  const Lanes g;
  const long long m = p.m, n = p.n;
  const bool l1 = p.h_kind == kHL1;
  const float t = sm.t, lam = p.lam;
  const T* __restrict__ a = static_cast<const T*>(p.a);
  const T* __restrict__ at = static_cast<const T*>(p.at);
  const float* __restrict__ bv = p.bv;
  const float sqrt2 = sqrtf(2.f);
  float* y = p.ys;

  // the start: x0 = 0, y0 = 0, A x0 = 0, A'y0 = 0 in the parity-0 buffers
  for (long long j = g.gtid; j < n; j += g.nthreads) {
    p.xs[j] = 0.f;
    p.at_ys[j] = 0.f;
  }
  for (long long i = g.gtid; i < m; i += g.nthreads) {
    y[i] = 0.f;
    p.axs[i] = 0.f;
  }
  grid.sync();

  float sigma = r.p2, norm_res = f32_inf();
  int it = 0, px = 0;  // x = xs[px], A x = axs[px], A'y = at_ys[px]: the last accepted
  bool ls_failed = false;
  bool go = 0 < r.maxit && norm_res > r.tol;  // a NaN residual stops
  if (!go) {
    for (long long j = g.gtid; j < n; j += g.nthreads) sm.x_out[j] = p.xs[j];
  }

  while (go) {
    const float* x_prev = p.xs + px * n;
    float* x = p.xs + (1 - px) * n;
    const float* ax_prev = p.axs + px * m;
    float* ax = p.axs + (1 - px) * m;
    const float* aty_prev = p.at_ys + px * n;
    float* aty = p.at_ys + (1 - px) * n;

    // D: w = y + sigma a_x, y = prox_{sigma h*}(w), elementwise
    float acc[kSwParts] = {};
    for (long long i = g.gtid; i < m; i += g.nthreads) {
      const float wi = y[i] + sigma * ax_prev[i];
      const float b = bv[i];
      const float z = dual_z(wi, sigma, b);
      p.w[i] = wi;
      if (l1) {
        y[i] = dual_y(wi, sigma, b, soft(z, 1.f / sigma));
      } else {
        acc[kZ2] += z * z;
      }
    }
    if (!l1) {
      // NormL2: the block scale from ||z|| over all m coordinates
      flush(sm, acc, p.part, kZ2, kZ2 + 1, g.lane, g.warp);
      grid.sync();
      read_sums(sm, p.part, kZ2, kZ2 + 1, g.lane, g.warp);
      const float scale = l2_scale(sm.s_sum[kZ2], sigma);
      for (long long i = g.gtid; i < m; i += g.nthreads) {
        const float wi = p.w[i];
        const float b = bv[i];
        y[i] = dual_y(wi, sigma, b, scale * dual_z(wi, sigma, b));
      }
    }
    grid.sync();

    // P2: A'y a CTA a row of A'; thread 0 the first trial's x at that coordinate
    const float sigma_prev = sigma;
    float st = sigma * sqrt2;
    int trials = 1;
    {
      const float theta = st / sigma_prev;
      const float gamma = t * t * st;
      for (long long j = blockIdx.x; j < n; j += gridDim.x) {
        const float atyj = block_dot<T, V>(at + j * m, y, m, sm.s_red);
        if (threadIdx.x == 0) {
          aty[j] = atyj;
          const float vj = x_prev[j] - gamma * ((1.f + theta) * atyj - theta * aty_prev[j]);
          p.v[j] = vj;
          x[j] = soft(vj, gamma * lam);
        }
      }
    }
    grid.sync();

    for (;;) {
      const float gamma = t * t * st;
      // P1: A x a warp a row; the trial's partials
      float tacc[kSwParts] = {};
      for (long long i = g.gwarp; i < m; i += g.nwarps) {
        const float axi = warp_dot<T, V>(a + i * n, x, n, g.lane);
        if (g.lane == 0) {
          ax[i] = axi;
          const float dax = axi - ax_prev[i];
          tacc[kDax2] += dax * dax;
          const float d = (p.w[i] - y[i]) / sigma_prev - axi;
          tacc[kDual2] += d * d;
          const float diff = axi - bv[i];
          tacc[kHVal] += l1 ? fabsf(diff) : diff * diff;
        }
      }
      for (long long j = g.gtid; j < n; j += g.nthreads) {
        const float xj = x[j];
        const float dx = xj - x_prev[j];
        tacc[kDx2] += dx * dx;
        const float pr = (p.v[j] - xj) / gamma + aty[j];
        tacc[kPrimal2] += pr * pr;
        tacc[kAbsX] += fabsf(xj);
      }
      flush(sm, tacc, p.part, kPrimal2, kDax2 + 1, g.lane, g.warp);
      grid.sync();

      // the test, from the same sums in every thread
      read_sums(sm, p.part, kPrimal2, kDax2 + 1, g.lane, g.warp);
      const float lhs = gamma * st * sm.s_sum[kDax2];
      const bool failed = lhs > 0.95f * sm.s_sum[kDx2];
      if (failed && trials < kMaxTrials) {
        st = st / 2.f;
        ++trials;
        // T: the next trial's x, elementwise
        const float theta = st / sigma_prev;
        const float gam = t * t * st;
        for (long long j = g.gtid; j < n; j += g.nthreads) {
          const float vj = x_prev[j] - gam * ((1.f + theta) * aty[j] - theta * aty_prev[j]);
          p.v[j] = vj;
          x[j] = soft(vj, gam * lam);
        }
        grid.sync();
        continue;
      }

      // accepted (or the cap): the carry moves to this trial
      ls_failed = ls_failed || failed;
      norm_res = sqrtf(sm.s_sum[kPrimal2] + sm.s_sum[kDual2]);
      record_row(p, sm, r.record, it, gamma, st, norm_res, trials,
                 objective(p, sm.s_sum[kAbsX], sm.s_sum[kHVal]));
      sigma = st;
      ++it;
      px ^= 1;
      go = it < r.maxit && norm_res > r.tol;
      if (!go) {
        for (long long j = g.gtid; j < n; j += g.nthreads) sm.x_out[j] = x[j];
      }
      break;
    }
  }
  finish_row(p, sm, it, norm_res, r.tol, ls_failed, r.record);
}

// AdaPDM+'s step sizes at the trial value e: gamma' (evaluated in _adapdmp_core's order),
// rho and sigma.
struct PdmpStep {
  float gamma_next, rho, sigma;
};
__device__ __forceinline__ PdmpStep pdmp_step(float t, float e, float gamma, float gamma_prev,
                                              float m4xim1) {
  const float theta_big2 = static_cast<float>(2.0 * kThetaBig);
  const float two_delta1 = static_cast<float>(2.0 * (1.0 + kDelta));
  const float big_delta = 0.f;  // f = 0
  const float q = t * e * gamma;
  const float g_growth = gamma * sqrtf(1.f + gamma / gamma_prev);
  const float g_bound = 1.f / (theta_big2 * t * e);
  const float g_xi = gamma * sqrtf(m4xim1 / (two_delta1 * (big_delta + sqrtf(
                                                  big_delta * big_delta + m4xim1 * (q * q)))));
  PdmpStep s;
  s.gamma_next = nan_min(g_growth, nan_min(g_bound, g_xi));
  s.rho = s.gamma_next / gamma;
  s.sigma = t * t * s.gamma_next;
  return s;
}

// One whole AdaPDM+ solve (_adapdmp_core), run by every thread of the grid.
template <typename T, int V>
__device__ void adapdmp_solve(const SwProblem& p, const SwRows& r, SwShared& sm) {
  cg::grid_group grid = cg::this_grid();
  const Lanes g;
  const long long m = p.m, n = p.n;
  const bool l1 = p.h_kind == kHL1;
  const float t = sm.t, lam = p.lam;
  const T* __restrict__ a = static_cast<const T*>(p.a);
  const T* __restrict__ at = static_cast<const T*>(p.at);
  const float* __restrict__ bv = p.bv;
  const float delta1 = static_cast<float>(1.0 + kDelta);
  const float gamma0 = 1.f / (static_cast<float>(2.0 * kThetaBig) * t * r.p2);

  // warm-up: x0 = 0, y0 = 0, so A x0 = 0, A'y0 = 0, v0 = x0 - gamma0 A'y0,
  // x1 = soft(v0, gamma0 lam)
  for (long long j = g.gtid; j < n; j += g.nthreads) {
    const float vj = 0.f - gamma0 * 0.f;
    p.v[j] = vj;
    p.xs[j] = soft(vj, gamma0 * lam);
    p.at_ys[j] = 0.f;
  }
  for (long long i = g.gtid; i < m; i += g.nthreads) {
    p.ys[i] = 0.f;
    p.axs[i] = 0.f;
  }
  grid.sync();

  float gamma = gamma0, gamma_prev = gamma0, eta = r.p2, norm_res = f32_inf();
  int it = 0;
  int px = 0;  // x = xs[px], y = ys[px], A'y = at_ys[px]; x', y', A'y' the other slots
  int pa = 0;  // a_x_prev = axs[pa]; this iteration's A x goes to axs[1 - pa]
  bool ls_failed = false;
  bool go = 0 < r.maxit && norm_res > r.tol;  // a NaN residual stops
  if (!go) {
    for (long long j = g.gtid; j < n; j += g.nthreads) sm.x_out[j] = p.xs[j];
  }

  while (go) {
    const float* x = p.xs + px * n;
    float* x_next = p.xs + (1 - px) * n;
    const float* y = p.ys + px * m;
    float* y_next = p.ys + (1 - px) * m;
    const float* aty = p.at_ys + px * n;
    float* aty_next = p.at_ys + (1 - px) * n;
    const float* ax_prev = p.axs + pa * m;
    float* ax = p.axs + (1 - pa) * m;

    const float xi = t * gamma * eta * delta1;
    const float m4xim1 = 1.f - 4.f * (xi * xi);
    float e = kRDown * eta;
    int trials = 1;
    PdmpStep st = pdmp_step(t, e, gamma, gamma_prev, m4xim1);

    // P1: A x a warp a row, and lane 0 the first trial's dual step at that row; the
    // primal residual and ||x||_1 elementwise
    float acc[kSwParts] = {};
    for (long long i = g.gwarp; i < m; i += g.nwarps) {
      const float axi = warp_dot<T, V>(a + i * n, x, n, g.lane);
      if (g.lane == 0) {
        ax[i] = axi;
        const float b = bv[i];
        const float diff = axi - b;
        acc[kHVal] += l1 ? fabsf(diff) : diff * diff;
        const float wi = y[i] + st.sigma * ((1.f + st.rho) * axi - st.rho * ax_prev[i]);
        p.w[i] = wi;
        const float z = dual_z(wi, st.sigma, b);
        if (l1) {
          y_next[i] = dual_y(wi, st.sigma, b, soft(z, 1.f / st.sigma));
        } else {
          acc[kZ2] += z * z;
        }
      }
    }
    for (long long j = g.gtid; j < n; j += g.nthreads) {
      const float xj = x[j];
      const float pr = (p.v[j] - xj) / gamma + aty[j];
      acc[kPrimal2] += pr * pr;
      acc[kAbsX] += fabsf(xj);
    }
    flush(sm, acc, p.part, kZ2, kHVal + 1, g.lane, g.warp);
    grid.sync();
    read_sums(sm, p.part, kZ2, kHVal + 1, g.lane, g.warp);
    const float primal2 = sm.s_sum[kPrimal2], abs_x = sm.s_sum[kAbsX], h_sum = sm.s_sum[kHVal];

    for (;;) {
      if (!l1) {
        // NormL2: y' from the block scale of ||z|| (its partials summed in s_sum[kZ2])
        const float scale = l2_scale(sm.s_sum[kZ2], st.sigma);
        for (long long i = g.gtid; i < m; i += g.nthreads) {
          const float wi = p.w[i];
          const float b = bv[i];
          y_next[i] = dual_y(wi, st.sigma, b, scale * dual_z(wi, st.sigma, b));
        }
        grid.sync();
      }

      // P2: A'y' a CTA a row of A'; thread 0 the candidate second half at that
      // coordinate; the test's partials and the dual residual's
      float tacc[kSwParts] = {};
      for (long long j = blockIdx.x; j < n; j += gridDim.x) {
        const float atyj = block_dot<T, V>(at + j * m, y_next, m, sm.s_red);
        if (threadIdx.x == 0) {
          aty_next[j] = atyj;
          const float d = atyj - aty[j];
          tacc[kDaty2] += d * d;
          const float vj = x[j] - st.gamma_next * atyj;
          p.v[j] = vj;
          x_next[j] = soft(vj, st.gamma_next * lam);
        }
      }
      for (long long i = g.gtid; i < m; i += g.nthreads) {
        const float yi = y_next[i];
        const float dy = yi - y[i];
        tacc[kDy2] += dy * dy;
        const float d = (p.w[i] - yi) / st.sigma - ax[i];
        tacc[kDual2] += d * d;
      }
      flush(sm, tacc, p.part, kDual2, kDaty2 + 1, g.lane, g.warp);
      grid.sync();

      // the test, from the same sums in every thread: two roots and a division, as
      // JAX computes it (dy = 0 gives NaN, which fails)
      read_sums(sm, p.part, kDual2, kDaty2 + 1, g.lane, g.warp);
      const bool ok = e >= sqrtf(sm.s_sum[kDaty2]) / sqrtf(sm.s_sum[kDy2]);
      if (!ok && trials < kMaxTrials) {
        e = e * kRUp;
        ++trials;
        st = pdmp_step(t, e, gamma, gamma_prev, m4xim1);
        // D: the trial's dual step, elementwise
        float dacc[kSwParts] = {};
        for (long long i = g.gtid; i < m; i += g.nthreads) {
          const float b = bv[i];
          const float wi = y[i] + st.sigma * ((1.f + st.rho) * ax[i] - st.rho * ax_prev[i]);
          p.w[i] = wi;
          const float z = dual_z(wi, st.sigma, b);
          if (l1) {
            y_next[i] = dual_y(wi, st.sigma, b, soft(z, 1.f / st.sigma));
          } else {
            dacc[kZ2] += z * z;
          }
        }
        if (!l1) flush(sm, dacc, p.part, kZ2, kZ2 + 1, g.lane, g.warp);
        grid.sync();
        if (!l1) read_sums(sm, p.part, kZ2, kZ2 + 1, g.lane, g.warp);
        continue;
      }

      // accepted (or the cap)
      ls_failed = ls_failed || !ok;
      norm_res = sqrtf(primal2 + sm.s_sum[kDual2]);
      record_row(p, sm, r.record, it, st.gamma_next, st.sigma, norm_res, trials,
                 objective(p, abs_x, h_sum));
      gamma_prev = gamma;
      gamma = st.gamma_next;
      eta = e;
      ++it;
      go = it < r.maxit && norm_res > r.tol;
      if (!go) {
        // converged: the iterate at the check, not the extra second-half prox point
        const bool conv = norm_res <= r.tol;
        for (long long j = g.gtid; j < n; j += g.nthreads) sm.x_out[j] = conv ? x[j] : x_next[j];
      }
      px ^= 1;
      pa ^= 1;
      break;
    }
  }
  finish_row(p, sm, it, norm_res, r.tol, ls_failed, r.record);
}

}  // namespace
