// The solve routines of the f = 0 composite family's linesearch cores, run by K7a (the
// t-sweep) and K7b (the dataset x t grid), both one kernel in resident_f0_grid.cu: one
// whole early-exit Malitsky-Pock solve (mp_solve, JAX's _mpls_core) or AdaPDM+ solve
// (adapdmp_solve, _adapdmp_core) run by every thread of one thread-block cluster, the
// cell's rows of A, its scalars and its outputs handed in by the caller,
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
// What bounds it on the card. An MP trial or an AdaPDM+ trial does 2 m n flops, an
// iteration 4 m n at one trial (0.06 us at 8192 x 128 on 67 TFLOP/s of f32 outside the
// tensor cores), and A is read once. So the barriers, the round trips between the SMs
// and the phases' latency set the pace, not bytes or flops.
//
// Design (a cell on one cluster of C CTAs; the launcher picks C from the shape):
//   * CTA k of the cluster owns rows [k R, k R + R) of A, R = ceil(m / C), and keeps the
//     first `held` of them (all where they fit) in shared memory for the whole solve, at a
//     padded row stride (lda / V odd, so a thread a row reads without bank conflicts); the
//     rest it reads from device memory (L2) in each pass. The rows' y, A x (two slots each),
//     w and bv stay with them in the CTA.
//   * x, v and A'y (n values; x and A'y two slots each) are copied into every CTA: every CTA
//     computes them, elementwise, from the same bits, so the trial x (MP's phase T) and
//     every sum over n are local: no barrier.
//   * A x: a thread a row of the CTA's block (V accumulators over the row, summed in order).
//   * A'y: each CTA forms column partials over its rows (threads over V-column groups,
//     G row groups summed in order through shared memory), and after a cluster barrier
//     every CTA sums the C partials of each column in rank order from its peers' shared
//     memory (DSMEM): the same bits in every CTA, and A' is not read at all.
//   * The sums over rows: each CTA reduces its rows (a shuffle tree a warp, the warps in
//     order), writes the result to its shared memory, and after the cluster barrier every
//     CTA sums the C values in rank order; so every thread takes the accept, halve/inflate,
//     cap and stop decisions from the same bits (a CTA that decided otherwise would wait at
//     a barrier the others never reach). NaN compares false, as in jnp.
//   * Barriers: a cluster barrier publishes a set of partials; the partial slots alternate
//     by parity, and every set is read before the next barrier, so a slot is never written
//     while a peer may read it. An iteration at one trial waits at
//       MP:      2 cluster barriers with NormL1 (P2's A'y, P1's test), 3 with NormL2 (||z||),
//                and 1 a further trial (the trial x is local);
//       AdaPDM+: 1 with NormL1 (P2's A'y' and the test's sums together), 2 with NormL2,
//                and 1 (2) a further trial.
//   * x, A'y and (AdaPDM+) y are two buffers each, swapped by parity on acceptance, and A
//     x alternates by iteration: no copies.
//   * IEEE semantics (no fast math, IEEE division and square root, NaN-propagating min/max
//     like jnp.minimum / jnp.maximum, jnp.sign's signed zero; -fmad=false, so each
//     elementwise expression rounds after every operation as the plain PyTorch version
//     does; the dot products use explicit fmaf).
//
// Every function is deterministic: one fixed order of every sum, no atomics, and a cell's
// arithmetic depends on its shape and C only, not on which cluster runs it, when, or how
// many of its rows shared memory holds.

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
// the largest cluster (the portable size). Against 16 (experiments/k7_clusters.py, PERF.md,
// PR 20): a cell's iteration at 4224 and 8192 rows ran 1.5-2.1x faster on 16, but 7
// clusters of 16 fit on the card against 15 of 8, so the drivers' 15-cell sweeps there took
// 29-48% less time on 8 and their four 45-cell grids 4% less in all.
constexpr int kMaxCluster = 8;

// The sums a reduction forms. The cluster-wide ones are over rows (kZ2: ||z||^2 of NormL2's
// dual prox; kHVal: h's sum; kDax2, kDual2, kDy2); the others are over n, which every CTA
// holds whole, so the CTA's own sum is the cell's.
enum SwSum { kZ2 = 0, kHVal, kDax2, kDual2, kDy2, kDx2, kPrimal2, kAbsX, kDaty2, kSwSums };
__host__ __device__ constexpr unsigned bit(int k) { return 1u << k; }

// A CTA's scalars and reduction scratch (static shared memory).
struct SwShared {
  float warp_part[kSwSums][kWarps];
  float part[2][kSwSums];  // this CTA's sums by parity: its peers read them
  float sum[kSwSums];      // the reduced sums
  int cell[2];             // rank 0's: the cell it took, by parity
  int cell_now;
};

// One cell as one CTA of its cluster sees it. The vectors point into shared memory, or
// into this CTA's part of the launch's scratch where shared memory cannot hold them.
struct Cell {
  const void* a_g;  // this CTA's first row of A (row-major, stride n) in device memory
  const void* a_s;  // the first `held` of its rows in shared memory (stride lda)
  int rows, held, lda;
  long long n;
  const float* bv;  // (rows,)
  float* xs;        // (2, n): x by parity (MP: x_prev and the trial x; AdaPDM+: x and x')
  float* v;         // (n,): the pre-prox point
  float* at_ys;     // (2, n): A'y by parity
  float* colpart;   // (2, n): this CTA's column partials of A'y by parity (its peers read)
  float* ys;        // (2, rows): AdaPDM+: y and the trial y' by parity; MP: y in ys[0]
  float* axs;       // (2, rows): A x by parity
  float* w;         // (rows,): the dual pre-prox point
  float* red;       // (kThreads * V,): the row groups' column partials
  // the peers' colpart: DSMEM (colpart_global null) or this cluster's scratch
  const float* colpart_global;  // rank 0's colpart in the scratch
  long long peer_stride;        // floats between two ranks' scratch
  int rank, csize;
  // the cell's scalars and outputs
  int h_kind, maxit, record, hist_len;
  float lam, t, p2, tol;
  float* x_out;  // (n,)
  float* stats;  // (4,): numit, norm_res, converged, ls_failed
  float* hist;   // (5, hist_len): gamma, sigma, norm_res, trials, objective
};

// V consecutive values of A from a row in shared memory (plain loads), as floats.
template <int V>
__device__ __forceinline__ void load_s(const float* p, float* out) {
  load_f32<V>(p, out);
}
template <int V>
__device__ __forceinline__ void load_s(const __nv_bfloat16* p, float* out) {
  if constexpr (V == 1) {
    out[0] = __bfloat162float(p[0]);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 v = __bfloat1622float2(h[q]);
      out[2 * q] = v.x;
      out[2 * q + 1] = v.y;
    }
  }
}

// V values of a row of A at column group u: from shared memory (plain loads) or from
// device memory (read-only loads).
template <bool kShared, typename T, int V>
__device__ __forceinline__ void row_vals(const T* row, long long u, float* out) {
  if constexpr (kShared) {
    load_s<V>(row + u * V, out);
  } else {
    load_a<V>(row + u * V, out);
  }
}

// A_i . x over one row by one thread: V accumulators over the row's column groups, then
// summed in order. The same bits from shared or device memory.
template <bool kShared, typename T, int V>
__device__ __forceinline__ float dot_row(const T* row, const float* x, long long units) {
  float acc[V];
#pragma unroll
  for (int q = 0; q < V; ++q) acc[q] = 0.f;
#pragma unroll 4
  for (long long u = 0; u < units; ++u) {
    float av[V], xv[V];
    row_vals<kShared, T, V>(row, u, av);
    load_f32<V>(x + u * V, xv);
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = fmaf(av[q], xv[q], acc[q]);
  }
  float s = acc[0];
#pragma unroll
  for (int q = 1; q < V; ++q) s += acc[q];
  return s;
}

// A x over the CTA's rows, a thread a row (dot_row), from wherever each row is kept; the
// thread then calls body(i, A_i . x). (A warp a row for the rows in device memory, 4 or 8
// rows in flight, read the same bytes coalesced and was no faster, PR 20.)
template <typename T, int V, typename Body>
__device__ __forceinline__ void for_each_ax(const Cell& c, const float* x, Body&& body) {
  const long long units = c.n / V;
  const T* __restrict__ a_s = static_cast<const T*>(c.a_s);
  const T* __restrict__ a_g = static_cast<const T*>(c.a_g);
  for (int i = threadIdx.x; i < c.rows; i += kThreads) {
    const long long r = i;
    body(i, i < c.held ? dot_row<true, T, V>(a_s + r * c.lda, x, units)
                       : dot_row<false, T, V>(a_g + r * c.n, x, units));
  }
}

// acc[q] += A_iq y_i over the rows i = i0, i0 + step, ... below i1 at column group u.
template <bool kShared, typename T, int V>
__device__ __forceinline__ int col_rows(const T* a, long long stride, const float* y, int i0,
                                        int i1, int step, long long u, float* acc) {
  int i = i0;
#pragma unroll 4
  for (; i < i1; i += step) {
    float av[V];
    row_vals<kShared, T, V>(a + static_cast<long long>(i) * stride, u, av);
    const float yi = y[i];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = fmaf(av[q], yi, acc[q]);
  }
  return i;
}

// colpart[cp][j] = sum over the CTA's rows i of A_ij y_i: thread (g, u) takes column group
// u over the rows g, g + G, ... (G = kThreads / min(n / V, kThreads) row groups), then the
// G group sums of each column are added in order through red. Every thread calls it; it
// ends with a block barrier. The two slots alternate by call: the slot written now was
// last read before the previous call's cluster barrier.
template <typename T, int V>
__device__ void col_partials(const Cell& c, const float* y, int cp) {
  float* __restrict__ out = c.colpart + cp * c.n;
  const long long units = c.n / V;
  const int jw = static_cast<int>(units < kThreads ? units : kThreads);
  const int groups = kThreads / jw;
  const int g = threadIdx.x / jw, ju = threadIdx.x % jw;
  for (long long u0 = 0; u0 < units; u0 += jw) {
    const long long u = u0 + ju;
    float acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = 0.f;
    if (g < groups && u < units) {
      // the rows in order: those in shared memory, then the rest
      const int i = col_rows<true, T, V>(static_cast<const T*>(c.a_s), c.lda, y, g, c.held,
                                         groups, u, acc);
      col_rows<false, T, V>(static_cast<const T*>(c.a_g), c.n, y, i, c.rows, groups, u, acc);
    }
    if (g < groups) {
#pragma unroll
      for (int q = 0; q < V; ++q) c.red[(g * jw + ju) * V + q] = acc[q];
    }
    __syncthreads();
    const long long cols = (units - u0 < jw ? units - u0 : jw) * V;
    for (long long k = threadIdx.x; k < cols; k += kThreads) {
      float s = 0.f;
      for (int gg = 0; gg < groups; ++gg) s += c.red[gg * jw * V + k];
      out[u0 * V + k] = s;
    }
    __syncthreads();
  }
}

// sum over the cluster's ranks, in rank order, of their colpart[cp][j]: the same bits in
// every CTA. Called after the cluster barrier that published the partials.
__device__ __forceinline__ float col_sum(const Cell& c, long long j, int cp) {
  j += cp * c.n;
  cg::cluster_group cl = cg::this_cluster();
  float s = 0.f;
  if (c.colpart_global == nullptr) {
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < c.csize) s += cl.map_shared_rank(c.colpart, r)[j];
    }
  } else {
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < c.csize) s += __ldcg(c.colpart_global + r * c.peer_stride + j);
    }
  }
  return s;
}

// The block's sums of acc[k] for k in cross | local (a shuffle tree a warp, the warps in
// order); those in `cross` are then summed over the cluster in rank order (a cluster
// barrier; `slot` alternates), those in `local` are the CTA's. The results land in
// sm.sum; ends with a block barrier. Every thread of the cluster calls it alike.
__device__ __forceinline__ void reduce(SwShared& sm, const float* acc, unsigned cross,
                                       unsigned local, int& slot, int csize) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned all = cross | local;
#pragma unroll
  for (int k = 0; k < kSwSums; ++k) {
    if (!(all & bit(k))) continue;
    const float s = warp_sum(acc[k]);
    if (lane == 0) sm.warp_part[k][warp] = s;
  }
  __syncthreads();
  const int k = threadIdx.x;
  if (k < kSwSums && (all & bit(k))) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sm.warp_part[k][w];
    if (cross & bit(k)) {
      sm.part[slot][k] = s;
    } else {
      sm.sum[k] = s;
    }
  }
  if (cross) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    if (k < kSwSums && (cross & bit(k))) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < csize) s += *cl.map_shared_rank(&sm.part[slot][k], r);
      }
      sm.sum[k] = s;
    }
    slot ^= 1;
  }
  __syncthreads();
}

// The objective lam ||x||_1 + h(a_x) from the sums of |x| and of |diff| or diff^2.
__device__ __forceinline__ float objective(const Cell& c, float abs_x, float h_sum) {
  return c.lam * abs_x + (c.h_kind == kHL1 ? h_sum : sqrtf(h_sum));
}

// x_out = x (rank 0; every CTA holds the same x).
__device__ __forceinline__ void write_x(const Cell& c, const float* x) {
  if (c.rank != 0) return;
  for (long long j = threadIdx.x; j < c.n; j += kThreads) c.x_out[j] = x[j];
}

// The cell's outputs: stats, and the histories zeroed past numit (rank 0).
__device__ void finish_row(const Cell& c, int it, float norm_res, bool ls_failed) {
  if (c.rank != 0) return;
  const long long hl = c.hist_len;
  if (threadIdx.x == 0) {
    c.stats[0] = static_cast<float>(it);
    c.stats[1] = norm_res;
    c.stats[2] = norm_res <= c.tol ? 1.f : 0.f;
    c.stats[3] = ls_failed ? 1.f : 0.f;
  }
  if (c.record) {
    for (long long i = it + threadIdx.x; i < hl; i += kThreads) {
#pragma unroll
      for (int k = 0; k < 5; ++k) c.hist[k * hl + i] = 0.f;
    }
  }
}

__device__ __forceinline__ void record_row(const Cell& c, int it, float gamma, float sigma,
                                           float norm_res, int trials, float obj) {
  if (c.record && c.rank == 0 && threadIdx.x == 0) {
    const long long hl = c.hist_len;
    c.hist[it] = gamma;
    c.hist[hl + it] = sigma;
    c.hist[2 * hl + it] = norm_res;
    c.hist[3 * hl + it] = static_cast<float>(trials);
    c.hist[4 * hl + it] = obj;
  }
}

// One whole Malitsky-Pock solve (_mpls_core), run by every thread of the cluster. Every
// thread carries the same scalars and takes the same branches.
template <typename T, int V>
__device__ __forceinline__ void mp_solve(const Cell& c, SwShared& sm) {
  cg::cluster_group cl = cg::this_cluster();
  const long long n = c.n;
  const int rows = c.rows, tid = threadIdx.x;
  const bool l1 = c.h_kind == kHL1;
  const float t = c.t, lam = c.lam;
  const float* __restrict__ bv = c.bv;
  const float sqrt2 = sqrtf(2.f);
  float* y = c.ys;
  int slot = 0, cp = 0;  // the parities of the sums' and the column partials' slots

  // the start: x0 = 0, y0 = 0, A x0 = 0, A'y0 = 0 in the parity-0 buffers
  for (long long j = tid; j < n; j += kThreads) {
    c.xs[j] = 0.f;
    c.at_ys[j] = 0.f;
  }
  for (int i = tid; i < rows; i += kThreads) {
    y[i] = 0.f;
    c.axs[i] = 0.f;
  }
  __syncthreads();

  float sigma = c.p2, norm_res = f32_inf();
  int it = 0, px = 0;  // x = xs[px], A x = axs[px], A'y = at_ys[px]: the last accepted
  bool ls_failed = false;
  bool go = 0 < c.maxit && norm_res > c.tol;  // a NaN residual stops
  if (!go) write_x(c, c.xs);

  while (go) {
    const float* x_prev = c.xs + px * n;
    float* x = c.xs + (1 - px) * n;
    const float* ax_prev = c.axs + px * rows;
    float* ax = c.axs + (1 - px) * rows;
    const float* aty_prev = c.at_ys + px * n;
    float* aty = c.at_ys + (1 - px) * n;

    // D: w = y + sigma a_x, y = prox_{sigma h*}(w), over the CTA's rows
    float acc[kSwSums] = {};
    for (int i = tid; i < rows; i += kThreads) {
      const float wi = y[i] + sigma * ax_prev[i];
      const float b = bv[i];
      const float z = dual_z(wi, sigma, b);
      c.w[i] = wi;
      if (l1) {
        y[i] = dual_y(wi, sigma, b, soft(z, 1.f / sigma));
      } else {
        acc[kZ2] += z * z;
      }
    }
    if (!l1) {
      // NormL2: the block scale from ||z|| over all m coordinates
      reduce(sm, acc, bit(kZ2), 0, slot, c.csize);
      const float scale = l2_scale(sm.sum[kZ2], sigma);
      for (int i = tid; i < rows; i += kThreads) {
        const float wi = c.w[i];
        const float b = bv[i];
        y[i] = dual_y(wi, sigma, b, scale * dual_z(wi, sigma, b));
      }
    }
    __syncthreads();

    // P2: A'y, the CTA's column partials, published by a cluster barrier; then every CTA
    // sums them and forms the first trial's x
    col_partials<T, V>(c, y, cp);
    cl.sync();
    const float sigma_prev = sigma;
    float st = sigma * sqrt2;
    int trials = 1;
    {
      const float theta = st / sigma_prev;
      const float gamma = t * t * st;
      for (long long j = tid; j < n; j += kThreads) {
        const float atyj = col_sum(c, j, cp);
        aty[j] = atyj;
        const float vj = x_prev[j] - gamma * ((1.f + theta) * atyj - theta * aty_prev[j]);
        c.v[j] = vj;
        x[j] = soft(vj, gamma * lam);
      }
    }
    cp ^= 1;
    __syncthreads();

    for (;;) {
      const float gamma = t * t * st;
      // P1: A x a thread a row; the trial's sums
      float tacc[kSwSums] = {};
      for_each_ax<T, V>(c, x, [&](int i, float axi) {
        ax[i] = axi;
        const float dax = axi - ax_prev[i];
        tacc[kDax2] += dax * dax;
        const float d = (c.w[i] - y[i]) / sigma_prev - axi;
        tacc[kDual2] += d * d;
        const float diff = axi - bv[i];
        tacc[kHVal] += l1 ? fabsf(diff) : diff * diff;
      });
      for (long long j = tid; j < n; j += kThreads) {
        const float xj = x[j];
        const float dx = xj - x_prev[j];
        tacc[kDx2] += dx * dx;
        const float pr = (c.v[j] - xj) / gamma + aty[j];
        tacc[kPrimal2] += pr * pr;
        tacc[kAbsX] += fabsf(xj);
      }
      reduce(sm, tacc, bit(kHVal) | bit(kDax2) | bit(kDual2),
             bit(kDx2) | bit(kPrimal2) | bit(kAbsX), slot, c.csize);

      // the test, from the same sums in every thread
      const float lhs = gamma * st * sm.sum[kDax2];
      const bool failed = lhs > 0.95f * sm.sum[kDx2];
      if (failed && trials < kMaxTrials) {
        st = st / 2.f;
        ++trials;
        // T: the next trial's x, elementwise, in every CTA
        const float theta = st / sigma_prev;
        const float gam = t * t * st;
        for (long long j = tid; j < n; j += kThreads) {
          const float vj = x_prev[j] - gam * ((1.f + theta) * aty[j] - theta * aty_prev[j]);
          c.v[j] = vj;
          x[j] = soft(vj, gam * lam);
        }
        __syncthreads();
        continue;
      }

      // accepted (or the cap): the carry moves to this trial
      ls_failed = ls_failed || failed;
      norm_res = sqrtf(sm.sum[kPrimal2] + sm.sum[kDual2]);
      record_row(c, it, gamma, st, norm_res, trials,
                 objective(c, sm.sum[kAbsX], sm.sum[kHVal]));
      sigma = st;
      ++it;
      px ^= 1;
      go = it < c.maxit && norm_res > c.tol;
      if (!go) write_x(c, x);
      break;
    }
  }
  finish_row(c, it, norm_res, ls_failed);
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

// One whole AdaPDM+ solve (_adapdmp_core), run by every thread of the cluster.
template <typename T, int V>
__device__ __forceinline__ void adapdmp_solve(const Cell& c, SwShared& sm) {
  const long long n = c.n;
  const int rows = c.rows, tid = threadIdx.x;
  const bool l1 = c.h_kind == kHL1;
  const float t = c.t, lam = c.lam;
  const float* __restrict__ bv = c.bv;
  const float delta1 = static_cast<float>(1.0 + kDelta);
  const float gamma0 = 1.f / (static_cast<float>(2.0 * kThetaBig) * t * c.p2);
  int slot = 0, cp = 0;  // the parities of the sums' and the column partials' slots

  // warm-up: x0 = 0, y0 = 0, so A x0 = 0, A'y0 = 0, v0 = x0 - gamma0 A'y0,
  // x1 = soft(v0, gamma0 lam)
  for (long long j = tid; j < n; j += kThreads) {
    const float vj = 0.f - gamma0 * 0.f;
    c.v[j] = vj;
    c.xs[j] = soft(vj, gamma0 * lam);
    c.at_ys[j] = 0.f;
  }
  for (int i = tid; i < rows; i += kThreads) {
    c.ys[i] = 0.f;
    c.axs[i] = 0.f;
  }
  __syncthreads();

  float gamma = gamma0, gamma_prev = gamma0, eta = c.p2, norm_res = f32_inf();
  int it = 0;
  int px = 0;  // x = xs[px], y = ys[px], A'y = at_ys[px]; x', y', A'y' the other slots
  int pa = 0;  // a_x_prev = axs[pa]; this iteration's A x goes to axs[1 - pa]
  bool ls_failed = false;
  bool go = 0 < c.maxit && norm_res > c.tol;  // a NaN residual stops
  if (!go) write_x(c, c.xs);

  while (go) {
    const float* x = c.xs + px * n;
    float* x_next = c.xs + (1 - px) * n;
    const float* y = c.ys + px * rows;
    float* y_next = c.ys + (1 - px) * rows;
    const float* aty = c.at_ys + px * n;
    float* aty_next = c.at_ys + (1 - px) * n;
    const float* ax_prev = c.axs + pa * rows;
    float* ax = c.axs + (1 - pa) * rows;

    const float xi = t * gamma * eta * delta1;
    const float m4xim1 = 1.f - 4.f * (xi * xi);
    float e = kRDown * eta;
    int trials = 1;
    PdmpStep st = pdmp_step(t, e, gamma, gamma_prev, m4xim1);

    // P1: A x a thread a row, and the first trial's dual step at that row; the primal
    // residual and ||x||_1 over n (local); h's sum over the CTA's rows, kept for P2's sums
    float acc[kSwSums] = {};
    for_each_ax<T, V>(c, x, [&](int i, float axi) {
      ax[i] = axi;
      const float b = bv[i];
      const float diff = axi - b;
      acc[kHVal] += l1 ? fabsf(diff) : diff * diff;
      const float wi = y[i] + st.sigma * ((1.f + st.rho) * axi - st.rho * ax_prev[i]);
      c.w[i] = wi;
      const float z = dual_z(wi, st.sigma, b);
      if (l1) {
        y_next[i] = dual_y(wi, st.sigma, b, soft(z, 1.f / st.sigma));
      } else {
        acc[kZ2] += z * z;
      }
    });
    for (long long j = tid; j < n; j += kThreads) {
      const float xj = x[j];
      const float pr = (c.v[j] - xj) / gamma + aty[j];
      acc[kPrimal2] += pr * pr;
      acc[kAbsX] += fabsf(xj);
    }
    reduce(sm, acc, l1 ? 0u : bit(kZ2), bit(kHVal) | bit(kPrimal2) | bit(kAbsX), slot,
           c.csize);
    const float primal2 = sm.sum[kPrimal2], abs_x = sm.sum[kAbsX], hval_cta = sm.sum[kHVal];
    float z2 = l1 ? 0.f : sm.sum[kZ2];

    for (;;) {
      if (!l1) {
        // NormL2: y' from the block scale of ||z||
        const float scale = l2_scale(z2, st.sigma);
        for (int i = tid; i < rows; i += kThreads) {
          const float wi = c.w[i];
          const float b = bv[i];
          y_next[i] = dual_y(wi, st.sigma, b, scale * dual_z(wi, st.sigma, b));
        }
      }
      __syncthreads();

      // P2: A'y', the CTA's column partials, and the test's sums over its rows (h's sum
      // over the CTA's rows rides along from P1), all published by one cluster barrier
      col_partials<T, V>(c, y_next, cp);
      float tacc[kSwSums] = {};
      for (int i = tid; i < rows; i += kThreads) {
        const float yi = y_next[i];
        const float dy = yi - y[i];
        tacc[kDy2] += dy * dy;
        const float d = (c.w[i] - yi) / st.sigma - ax[i];
        tacc[kDual2] += d * d;
      }
      if (tid == 0) tacc[kHVal] = hval_cta;
      reduce(sm, tacc, bit(kHVal) | bit(kDy2) | bit(kDual2), 0, slot, c.csize);
      const float dy2 = sm.sum[kDy2], dual2 = sm.sum[kDual2], h_sum = sm.sum[kHVal];

      // A'y' from the peers' partials (the same bits in every CTA) and ||A'y' - A'y||^2
      float dacc[kSwSums] = {};
      for (long long j = tid; j < n; j += kThreads) {
        const float atyj = col_sum(c, j, cp);
        aty_next[j] = atyj;
        const float d = atyj - aty[j];
        dacc[kDaty2] += d * d;
      }
      cp ^= 1;
      reduce(sm, dacc, 0, bit(kDaty2), slot, c.csize);

      // the test, from the same sums in every thread: two roots and a division, as
      // JAX computes it (dy = 0 gives NaN, which fails)
      const bool ok = e >= sqrtf(sm.sum[kDaty2]) / sqrtf(dy2);
      if (!ok && trials < kMaxTrials) {
        e = e * kRUp;
        ++trials;
        st = pdmp_step(t, e, gamma, gamma_prev, m4xim1);
        // D: the trial's dual step, over the CTA's rows
        float zacc[kSwSums] = {};
        for (int i = tid; i < rows; i += kThreads) {
          const float b = bv[i];
          const float wi = y[i] + st.sigma * ((1.f + st.rho) * ax[i] - st.rho * ax_prev[i]);
          c.w[i] = wi;
          const float z = dual_z(wi, st.sigma, b);
          if (l1) {
            y_next[i] = dual_y(wi, st.sigma, b, soft(z, 1.f / st.sigma));
          } else {
            zacc[kZ2] += z * z;
          }
        }
        if (!l1) {
          reduce(sm, zacc, bit(kZ2), 0, slot, c.csize);
          z2 = sm.sum[kZ2];
        }
        continue;
      }

      // accepted (or the cap); then the second half x' = soft(x - gamma' A'y', gamma' lam)
      ls_failed = ls_failed || !ok;
      norm_res = sqrtf(primal2 + dual2);
      record_row(c, it, st.gamma_next, st.sigma, norm_res, trials,
                 objective(c, abs_x, h_sum));
      for (long long j = tid; j < n; j += kThreads) {
        const float vj = x[j] - st.gamma_next * aty_next[j];
        c.v[j] = vj;
        x_next[j] = soft(vj, st.gamma_next * lam);
      }
      gamma_prev = gamma;
      gamma = st.gamma_next;
      eta = e;
      ++it;
      go = it < c.maxit && norm_res > c.tol;
      if (!go) {
        // converged: the iterate at the check, not the extra second-half prox point (each
        // thread writes the coordinates it formed)
        const bool conv = norm_res <= c.tol;
        write_x(c, conv ? x : x_next);
      }
      px ^= 1;
      pa ^= 1;
      __syncthreads();
      break;
    }
  }
  finish_row(c, it, norm_res, ls_failed);
}

}  // namespace
