// The solve routines of the dual-SVM coupling sweeps, run by K6a, K6b and K6c, all one kernel
// in resident_dsvm_grid.cu: one whole early-exit AdaPDM solve (pd_solve, JAX's _pd_core) or
// Malitsky-Pock solve with its linesearch (mp_solve, _dsvm_mp_core) run by every thread of one
// thread-block cluster, for one coupling t,
//
//     min 0.5 x'Qx - 1'x   over 0 <= x <= C   with   labels'x = 0,
//
// as f = 0.5 x'Qx - 1'x, g = IndBox(0, C), h = IndZero and A = labels' (1 x N): the dual
// variable y is a scalar and prox_{sigma h*} is the identity. Q is the N x N Gram (dense) or,
// factored, Q = B B' with B (N x d) = D_y X: the gradient is then B (B'x) - 1 and the Gram is
// never formed. Q or B is stored as f32 or bf16; every iterate, reduction and scalar is f32.
// The linear term is masked by i < n_true, so the coordinates a caller zero-padded stay
// exactly 0.
//
// The AdaPDM core (_pd_core, the engine's order), from x0 = 0 (Q x0 = 0, so the warm-up is
// elementwise: grad0 = -1[i < n_true], v = -gamma0 grad0, x = clamp(v)) and y0 = 0:
//     a_x    = labels'x,  grad = Q x - 1[i < n_true]
//     primal = (v - x) / gamma_prev + grad + labels y_prev
//     gamma  <- AdaPGM(||dg||^2, <dg, dx>, ||dx||^2) with the coupling bound;  sigma = gamma t^2
//     y = y_prev + sigma ((1 + rho) a_x - rho a_x_prev),  rho = gamma / gamma_prev
//     norm_res = sqrt(||primal||^2 + a_x^2)          (the dual residual is -a_x)
//     v = x - gamma (grad + labels y);  x' = clamp(v, 0, C)
// The record row (before the second half): gamma, norm_res. On convergence the x of the
// check is returned, not the extra box step.
//
// The Malitsky-Pock core (_dsvm_mp_core, the engine's solvers/malitsky_pock order), from x0 = 0
// (Q x0 = 0, f(0) = 0: the start makes no matvec) and y0 = 0:
//     y = y + sigma a_x;  sigma_prev = sigma;  s = sigma sqrt(2)
//     trial: theta = s / sigma_prev, gamma = t t s,
//            v = x_prev - gamma((1 + theta) labels y - theta labels y_prev + Q x_prev - 1)
//            x = clamp(v, 0, C);  a_x = labels'x;  Q x;  f = 0.5 x.Qx - 1'x
//            breg = f - f_prev - <Q x_prev - 1, dx>, or (exact) max(0.5 <dx, Qx - Qx_prev>, 0)
//            lhs = gamma s (a_x - a_x_prev)^2 + 2 gamma breg
//     halve s while lhs > 0.95 ||dx||^2 and fewer than 101 trials ran; a test still failing at
//     the cap is latched into ls_failed;
//     norm_res = sqrt(||(v - x)/gamma + Q x - 1 + labels y||^2 + a_x^2)
// The accepted trial's Q x and f are the next iteration's Q x_prev and f_prev: one Q matvec a
// trial. The record row: gamma, s, norm_res, trials, f.
//
// What bounds it on the card. An iteration or trial does 2 N^2 flops dense or 4 N d factored
// (0.05 us at 1280^2 on 67 TFLOP/s of f32 outside the tensor cores) and Q or B is read once
// (6.5 MB at 1280^2 f32, 4.2 MB for 8192 x 128): the barriers, the round trips between the SMs
// and the phases' latency set the pace, not bytes or flops.
//
// Design (a row on one cluster of C CTAs; the launcher picks C from the shape and dtype):
//   * CTA k of the cluster owns rows [k R, k R + R) of Q or B, R = ceil(N / C), and keeps the
//     first `held` of them (all where they fit) in shared memory for the whole launch; the rest
//     it reads from device memory (L2) in every pass. (Q x)_i = Q_i . x (or B_i . B'x) a warp a
//     row, kRowsInFlight rows a warp at once (their loads in flight together; one row at a time
//     waited out an L2 round trip a row): lanes over 16-byte groups of the row, a shuffle tree,
//     the same bits from shared or device memory. Q need not be bitwise symmetric (the driver
//     forms it with one matmul), so its rows are dotted, never its columns.
//   * Dense Q: every CTA holds the N-vectors whole (x and x_prev, v, the gradient or Q x by
//     parity, the labels) and updates them elementwise from the same bits, so MP's trial point,
//     AdaPDM's second half and every sum over N are local. Each CTA forms Q x over its own rows
//     into a slice in its shared memory (two slots by parity); after one cluster barrier every
//     CTA reads the peers' slices through distributed shared memory (DSMEM) as it forms the
//     sums. One cluster barrier an AdaPDM iteration or an MP trial.
//   * Factored B: the N-side vectors stay with the rows that own them. Each CTA forms the
//     column partials of B'x over its rows (threads over 16-byte column groups, row groups
//     summed in order); after a cluster barrier every CTA sums the C partials in rank order
//     from DSMEM, so B'x (d values) is whole and equal in every CTA; then (Q x)_i = B_i . B'x
//     for its rows and its sums over them; after a second barrier every CTA sums the C values
//     in rank order. Two cluster barriers an iteration or trial.
//   * Every thread of the cluster takes the step, accept, halve, cap and stop decisions from
//     the same bits (a CTA that decided otherwise would wait at a barrier the others never
//     reach). NaN compares false, as in jnp.
//   * Slots: a CTA writes a slice, a partial or a sum only into a slot no peer can still read:
//     each alternates by parity and is read before the barrier after next; a row starts, and
//     the kernel ends, at a barrier.
//   * IEEE semantics (no fast math, IEEE division and square root, NaN-propagating min/max
//     like jnp.minimum and jnp.clip; -fmad=false, so each elementwise expression rounds after
//     every operation as the plain PyTorch version does; the dot products use explicit fmaf).
//
// Every function is deterministic: one fixed order of every sum, no atomics, and a row's
// arithmetic depends on the shape, the dtype and C only, not on which cluster runs it, when,
// or beside which other rows.

#pragma once

#include "resident_common.cuh"

namespace {

// The cores (the entries' argument).
enum DsvmCore { kCoreAdapdm = 0, kCoreMp = 1 };
// the initial trial and up to 100 halvings (the engine's _MAX_TRIALS = 100)
constexpr int kMaxTrials = 101;
// the largest cluster (the portable size)
constexpr int kMaxCluster = 8;
// the rows a warp dots at once (their loads in flight together)
constexpr int kRowsInFlight = 4;

// The sums an iteration or trial forms: AdaPDM's labels'x, ||dg||^2, <dg, dx>, ||dx||^2 and
// ||primal||^2; MP's labels'x, ||dx||^2, x.Qx, 1'x, <dx, Qx - Qx_prev>, <Qx_prev - 1, dx> and
// ||primal||^2.
enum DsSum { kAx = 0, kDx2, kPrimal2, kDg2, kDgDx, kXqx, kLin, kDq, kGdx, kDsSums };
__host__ __device__ constexpr unsigned bit(int k) { return 1u << k; }
constexpr unsigned kPdSums = bit(kAx) | bit(kDx2) | bit(kPrimal2) | bit(kDg2) | bit(kDgDx);
constexpr unsigned kMpSums =
    bit(kAx) | bit(kDx2) | bit(kPrimal2) | bit(kXqx) | bit(kLin) | bit(kDq) | bit(kGdx);

// A CTA's scalars and reduction scratch (static shared memory).
struct DsShared {
  float warp_part[kDsSums][kWarps];
  float part[2][kDsSums];  // factored: this CTA's sums by parity (its peers read them)
  float sum[kDsSums];      // the reduced sums
  int row[2];              // rank 0's: the row it took, by parity
  int row_now;
};

// One row as one CTA of its cluster sees it. The kept vectors cover every coordinate
// (dense) or the CTA's own rows (factored): `len` of them from coordinate `off`.
struct Row {
  const void* q_g;  // this CTA's first row of Q or B in device memory (row length `units` V)
  const void* q_s;  // the first `held` of its rows in shared memory (the same stride)
  int rows, held, rows_per;  // the rows it owns, those it holds, R
  long long n, units;        // N; the row length in groups of V
  long long len, off;        // the kept coordinates
  const float* lab;  // (len,)
  float* xs;         // (2, len): x by parity
  float* gs;         // (2, len): AdaPDM the gradient (slot 0); MP Q x by the parity of x
  float* v;          // (len,)
  float* qslot;      // dense: (2, R): this CTA's slice of Q x by parity (its peers read it)
  float* colpart;    // factored: (2, d): its column partials of B'x by parity (its peers read)
  float* btx;        // factored: (d,)
  float* red;        // factored: (kThreads V,): the row groups' column partials
  int rank, csize, n_true;
  float big_c;
  // the row's scalars and outputs
  float t, p1, p2, tol;  // AdaPDM: p1 = ||labels||, p2 = Theta; MP: p1 = sigma0
  int exact, maxit, record, hist_len;
  float* x_out;  // (n,)
  float* stats;  // (4,): AdaPDM numit, norm_res, gamma, converged; MP numit, norm_res,
                 // converged, ls_failed
  float* hist;   // AdaPDM (2, hist_len): gamma, norm_res; MP (5, hist_len)
};

__device__ __forceinline__ float clamp_box(float v, float big_c) {
  return nan_min(nan_max(v, 0.f), big_c);
}

// The sum of v over a warp, in lane 0: a shuffle tree, one fixed order.
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// V consecutive values of a row held in shared memory (plain loads), as floats.
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
      const float2 f = __bfloat1622float2(h[q]);
      out[2 * q] = f.x;
      out[2 * q + 1] = f.y;
    }
  }
}

// V values of a row at column group u: from shared memory or (read-only) device memory.
template <bool kShared, typename T, int V>
__device__ __forceinline__ void row_vals(const T* row, long long u, float* out) {
  if constexpr (kShared) {
    load_s<V>(row + u * V, out);
  } else {
    load_a<V>(row + u * V, out);
  }
}

// Rows of the CTA dotted with vec, kRowsInFlight rows a warp at a time: warp w takes the rows
// lo + w, lo + w + kWarps, ... below hi, all of them in shared memory (kShared) or all in
// device memory; lane k takes the column groups k, k + 32, ... of each of its rows, the loads
// of all of them in flight together, then a shuffle tree a row; body(i, Q_i . vec) in lane 0.
// A row's dot is the same sum in the same order wherever it is kept.
template <bool kShared, typename T, int V, typename Body>
__device__ __forceinline__ void rows_dot(const Row& c, const T* q, int lo, int hi,
                                         const float* vec, Body&& body) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long units = c.units, stride = units * V;
  for (int i0 = lo + warp; i0 < hi; i0 += kRowsInFlight * kWarps) {
    const T* rows[kRowsInFlight];
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
      const int i = i0 + r * kWarps;
      rows[r] = q + static_cast<long long>(i < hi ? i : i0) * stride;  // past hi: read, unused
    }
    float acc[kRowsInFlight];
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) acc[r] = 0.f;
    for (long long u = lane; u < units; u += 32) {
      float xv[V];
      load_f32<V>(vec + u * V, xv);
      float av[kRowsInFlight][V];
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) row_vals<kShared, T, V>(rows[r], u, av[r]);
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
#pragma unroll
        for (int q = 0; q < V; ++q) acc[r] = fmaf(av[r][q], xv[q], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) acc[r] = lane_sum(acc[r]);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        if (i0 + r * kWarps < hi) body(i0 + r * kWarps, acc[r]);
      }
    }
  }
}

// For each row i the CTA owns: body(i, Q_i . vec) in lane 0 (dense: vec = x; factored: vec =
// B'x); the rows held in shared memory, then those read from device memory.
template <typename T, int V, typename Body>
__device__ __forceinline__ void for_each_own_row(const Row& c, const float* vec, Body&& body) {
  rows_dot<true, T, V>(c, static_cast<const T*>(c.q_s), 0, c.held, vec, body);
  rows_dot<false, T, V>(c, static_cast<const T*>(c.q_g), c.held, c.rows, vec, body);
}

// acc[q] += B_iq x_i over the rows i = i0, i0 + step, ... below i1 at column group u.
template <bool kShared, typename T, int V>
__device__ __forceinline__ int col_rows(const T* b, long long stride, const float* x, int i0,
                                        int i1, int step, long long u, float* acc) {
  int i = i0;
#pragma unroll 8
  for (; i < i1; i += step) {
    float bv[V];
    row_vals<kShared, T, V>(b + static_cast<long long>(i) * stride, u, bv);
    const float xi = x[i];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = fmaf(bv[q], xi, acc[q]);
  }
  return i;
}

// out[j] = sum over the CTA's rows i of B_ij x_i: thread (g, u) takes column group u over the
// rows g, g + G, ... (G = kThreads / min(d / V, kThreads) row groups; those in shared memory
// first), then the G group sums of each column are added in order through red. Every thread
// calls it; it ends with a block barrier.
template <typename T, int V>
__device__ void col_partials(const Row& c, const float* x, float* out) {
  const long long units = c.units, stride = units * V;
  const int jw = static_cast<int>(units < kThreads ? units : kThreads);
  const int groups = kThreads / jw;
  const int g = threadIdx.x / jw, ju = threadIdx.x % jw;
  for (long long u0 = 0; u0 < units; u0 += jw) {
    const long long u = u0 + ju;
    float acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = 0.f;
    if (g < groups && u < units) {
      const int i = col_rows<true, T, V>(static_cast<const T*>(c.q_s), stride, x, g, c.held,
                                         groups, u, acc);
      col_rows<false, T, V>(static_cast<const T*>(c.q_g), stride, x, i, c.rows, groups, u, acc);
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

// Q x at x, handed to body(j, (Q x)_j) for every kept coordinate j (dense: by the thread of
// j, j = threadIdx.x + k kThreads; factored: by lane 0 of the warp of row j). Dense: the CTA's
// slice into qslot[slot], a cluster barrier, then each coordinate's value from its owner's
// slice; factored: the column partials into colpart[slot], a cluster barrier, B'x summed in
// rank order, then the CTA's rows. x must be complete in the CTA (a block barrier after it
// was written). Flips slot.
template <typename T, int V, bool kFactored, typename Body>
__device__ __forceinline__ void qx_pass(const Row& c, const float* x, int& slot, Body&& body) {
  cg::cluster_group cl = cg::this_cluster();
  if constexpr (kFactored) {
    const long long d = c.units * V;
    float* part = c.colpart + slot * d;
    col_partials<T, V>(c, x, part);
    cl.sync();
    for (long long k = threadIdx.x; k < d; k += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < c.csize) s += cl.map_shared_rank(part, r)[k];
      }
      c.btx[k] = s;
    }
    __syncthreads();
    for_each_own_row<T, V>(c, c.btx, body);
  } else {
    float* mine = c.qslot + slot * c.rows_per;
    for_each_own_row<T, V>(c, x, [&](int i, float s) { mine[i] = s; });
    cl.sync();
    for (long long j = threadIdx.x; j < c.n; j += kThreads) {
      const int owner = static_cast<int>(j / c.rows_per);
      body(j, cl.map_shared_rank(mine, owner)[j - static_cast<long long>(owner) * c.rows_per]);
    }
  }
  slot ^= 1;
}

// The sums of acc[k] for k in `sums` into sm.sum, the same bits in every thread of the
// cluster: the block's sums (a shuffle tree a warp, the warps in order); factored, then over
// the cluster in rank order (a cluster barrier; `slot` alternates). Ends with a block barrier.
// Every thread of the cluster calls it alike.
template <bool kFactored>
__device__ __forceinline__ void reduce(DsShared& sm, const float* acc, unsigned sums, int& slot,
                                       int csize) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kDsSums; ++k) {
    if (!(sums & bit(k))) continue;
    const float s = lane_sum(acc[k]);
    if (lane == 0) sm.warp_part[k][warp] = s;
  }
  __syncthreads();
  const int k = threadIdx.x;
  if (k < kDsSums && (sums & bit(k))) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sm.warp_part[k][w];
    if (kFactored) {
      sm.part[slot][k] = s;
    } else {
      sm.sum[k] = s;
    }
  }
  if constexpr (kFactored) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    if (k < kDsSums && (sums & bit(k))) {
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

// x_out = x: dense, rank 0 writes every coordinate (every CTA holds the same x); factored,
// each CTA its rows.
template <bool kFactored>
__device__ __forceinline__ void write_x(const Row& c, const float* x) {
  if (!kFactored && c.rank != 0) return;
  const long long len = kFactored ? c.rows : c.len;
  for (long long j = threadIdx.x; j < len; j += kThreads) c.x_out[c.off + j] = x[j];
}

// The row's histories zeroed past numit (rank 0).
__device__ __forceinline__ void zero_hist(const Row& c, int it, int rows_of_hist) {
  if (!c.record || c.rank != 0) return;
  const long long hl = c.hist_len;
  for (long long i = it + threadIdx.x; i < hl; i += kThreads) {
    for (int k = 0; k < rows_of_hist; ++k) c.hist[k * hl + i] = 0.f;
  }
}

// One whole AdaPDM solve (_pd_core), run by every thread of the cluster. Every thread carries
// the same scalars and takes the same branches.
template <typename T, int V, bool kFactored>
__device__ void pd_solve(const Row& c, DsShared& sm) {
  const long long len = c.len, hl = c.hist_len;
  const int tid = threadIdx.x;
  const float t = c.t, norm_a = c.p1, theta = c.p2, big_c = c.big_c;
  float* grad = c.gs;  // at the last pass's point
  int slot = 0, ps = 0;  // the parities of the Q x (or B'x) slots and of the sums' slots

  // warm-up (_pd_core :843-849): x0 = 0, so Q x0 = 0 and grad0 = -1[j < n_true];
  // v = x0 - gamma0 grad0 (A'y0 = 0), x = clamp(v); x_prev = x0
  const float gamma0 = 1.f / (2.f * theta * t * norm_a);
  for (long long j = tid; j < len; j += kThreads) {
    const float g = 0.f - (c.off + j < c.n_true ? 1.f : 0.f);
    grad[j] = g;
    c.xs[len + j] = 0.f;
    const float vj = 0.f - gamma0 * g;
    c.v[j] = vj;
    c.xs[j] = clamp_box(vj, big_c);
  }
  __syncthreads();

  // the carry: gamma and y (the previous step's, for the primal residual), g1, g0, a_x_prev
  float gamma = gamma0, g1 = gamma0, g0 = gamma0, y = 0.f, a_x_prev = 0.f;
  float norm_res = f32_inf();
  int it = 0, par = 0;  // x = xs[par], x_prev = xs[1 - par]
  bool go = 0 < c.maxit && norm_res > c.tol;
  bool conv = norm_res <= c.tol;
  if (!go) write_x<kFactored>(c, c.xs);

  while (go) {
    const float* x = c.xs + par * len;
    const float* x_prev = c.xs + (1 - par) * len;
    // Q x; the gradient, the curvature and residual terms at each kept coordinate
    float acc[kDsSums] = {};
    qx_pass<T, V, kFactored>(c, x, slot, [&](long long i, float qx) {
      const float one = c.off + i < c.n_true ? 1.f : 0.f;
      const float g = qx - one;
      const float xi = x[i];
      const float dg = g - grad[i];
      const float dx = xi - x_prev[i];
      grad[i] = g;
      const float li = c.lab[i];
      const float primal = (c.v[i] - xi) / gamma + g + li * y;
      acc[kAx] += li * xi;
      acc[kDg2] += dg * dg;
      acc[kDgDx] += dg * dx;
      acc[kDx2] += dx * dx;
      acc[kPrimal2] += primal * primal;
    });
    reduce<kFactored>(sm, acc, kPdSums, ps, c.csize);

    // the step: AdaPGMRule.update with the coupling (_pd_core :880-892), from the same sums
    // in every thread
    const float* sum = sm.sum;
    const float a_x = sum[kAx];
    float dd = g1 * (g1 * sum[kDg2] - sum[kDgDx]) / sum[kDx2];
    if (isnan(dd)) dd = 0.f;
    const float xi = t * t * g1 * g1 * norm_a * norm_a;
    const float m4 = 1.f - 4.f * xi;
    const float denom = nan_max(dd + sqrtf(dd * dd + xi * m4), 0.f);
    const float step = nan_min(
        g1 * sqrtf(1.f + g1 / g0),
        nan_min(1.f / (2.f * theta * t * norm_a), g1 * sqrtf(m4) / sqrtf(2.f * denom)));
    const float sigma = step * t * t;
    const float rho = step / gamma;
    y = y + sigma * ((1.f + rho) * a_x - rho * a_x_prev);  // prox of (IndZero)* = Zero
    g0 = g1;
    g1 = step;
    gamma = step;
    norm_res = sqrtf(sum[kPrimal2] + a_x * a_x);
    if (c.record && c.rank == 0 && tid == 0) {
      c.hist[it] = gamma;
      c.hist[hl + it] = norm_res;
    }
    a_x_prev = a_x;
    ++it;
    go = it < c.maxit && norm_res > c.tol;  // a NaN residual stops
    conv = norm_res <= c.tol;

    // the second half: the next point, elementwise over the kept coordinates
    float* x_new = c.xs + (1 - par) * len;
    for (long long j = tid; j < len; j += kThreads) {
      const float xj = x[j];
      const float vj = xj - gamma * (grad[j] + c.lab[j] * y);
      c.v[j] = vj;
      x_new[j] = clamp_box(vj, big_c);
    }
    __syncthreads();
    par ^= 1;
    // converged: the iterate at the check, not the extra box step (:921-925)
    if (!go) write_x<kFactored>(c, conv ? x : x_new);
  }

  if (c.rank == 0 && tid == 0) {
    c.stats[0] = static_cast<float>(it);
    c.stats[1] = norm_res;
    c.stats[2] = gamma;
    c.stats[3] = conv ? 1.f : 0.f;
  }
  zero_hist(c, it, 2);
}

// One whole Malitsky-Pock solve (_dsvm_mp_core), run by every thread of the cluster. Every
// thread carries the same scalars and takes the same branches.
template <typename T, int V, bool kFactored>
__device__ void mp_solve(const Row& c, DsShared& sm) {
  const long long len = c.len, hl = c.hist_len;
  const int tid = threadIdx.x;
  const float t = c.t, big_c = c.big_c;
  const float sqrt2 = sqrtf(2.f);
  int slot = 0, ps = 0;  // the parities of the Q x (or B'x) slots and of the sums' slots

  // the start: x0 = 0 and Q x0 = 0 in the parity-0 buffers
  for (long long j = tid; j < len; j += kThreads) {
    c.xs[j] = 0.f;
    c.gs[j] = 0.f;
  }
  __syncthreads();

  float y = 0.f, a_x = 0.f, f_x = 0.f, sigma = c.p1, norm_res = f32_inf();
  int it = 0, par = 0;  // x = xs[par], Q x = gs[par]: the last accepted trial's
  bool ls_failed = false;
  bool go = 0 < c.maxit && norm_res > c.tol;
  if (!go) write_x<kFactored>(c, c.xs);

  while (go) {
    const float* x_prev = c.xs + par * len;
    const float* qx_prev = c.gs + par * len;
    float* x = c.xs + (1 - par) * len;
    float* qx = c.gs + (1 - par) * len;
    // the dual step: w = y + sigma a_x, y = prox of (IndZero)* = Zero: the identity
    const float y_prev = y;
    y = y + sigma * a_x;
    const float sigma_prev = sigma;
    float st = sigma * sqrt2;
    int trials = 1;
    for (;;) {
      const float theta = st / sigma_prev;
      const float gamma = t * t * st;

      // T: the trial point over the kept coordinates
      for (long long j = tid; j < len; j += kThreads) {
        const float one = c.off + j < c.n_true ? 1.f : 0.f;
        const float lj = c.lab[j];
        const float ybar = (1.f + theta) * (lj * y) - theta * (lj * y_prev);
        const float vj = x_prev[j] - gamma * (ybar + (qx_prev[j] - one));
        c.v[j] = vj;
        x[j] = clamp_box(vj, big_c);
      }
      __syncthreads();

      // Q x and the trial's terms at each kept coordinate
      float acc[kDsSums] = {};
      qx_pass<T, V, kFactored>(c, x, slot, [&](long long i, float qxi) {
        const float one = c.off + i < c.n_true ? 1.f : 0.f;
        const float xi = x[i];
        const float qpi = qx_prev[i];
        const float li = c.lab[i];
        const float dx = xi - x_prev[i];
        qx[i] = qxi;
        const float primal = (c.v[i] - xi) / gamma + (qxi - one) + li * y;
        acc[kAx] += li * xi;
        acc[kDx2] += dx * dx;
        acc[kXqx] += xi * qxi;
        acc[kLin] += one * xi;
        acc[kDq] += dx * (qxi - qpi);
        acc[kGdx] += (qpi - one) * dx;
        acc[kPrimal2] += primal * primal;
      });
      reduce<kFactored>(sm, acc, kMpSums, ps, c.csize);

      // the test, from the same sums in every thread
      const float* sum = sm.sum;
      const float a_new = sum[kAx];
      const float f_new = 0.5f * sum[kXqx] - sum[kLin];
      const float dax = a_new - a_x;
      const float breg = c.exact ? nan_max(0.5f * sum[kDq], 0.f) : f_new - f_x - sum[kGdx];
      const float lhs = gamma * st * dax * dax + 2.f * gamma * breg;
      const bool failed = lhs > 0.95f * sum[kDx2];
      if (failed && trials < kMaxTrials) {
        st = st / 2.f;
        ++trials;
        continue;
      }

      // accepted (or the cap): the carry moves to this trial
      ls_failed = ls_failed || failed;
      norm_res = sqrtf(sum[kPrimal2] + a_new * a_new);  // the dual residual is -a_x
      if (c.record && c.rank == 0 && tid == 0) {
        c.hist[it] = gamma;
        c.hist[hl + it] = st;
        c.hist[2 * hl + it] = norm_res;
        c.hist[3 * hl + it] = static_cast<float>(trials);
        c.hist[4 * hl + it] = f_new;
      }
      a_x = a_new;
      f_x = f_new;
      sigma = st;
      ++it;
      par ^= 1;
      go = it < c.maxit && norm_res > c.tol;  // a NaN residual stops
      if (!go) write_x<kFactored>(c, x);
      break;
    }
  }

  if (c.rank == 0 && tid == 0) {
    c.stats[0] = static_cast<float>(it);
    c.stats[1] = norm_res;
    c.stats[2] = norm_res <= c.tol ? 1.f : 0.f;
    c.stats[3] = ls_failed ? 1.f : 0.f;
  }
  zero_hist(c, it, 5);
}

}  // namespace
