// K2 and K2c for Hopper: whole proximal-gradient solves of f(x) + g(x) in one
// cooperative kernel launch, with f the least-squares loss 0.5 ||A x - b||^2
// (obj_kind "ls"), the mean logistic loss of the rows of A with labels b in
// {0, 1} (obj_kind "logreg", the bias folded into A as a ones column), or the
// cubic model 0.5 x'Hx + q'x + (c/6)||x||^3 with A = H (n x n, symmetric) and
// b = q (obj_kind "cubic").
//
// Replaces the Pallas TPU kernels of adaprox_tpu/ops/resident.py for every
// obj_kind they take ("ls", "logreg", "cubic"):
//   K2   resident_adapgm (bodies _kernel / _kernel_rec, core _solve_core): one solve;
//   K2c  resident_rule_sweep (body _rule_sweep_kernel_rec): R method rows of one
//        problem, each with its own gamma0, tol, rule, momentum flag and iteration
//        cap, always in record mode;
//   K2b  resident_adapgm_batch (body _batch_kernel): B independent problems, each
//        with its own A, b, x0 and [gamma0, tol, p1, p2, cube_c], no record mode.
// Step-size rules fixed / Malitsky-Mishchenko / AdaPGM, or the Nesterov momentum
// body (fixed_nesterov with mu = 0); prox l1 / box / elastic / zero; optional
// per-iteration records. A is stored as f32 or bf16; every iterate, reduction and
// scalar is f32.
//
// The objective is a runtime switch, the same for every thread of the launch (a
// uniform branch: no divergence). For "logreg" (_obj_split's logreg branch) the
// wrapper passes A^T already divided by m_true (in A's storage type, as the TPU
// kernel's caller does); P1 forms z_r = A_r x and writes d_r = sigmoid(z_r) - b_r
// where "ls" writes the residual, so P2 (grad = (A^T / m_true) d) is the same
// code for both; the objective partial is sum_r (b_r - 1) z_r - softplus(-z_r),
// and f = -(partial + pad_rows log 2) / m_true, each zero-padded row of A adding
// exactly -log 2 to the raw sum.
//
// For "cubic" (_obj_split's cubic branch) the gradient H x + q + (c ||x|| / 2) x
// comes from one matvec, and ||x|| must be known before it. P1 writes res = H x
// (no - q) and, from lane 0 of row r (m = n, so row r is coordinate r), the
// partials of ||x||^2 and of x_r (H x)_r + 2 q_r x_r; P2 starts with every warp
// summing the ||x||^2 partials in the fixed order of P3's sums (the same bits
// in every CTA) and forms grad_j = (res_j + q_j) + (||x|| c / 2) x_j
// elementwise, with no dot product over A^T. f = S / 2 + ||x||^3 c / 6 from
// P1's sums, algebraically the JAX kernel's (<x, grad> + <q, x>) / 2 -
// ||x||^3 c / 12; the momentum body's P1' gives the same partials at x_new.
// The wrapper passes A itself as the second layout, which "cubic" never reads.
//
// What bounds it on the card. The data-sheet bound is the arithmetic: A is read
// from device memory once (16.8 MB at 4096x1024 f32, 5 us at 3.35 TB/s), while
// each iteration does 4 m n flops (6 m n for a momentum iteration in record mode;
// 0.25 us at 4096x1024 on 67 TFLOP/s of f32 outside the tensor cores). In practice
// two things hold it back: each iteration streams A and its transpose from L2
// (2 m n itemsize bytes, 33.5 MB at 4096x1024 f32), and it waits at three or four
// grid-wide barriers.
//
// Design (first, simple version):
//   * On the TPU, A sat in one core's VMEM. Here A and A^T (both layouts, as in
//     the TPU kernel, so both matvecs are the same warp-per-row dot product)
//     stay in global memory; at the reference size both fit the 50 MB L2, so
//     after the first iteration every pass reads L2. The vectors live in global
//     memory too, so any shape runs, including ones whose x or residual would
//     not fit a CTA's shared memory.
//   * One persistent cooperative launch, at most one CTA per SM. A rule
//     iteration is three phases with a grid sync after each:
//       P1  res = A x - b, rows over the warps of the grid; each CTA writes its
//           partial of ||res||^2;
//       P2  grad = A^T res, rows of A^T (columns j) over the warps; for its j the
//           CTA writes partials of ||primal||^2, ||dg||^2, <dg, dx>, ||dx||^2,
//           sum |x| and sum x^2;
//       P3  every CTA sums all partials in the same fixed order and computes the
//           rule's step, the stop test and (CTA 0) the record row; then each CTA
//           writes v and x_new = prox(v) for its share of j.
//     The warm-up of _solve_core is one P1/P2 before the loop. A momentum
//     iteration (_solve_core's body_mom) is
//       P0  theta and beta, computed by every thread from the same bits, and
//           z = x + beta (x - x_prev) for the thread's columns;
//       P1  res = A z - b;
//       P2  grad = A^T res, x_new = prox(z - gamma grad) and the partials of
//           ||x_new - z||^2, sum |x_new| and sum x_new^2;
//       P1' (record mode only) the partial of ||A x_new - b||^2, for the
//           objective at x_new;
//       P3  the sums, norm_res = ||x_new - z|| / gamma, the record row and the
//           stop test.
//   * Every CTA computes the scalars itself from the same partials in the same
//     order, so all CTAs reach bit-identical stop decisions: no CTA leaves the
//     loop while another waits at a barrier. No atomics anywhere: two launches on
//     the same inputs give the same bits.
//   * K2 and K2b run the same device routine (solve below). K2b walks its
//     instances one after another, every CTA in the same order, with a grid sync
//     between two. The same shape gives the same grid, so instance i of a batch
//     is bit-identical to one K2 launch with its arguments. K2b's instances share
//     the scratch; their A is read through a batch stride, which is 0 when every
//     instance solves over one A (a regularization path): one copy of A and of
//     A^T serves them all.
//   * K2c runs the rows of a sweep in lockstep groups on K2's grid (below): one
//     pass over A serves every row of a group, and the rows share the grid
//     syncs. Each row keeps K2's scratch and K2's order of every sum, so row j of
//     a sweep is bit-identical to one K2 launch with its arguments.
//   * IEEE semantics are part of the algorithm: AdaPGM divides by sqrt(0) on
//     purpose and min() drops the inf; 0/0 is guarded to 0; MM guards
//     isfinite(g0). So no fast math, no flush to zero, IEEE division and
//     square root, NaN-propagating min/max like jnp.minimum/maximum. The build
//     also passes -fmad=false, so each elementwise expression rounds after every
//     operation as the plain PyTorch version does; the dot products use explicit
//     fmaf.

#include "resident_common.cuh"

namespace {

enum Rule { kFixed = 0, kMM = 1, kAdaPGM = 2 };
// Per-CTA partial sums: part[k * grid + cta]. P1 (phase_res) writes kRes2, which
// holds ||res||^2 ("ls"), the raw logistic sum ("logreg") or ||x||^2 of P1's point
// ("cubic"; every CTA reads it in P2, so P2 writes none of P1's slots), and for
// "cubic" kObj, the sum of x_r (H x)_r + 2 q_r x_r (the other objectives leave
// it as the caller zeroed it). P2 writes the rest: kPrimal2 holds ||primal||^2 in a rule iteration and
// ||x_new - z||^2 in a momentum iteration; kX2 is the elastic g's sum x^2.
enum Part { kRes2 = kP1F, kObj = kP1Obj, kPrimal2, kDg2, kDgDx, kDx2, kAbsX, kX2, kParts };
static_assert(kPrimal2 == kP1Breg, "K2 passes no res_prev: P1 writes kRes2 and kObj only");

// K2's use of the scratch: xs (2, n) x and x_prev by parity, gs (2, n) grad and
// grad_prev by parity, v (n) v of a rule iteration or z of a momentum iteration,
// res (m) A x - b, sigmoid(A x) - b ("logreg") or H x ("cubic").

// One solve: K2's arguments, or an instance of K2b.
struct Solve {
  float gamma0, tol;
  int rule, momentum, cap;
  float* x_out;  // (n,)
  float* stats;  // (4,): numit, norm_res, gamma, converged
  float* hist;   // (3, hist_len): gamma, norm_res, objective rows; null unless record
};

// One step-size update, resident.py::_rule_adapgm / _rule_mm / _rule_fixed, on
// the carry (gamma, g1, g0).
__device__ void rule_update(int rule, float ndg2, float dgdx, float ndx2, float& gamma,
                            float& g1, float& g0) {
  if (rule == kAdaPGM) {
    float dd = g1 * (g1 * ndg2 - dgdx) / ndx2;
    if (isnan(dd)) dd = 0.f;
    const float denom = nan_max(dd + sqrtf(dd * dd), 0.f);
    const float step = nan_min(g1 * sqrtf(1.f + g1 / g0), g1 / sqrtf(2.f * denom));
    g0 = g1;
    g1 = step;
    gamma = step;
  } else if (rule == kMM) {
    const float lip = sqrtf(ndg2) / sqrtf(ndx2);
    const float growth = isfinite(g0) ? sqrtf(1.f + g0) * g1 : f32_inf();
    const float step = isnan(lip) ? growth : nan_min(growth, 1.f / (2.f * lip));
    g0 = step / g1;
    g1 = step;
    gamma = step;
  } else {
    gamma = g1;
  }
}

// One whole solve (_solve_core, rule or momentum body), run by every thread of
// the grid. Returns with every CTA past its last grid sync of the solve; the
// caller syncs before the scratch is used again.
template <typename T, int VA, int VT>
__device__ void solve(const Problem& p, const Solve& s) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float warp_part[kParts][kWarps];
  __shared__ float s_gamma;
  __shared__ int s_go, s_conv, s_numit;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * kThreads;
  const long long n = p.n;
  const long long hl = p.hist_len;

  // P1 (resident_common.cuh): res = A x - b and the objective's partials
  auto phase_p1 = [&](const float* x) {
    phase_res<T, VA, false>(p, x, p.res, nullptr, warp_part);
  };

  // P3's sums, in warp 0.
  auto sum_partials = [&](float* sum) {
#pragma unroll
    for (int k = 0; k < kParts; ++k) sum[k] = sum_part(p.part, k, lane);
  };

  // the record row: gamma, norm_res and f + g at the iterate the partials cover
  auto record_row = [&](int it, float gamma, float norm_res, const float* sum) {
    s.hist[it] = gamma;
    s.hist[hl + it] = norm_res;
    s.hist[2 * hl + it] =
        objective_of(p, sum[kRes2], sum[kObj]) + gval_of(p, sum[kAbsX], sum[kX2]);
  };

  // The carry of _solve_core. Thread 0 of every CTA holds (it, g1, g0, norm_res)
  // and computes the same values; every thread holds gamma and theta.
  float gamma = s.gamma0, g1 = s.gamma0;
  float g0 = s.rule == kMM ? f32_inf() : s.gamma0;
  float theta = 0.f;
  float norm_res = f32_inf();
  int it = 0;
  int par = 0;  // x = xs[par], x_prev = xs[1 - par], grad_prev = gs[1 - par]

  if (s.momentum) {
    // x = x_prev = x0 (_solve_core :341-345). The first reads of these copies
    // (P0 below, or the exit) are by the same thread for each j: no sync.
    for (long long j = gtid; j < n; j += nthreads) {
      p.xs[j] = p.x0[j];
      p.xs[n + j] = p.x0[j];
    }
  } else {
    // warm-up (_solve_core :224-226): grad0 at x0, v = x0 - gamma0 grad0,
    // x = prox(v); x_prev = x0 goes to xs[1], grad_prev = grad0 to gs[1]. The
    // momentum body does not use it, so momentum solves skip it.
    phase_p1(p.x0);
    grid.sync();
    for_each_grad<T, VT>(p, p.x0, p.res, [&](long long j, float g) {
      const float x0j = p.x0[j];
      p.gs[n + j] = g;
      p.xs[n + j] = x0j;
      const float vj = x0j - s.gamma0 * g;
      p.v[j] = vj;
      p.xs[j] = prox(p.prox, vj, s.gamma0, p.p1, p.p2);
    });
    grid.sync();
  }

  bool go = 0 < s.cap && norm_res > s.tol;
  bool conv = norm_res <= s.tol;
  if (!go) {
    for (long long j = gtid; j < n; j += nthreads) s.x_out[j] = p.xs[j];
  }

  if (s.momentum) {
    while (go) {
      const float* x = p.xs + par * n;
      float* x_new = p.xs + (1 - par) * n;  // holds x_prev until P2 overwrites it
      float* z = p.v;

      // P0 (_solve_core :270-272)
      const float theta_next = (1.f + sqrtf(1.f + 4.f * theta * theta)) / 2.f;
      const float beta = (theta - 1.f) / theta_next;
      theta = theta_next;
      for (long long j = gtid; j < n; j += nthreads) {
        const float xj = x[j];
        z[j] = xj + beta * (xj - x_new[j]);
      }
      grid.sync();

      // P1
      phase_p1(z);
      grid.sync();

      // P2: grad = A^T res at z, x_new = prox(z - gamma grad), the partials
      float acc[kParts] = {};
      for_each_grad<T, VT>(p, z, p.res, [&](long long j, float g) {
        const float zj = z[j];
        const float xn = prox(p.prox, zj - gamma * g, gamma, p.p1, p.p2);
        x_new[j] = xn;
        const float d = xn - zj;
        acc[kPrimal2] += d * d;
        acc[kAbsX] += fabsf(xn);
        acc[kX2] += xn * xn;
      });
      if (lane == 0) {
#pragma unroll
        for (int k = kPrimal2; k < kParts; ++k) warp_part[k][warp] = acc[k];
      }
      write_partials(warp_part, p.part, kPrimal2, kParts);
      grid.sync();

      // P1': the objective at x_new costs one more forward matvec (:276-280);
      // "cubic" rewrites P1's partials, which P2 has finished reading
      if (p.record) {
        phase_p1(x_new);
        grid.sync();
      }

      // P3
      if (warp == 0) {
        float sum[kParts];
        sum_partials(sum);
        if (lane == 0) {
          norm_res = sqrtf(sum[kPrimal2]) / gamma;
          if (p.record && blockIdx.x == 0) record_row(it, gamma, norm_res, sum);
          ++it;
          s_go = it < s.cap && norm_res > s.tol;  // a NaN residual stops
          s_conv = norm_res <= s.tol;
        }
      }
      __syncthreads();
      go = s_go != 0;
      conv = s_conv != 0;
      // the residual is checked at x_new, which is returned either way
      if (!go) {
        for (long long j = gtid; j < n; j += nthreads) s.x_out[j] = x_new[j];
      }
      par ^= 1;
      // no sync here: the next P0 writes only z, which the last reader (P2) is
      // past, and P0's sync comes before the next write of the partials
    }
  } else {
    while (go) {
      const float* x = p.xs + par * n;
      const float* x_prev = p.xs + (1 - par) * n;
      float* grad = p.gs + par * n;
      const float* grad_prev = p.gs + (1 - par) * n;

      // P1
      phase_p1(x);
      grid.sync();

      // P2: grad = A^T res, and the partials over this CTA's columns
      float acc[kParts] = {};
      for_each_grad<T, VT>(p, x, p.res, [&](long long j, float g) {
        grad[j] = g;
        const float xj = x[j];
        const float primal = (p.v[j] - xj) / gamma + g;
        const float dg = g - grad_prev[j];
        const float dx = xj - x_prev[j];
        acc[kPrimal2] += primal * primal;
        acc[kDg2] += dg * dg;
        acc[kDgDx] += dg * dx;
        acc[kDx2] += dx * dx;
        acc[kAbsX] += fabsf(xj);
        acc[kX2] += xj * xj;
      });
      if (lane == 0) {
#pragma unroll
        for (int k = kPrimal2; k < kParts; ++k) warp_part[k][warp] = acc[k];
      }
      write_partials(warp_part, p.part, kPrimal2, kParts);
      grid.sync();

      // P3: thread 0 steps the carry
      if (warp == 0) {
        float sum[kParts];
        sum_partials(sum);
        if (lane == 0) {
          norm_res = sqrtf(sum[kPrimal2]);
          rule_update(s.rule, sum[kDg2], sum[kDgDx], sum[kDx2], gamma, g1, g0);
          // objective at the current x, gamma the step just updated (:297-306)
          if (p.record && blockIdx.x == 0) record_row(it, gamma, norm_res, sum);
          ++it;
          s_gamma = gamma;
          s_go = it < s.cap && norm_res > s.tol;  // a NaN residual stops
          s_conv = norm_res <= s.tol;
        }
      }
      __syncthreads();
      gamma = s_gamma;
      go = s_go != 0;
      conv = s_conv != 0;
      float* x_new = p.xs + (1 - par) * n;
      for (long long j = gtid; j < n; j += nthreads) {
        const float xj = x[j];
        const float vj = xj - gamma * grad[j];
        p.v[j] = vj;
        const float xn = prox(p.prox, vj, gamma, p.p1, p.p2);
        x_new[j] = xn;
        // converged: the iterate at the check, not the extra prox step (:360-363)
        if (!go) s.x_out[j] = conv ? xj : xn;
      }
      if (go) grid.sync();
      par ^= 1;
    }
  }

  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) {
      s.stats[0] = static_cast<float>(it);
      s.stats[1] = norm_res;
      s.stats[2] = gamma;
      s.stats[3] = conv ? 1.f : 0.f;
    }
    if (p.record) {
      // records are zero past numit; thread 0's it is the numit of every CTA
      if (threadIdx.x == 0) s_numit = it;
      __syncthreads();
      for (long long i = s_numit + threadIdx.x; i < hl; i += kThreads) {
        s.hist[i] = 0.f;
        s.hist[hl + i] = 0.f;
        s.hist[2 * hl + i] = 0.f;
      }
    }
  }
}

// K2: one solve.
template <typename T, int VA, int VT>
__global__ void __launch_bounds__(kThreads, 1) resident_pg_kernel(const Problem p,
                                                                 const Solve s) {
  solve<T, VA, VT>(p, s);
}

// -- K2c: the rows of a group in lockstep -------------------------------------------
//
// The rows of a sweep solve one problem (the same A, b and x0); only gamma0, tol,
// rule, momentum and cap differ. So K2c runs up to kGroup rows at once on K2's
// grid: each pass over A (or A^T) takes a row of A and dots it with the vector of
// every row still running, and every row waits at the same grid syncs. Row g of a
// group keeps K2's scratch of its own: xs + 2gn, gs + 2gn, v + gn, res + gm and
// the partials part[(g kParts + k) grid + cta]. Each of its sums runs in K2's
// order (group_dot, group_partials, sum_part), so row g is K2's launch with its
// arguments bit for bit, whatever group it lands in, wherever it sits there and
// whatever else runs beside it.
//
// A lockstep iteration of a group, with a grid sync after each phase:
//   A  each row that ran B-D takes its P3 from its own partials (lane 0 of warp
//      g: the rule's step, the record row, the stop test); then, elementwise over
//      (row, coordinate) pairs, a rule row writes v and x_new = prox(v), a
//      momentum row that goes on its next P0, z = x + beta (x - x_prev), and a row
//      that stops its x_out; CTA 0 writes a stopped row's stats and zeroes its
//      history past numit. The group ends here when no row goes on (no sync).
//   B  P1 for every running row: at x (rule) or at z (momentum);
//   C  P2 for every running row; a momentum row also its prox and partials;
//   D  P1' at x_new for the running momentum rows (K2c always records).
// So 4 syncs an iteration while a momentum row runs, 3 otherwise, for the whole
// group: K2 pays 3 or 4 a row. In B-D lane g of a warp takes row g's terms after
// the dots. The rule rows' warm-up (one P1 and one gradient at x0, the same bits
// for every rule row) runs once before the loop, with the momentum rows' copy of
// x0. Every branch is taken on state in shared memory that every CTA computes
// from the same sums: no CTA leaves while another waits at a barrier. A table of
// more than kGroup rows runs its groups in turn, with a grid sync between two
// (the next group reuses the scratch).
//
// The rows' vectors stay in device memory and are read through the L1, as K2
// reads its own. Copied into shared memory for a pass ("staged"), they made a
// pass of eight rows at 4096x1024 about a quarter faster, but every driver's
// sweep slower or no faster (the copy's round trip and barrier), and the staged
// form of the dot spilled or lost its loads in flight (PERF.md, PR 23).

// K2c's table and its outputs.
struct Rows {
  const float* f;  // (count, 2): gamma0, tol
  const int* i;    // (count, 3): rule, momentum, cap
  int count;
  float* x_out;    // (count, n)
  float* stats;    // (count, 4)
  float* hist;     // (count, 3, hist_len)
};

// A row's arguments and carry, in shared memory. Lane 0 of warp g writes row
// g's in phase A; every thread reads them after the barrier that follows.
struct RowState {
  float gamma0, tol;
  int rule, momentum, cap;
  float gamma, g1, g0, theta, beta, norm_res;
  int it, par;  // x = xs[par] while B-D run; A flips par at P3
  int run;      // runs B-D of this iteration
  int p3;       // took its P3 in this phase A
  int fin;      // stopped in this phase A (or before its first iteration)
  int conv;
};

// write_partials for the rows of `mask`: part[(g kParts + k) grid + cta] = the
// sum over this CTA's warps, in warp order, of wp[g][k], k in [k0, k1).
__device__ __forceinline__ void group_partials(float* part, float (*wp)[kParts][kWarps],
                                               unsigned mask, int k0, int k1) {
  __syncthreads();
  const int span = k1 - k0;
  const int t = threadIdx.x;
  static_assert(kGroup * kParts <= kThreads, "a thread a (row, slot)");
  if (t < kGroup * span && (mask & (1u << (t / span)))) {
    const int g = t / span, k = k0 + t % span;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += wp[g][k][w];
    part[(g * kParts + k) * gridDim.x + blockIdx.x] = s;
  }
}

// Point a pass at its rows' vectors: vec[g] = src(g) for the rows of `mask`.
// Ends with a block barrier.
template <typename Src>
__device__ __forceinline__ void group_vectors(const float** vec, unsigned mask, Src src) {
  if (threadIdx.x < kGroup) {
    const int g = threadIdx.x;
    vec[g] = (mask & (1u << g)) ? src(g) : nullptr;
  }
  __syncthreads();
}

// P1 (phase_res) for the rows of `mask`, row g at vec[g]: res_g = A x_g - b (or
// the logistic or cubic terms) and row g's P1 partials, each in K2's order; lane
// g of the warp that owns row r of A takes row g's terms.
template <typename T, int VA>
__device__ __forceinline__ void group_p1(const Problem& p, unsigned mask, const float** vec,
                                         float (*wp)[kParts][kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gwarp = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  const long long m = p.m, n = p.n;
  const T* __restrict__ a = static_cast<const T*>(p.a);
  const int g = lane;
  const bool mine = g < kGroup && (mask & (1u << g));
  if (mine) wp[g][kP1F][warp] = wp[g][kP1Obj][warp] = 0.f;
  for (long long r = gwarp; r < m; r += nwarps) {
    float d[kGroup];
    group_dot<T, VA>(a + r * n, vec, mask, n, lane, d);
    const float dg = lane_row(d, lane);
    if (!mine) continue;
    const float br = p.b[r];
    float* res = p.res + g * m;
    if (p.obj == kCubic) {
      const float xr = vec[g][r];
      res[r] = dg;
      wp[g][kP1F][warp] += xr * xr;
      wp[g][kP1Obj][warp] += xr * dg + 2.f * (br * xr);
    } else if (p.obj == kLogreg) {
      res[r] = 1.f / (1.f + expf(-dg)) - br;
      // softplus(-z) = logaddexp(0, -z), written stably
      const float softplus_neg = nan_max(-dg, 0.f) + log1pf(expf(-fabsf(dg)));
      wp[g][kP1F][warp] += (br - 1.f) * dg - softplus_neg;
    } else {
      const float rr = dg - br;
      res[r] = rr;
      wp[g][kP1F][warp] += rr * rr;
    }
  }
  group_partials(p.part, wp, mask, kP1F, p.obj == kCubic ? kP1Obj + 1 : kP1F + 1);
}

// The gradient loop (for_each_grad) for the rows of `mask`: body(g, j, grad_j)
// in lane g, row g's gradient at pt(g) from res_g, which vec[g] points at (A^T's
// rows dotted with the rows' res_g); "cubic" elementwise, each row's ||x|| from
// its own P1 partials.
template <typename T, int VT, typename Pt, typename Body>
__device__ __forceinline__ void group_grad(const Problem& p, unsigned mask, const float** vec,
                                           Pt pt, Body&& body) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gwarp = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  const long long m = p.m, n = p.n;
  const int g = lane;
  const bool mine = g < kGroup && (mask & (1u << g));
  if (p.obj == kCubic) {
    float coef = 0.f;
    for (int h = 0; h < kGroup; ++h) {
      if (!(mask & (1u << h))) continue;
      const float c =
          sqrtf(sum_part(p.part + h * kParts * gridDim.x, kP1F, lane)) * p.cube_c / 2.f;
      const float c0 = __shfl_sync(kFull, c, 0);
      if (lane == h) coef = c0;
    }
    if (!mine) return;
    const float* res = vec[g];
    const float* x = pt(g);
    for (long long j = gwarp; j < n; j += nwarps) body(g, j, (res[j] + p.b[j]) + coef * x[j]);
    return;
  }
  const T* __restrict__ at = static_cast<const T*>(p.at);
  for (long long j = gwarp; j < n; j += nwarps) {
    float d[kGroup];
    group_dot<T, VT>(at + j * m, vec, mask, m, lane, d);
    const float dg = lane_row(d, lane);
    if (mine) body(g, j, dg);
  }
}

// K2c: the table's groups in turn, each group's rows in lockstep (above).
template <typename T, int VA, int VT>
__global__ void __launch_bounds__(kThreads, 1) resident_pg_sweep_kernel(const Problem p,
                                                                       const Rows r) {
  cg::grid_group grid = cg::this_grid();
  __shared__ RowState st[kGroup];
  __shared__ float wp[kGroup][kParts][kWarps];
  __shared__ const float* vec[kGroup];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * kThreads;
  const long long m = p.m, n = p.n;
  const long long hl = p.hist_len;
  const int grid_n = gridDim.x;

  for (int first = 0; first < r.count; first += kGroup) {
    // also a block barrier: every thread is done with the previous group's st
    if (first > 0) grid.sync();
    const int G = min(kGroup, r.count - first);
    if (threadIdx.x < G) {
      const int row = first + threadIdx.x;
      RowState& s = st[threadIdx.x];
      s.gamma0 = r.f[2 * row];
      s.tol = r.f[2 * row + 1];
      s.rule = r.i[3 * row];
      s.momentum = r.i[3 * row + 1];
      s.cap = r.i[3 * row + 2];
      s.gamma = s.g1 = s.gamma0;
      s.g0 = s.rule == kMM ? f32_inf() : s.gamma0;
      s.theta = s.beta = 0.f;
      s.norm_res = f32_inf();
      s.it = s.par = s.run = s.p3 = s.fin = s.conv = 0;
    }
    __syncthreads();
    // the group's elementwise work is spread over (row, coordinate) pairs, each
    // pair always to the same thread
    const long long pairs = G * n;
    unsigned rule_rows = 0;
    for (int g = 0; g < G; ++g) {
      if (!st[g].momentum) rule_rows |= 1u << g;
    }
    for (long long t = gtid; t < pairs; t += nthreads) {
      // x = x_prev = x0 for a momentum row (_solve_core :341-345); P0 reads them in
      // the same thread
      const int g = static_cast<int>(t / n);
      const long long j = t - g * n;
      if (st[g].momentum) p.xs[2 * n * g + j] = p.xs[2 * n * g + n + j] = p.x0[j];
    }
    if (rule_rows) {
      // the rule rows' warm-up (_solve_core :224-226): P1 and the gradient at
      // x0, the same bits for every rule row, computed once into the first's
      // res and partials; then each row's v = x0 - gamma0 grad0, x = prox(v),
      // x_prev = x0 and grad_prev = grad0
      const unsigned one = rule_rows & (0u - rule_rows);
      group_vectors(vec, one, [&](int) { return p.x0; });
      group_p1<T, VA>(p, one, vec, wp);
      grid.sync();
      group_vectors(vec, one, [&](int g) { return p.res + g * m; });
      group_grad<T, VT>(p, one, vec, [&](int) { return p.x0; },
                        [&](int, long long j, float gj) {
                          const float x0j = p.x0[j];
                          for (int h = 0; h < G; ++h) {
                            if (!(rule_rows & (1u << h))) continue;
                            float* xs = p.xs + 2 * n * h;
                            const float vj = x0j - st[h].gamma0 * gj;
                            p.gs[2 * n * h + n + j] = gj;
                            xs[n + j] = x0j;
                            p.v[n * h + j] = vj;
                            xs[j] = prox(p.prox, vj, st[h].gamma0, p.p1, p.p2);
                          }
                        });
      grid.sync();
    }

    for (int iter = 0;; ++iter) {
      // (A) each row's P3 (or, before the first iteration, its first stop test)
      if (warp < G) {
        RowState& s = st[warp];
        const int ran = s.run;
        __syncwarp();
        if (iter == 0) {
          if (lane == 0) {
            const bool go = 0 < s.cap && f32_inf() > s.tol;
            s.conv = f32_inf() <= s.tol;
            s.run = go;
            s.fin = !go;
          }
        } else if (ran) {
          float sum[kParts];
#pragma unroll
          for (int k = 0; k < kParts; ++k)
            sum[k] = sum_part(p.part + warp * kParts * grid_n, k, lane);
          if (lane == 0) {
            float norm_res;
            if (s.momentum) {
              norm_res = sqrtf(sum[kPrimal2]) / s.gamma;
            } else {
              norm_res = sqrtf(sum[kPrimal2]);
              rule_update(s.rule, sum[kDg2], sum[kDgDx], sum[kDx2], s.gamma, s.g1, s.g0);
            }
            if (blockIdx.x == 0) {
              // the record row: gamma, norm_res and f + g at the iterate the
              // partials cover (the rule row's current x, the momentum row's x_new)
              float* h = r.hist + 3LL * (first + warp) * hl;
              h[s.it] = s.gamma;
              h[hl + s.it] = norm_res;
              h[2 * hl + s.it] =
                  objective_of(p, sum[kRes2], sum[kObj]) + gval_of(p, sum[kAbsX], sum[kX2]);
            }
            ++s.it;
            s.norm_res = norm_res;
            const bool go = s.it < s.cap && norm_res > s.tol;  // a NaN residual stops
            s.conv = norm_res <= s.tol;
            s.run = go;
            s.fin = !go;
            s.p3 = 1;
            s.par ^= 1;
          }
        } else if (lane == 0) {
          s.fin = s.p3 = 0;
        }
        if (lane == 0 && s.run && s.momentum) {
          // P0's scalars (_solve_core :270-272)
          const float theta_next = (1.f + sqrtf(1.f + 4.f * s.theta * s.theta)) / 2.f;
          s.beta = (s.theta - 1.f) / theta_next;
          s.theta = theta_next;
        }
      }
      __syncthreads();
      for (long long t = gtid; t < pairs; t += nthreads) {
        const int g = static_cast<int>(t / n);
        const long long j = t - g * n;
        const RowState& s = st[g];
        float* xs = p.xs + 2 * n * g;
        float* v = p.v + n * g;
        const int par = s.par;
        if (s.p3 && !s.momentum) {
          // the rule row's prox step from x = xs[1 - par]; converged: the
          // iterate at the check, not the extra prox step (:360-363)
          const float xj = xs[(1 - par) * n + j];
          const float vj = xj - s.gamma * p.gs[2 * n * g + (1 - par) * n + j];
          v[j] = vj;
          const float xn = prox(p.prox, vj, s.gamma, p.p1, p.p2);
          xs[par * n + j] = xn;
          if (s.fin) r.x_out[(first + g) * n + j] = s.conv ? xj : xn;
        } else if (s.fin) {
          // a momentum row at its check (x_new, returned either way), or a row
          // that stops before its first iteration
          r.x_out[(first + g) * n + j] = xs[par * n + j];
        }
        if (s.run && s.momentum) {
          // P0: z = x + beta (x - x_prev)
          const float xj = xs[par * n + j];
          v[j] = xj + s.beta * (xj - xs[(1 - par) * n + j]);
        }
      }
      unsigned running = 0, momentum_running = 0;
      for (int g = 0; g < G; ++g) {
        const RowState& s = st[g];
        if (s.fin && blockIdx.x == 0) {
          if (threadIdx.x == 0) {
            float* stats = r.stats + 4LL * (first + g);
            stats[0] = static_cast<float>(s.it);
            stats[1] = s.norm_res;
            stats[2] = s.gamma;
            stats[3] = s.conv ? 1.f : 0.f;
          }
          // records are zero past numit
          float* h = r.hist + 3LL * (first + g) * hl;
          for (long long i = s.it + threadIdx.x; i < hl; i += kThreads) {
            h[i] = 0.f;
            h[hl + i] = 0.f;
            h[2 * hl + i] = 0.f;
          }
        }
        if (s.run) {
          running |= 1u << g;
          if (s.momentum) momentum_running |= 1u << g;
        }
      }
      if (!running) break;
      grid.sync();

      // (B) P1 at x (rule rows) or z (momentum rows)
      auto point = [&](int g) {
        return st[g].momentum ? p.v + n * g : p.xs + 2 * n * g + st[g].par * n;
      };
      group_vectors(vec, running, point);
      group_p1<T, VA>(p, running, vec, wp);
      grid.sync();

      // (C) P2: the gradient at the point of B and the partials
      if (lane == 0) {
        for (int g = 0; g < kGroup; ++g) {
#pragma unroll
          for (int k = kPrimal2; k < kParts; ++k) wp[g][k][warp] = 0.f;
        }
      }
      group_vectors(vec, running, [&](int g) { return p.res + g * m; });
      group_grad<T, VT>(p, running, vec, point, [&](int g, long long j, float gj) {
        const RowState& s = st[g];
        float* xs = p.xs + 2 * n * g;
        const int par = s.par;
        if (s.momentum) {
          // x_new = prox(z - gamma grad) and the partials of ||x_new - z||^2,
          // sum |x_new| and sum x_new^2
          const float zj = p.v[n * g + j];
          const float xn = prox(p.prox, zj - s.gamma * gj, s.gamma, p.p1, p.p2);
          xs[(1 - par) * n + j] = xn;
          const float d = xn - zj;
          wp[g][kPrimal2][warp] += d * d;
          wp[g][kAbsX][warp] += fabsf(xn);
          wp[g][kX2][warp] += xn * xn;
        } else {
          float* gs = p.gs + 2 * n * g;
          gs[par * n + j] = gj;
          const float xj = xs[par * n + j];
          const float primal = (p.v[n * g + j] - xj) / s.gamma + gj;
          const float dg = gj - gs[(1 - par) * n + j];
          const float dx = xj - xs[(1 - par) * n + j];
          wp[g][kPrimal2][warp] += primal * primal;
          wp[g][kDg2][warp] += dg * dg;
          wp[g][kDgDx][warp] += dg * dx;
          wp[g][kDx2][warp] += dx * dx;
          wp[g][kAbsX][warp] += fabsf(xj);
          wp[g][kX2][warp] += xj * xj;
        }
      });
      group_partials(p.part, wp, running, kPrimal2, kParts);
      grid.sync();

      // (D) P1' at x_new: the momentum rows' objective (:276-280)
      if (momentum_running) {
        group_vectors(vec, momentum_running,
                      [&](int g) { return p.xs + 2 * n * g + (1 - st[g].par) * n; });
        group_p1<T, VA>(p, momentum_running, vec, wp);
        grid.sync();
      }
    }
  }
}

// K2b's instances: per instance a slice of each table, A and A^T through their
// batch strides (0: one A for every instance).
struct Batch {
  const void* a;       // instance i's A at a + i * a_stride elements
  const void* at;      // instance i's second layout at at + i * at_stride elements
  long long a_stride, at_stride;
  const float* b;      // (count, m)
  const float* x0;     // (count, n)
  const float* scal;   // (count, 5): gamma0, tol, p1, p2, cube_c
  int count, rule, momentum;
  float* x_out;        // (count, n)
  float* stats;        // (count, 4)
};

// K2b: the instances one after another, with a grid sync between two; the
// instance's problem and arguments sit in shared memory (held in registers for
// the whole solve, they pushed every instantiation past the 128 registers a
// thread has here, into local memory; ptxas -v). K2 keeps its own kernel:
// launched through this one over one instance, K2's whole solve read 1.9% slower
// and its cubic iteration at 128^2 2.3% (experiments/resident_timing.py on an
// H100, six runs of each build in turns in one call), so the fold was not shown
// to be free.
template <typename T, int VA, int VT>
__global__ void __launch_bounds__(kThreads, 1) resident_pg_batch_kernel(const Problem p,
                                                                       const Batch bt) {
  __shared__ Problem q;
  __shared__ Solve s;
  for (int i = 0; i < bt.count; ++i) {
    // also a block barrier: every thread is done with the previous instance's q, s
    if (i > 0) cg::this_grid().sync();
    if (threadIdx.x == 0) {
      const float* sc = bt.scal + 5LL * i;
      q = p;
      q.a = static_cast<const T*>(bt.a) + i * bt.a_stride;
      q.at = static_cast<const T*>(bt.at) + i * bt.at_stride;
      q.b = bt.b + i * p.m;
      q.x0 = bt.x0 + i * p.n;
      q.p1 = sc[2];
      q.p2 = sc[3];
      q.cube_c = sc[4];
      s = Solve{sc[0], sc[1], bt.rule, bt.momentum, p.hist_len, bt.x_out + i * p.n,
                bt.stats + 4LL * i, nullptr};
    }
    __syncthreads();
    solve<T, VA, VT>(q, s);
  }
}

ADAPROX_PICK(resident_pg_kernel)
ADAPROX_PICK(resident_pg_sweep_kernel)
ADAPROX_PICK(resident_pg_batch_kernel)
#undef ADAPROX_PICK

}  // namespace

extern "C" {

// Partials per CTA: part needs kParts floats for each CTA of the grid.
int adaprox_resident_pg_parts() { return kParts; }

// K2c's rows a lockstep group.
int adaprox_resident_pg_group() { return kGroup; }

// K2, one whole solve. obj_kind: 0 "ls", 1 "logreg" (at holds A^T / m_true;
// obj_pad = (m - m_true) log 2, obj_div = m_true; both ignored otherwise), 2
// "cubic" (m == n, b = q, cube_c = c; at is not read: pass a). a (m, n) and
// at (n, m) in f32 (a_is_bf16 = 0) or bf16;
// va / vt: 1, or 4 (f32) / 8 (bf16) when n / m is a multiple of it and the rows
// are 16-byte aligned. b (m), x0 (n), xs (2, n), gs (2, n), v (n), res (m), part
// (part_len >= kParts * SMs, zeroed), x_out (n), stats (4) and, when record, hist
// (3, maxit; null when maxit is 0): f32 device buffers the caller owns. prox:
// 0 l1, 1 box, 2 elastic, 3 zero; rule: 0 fixed, 1 mm, 2 adapgm, ignored when
// momentum is 1. Returns the cudaError_t of the launch (0 on success).
int adaprox_resident_pg(int obj_kind, float obj_pad, float obj_div, float cube_c,
                        const void* a, const void* at, int a_is_bf16, int va, int vt, const float* b,
                        const float* x0, float* xs, float* gs, float* v,
                        float* res, float* part, long long part_len, float* x_out,
                        float* stats, float* hist, long long m, long long n, int maxit,
                        float gamma0, float tol, float p1, float p2, int prox_kind,
                        int rule_kind, int momentum, int record, void* stream_ptr) {
  const void* kernel = pick_resident_pg_kernel(a_is_bf16, va, vt);
  if (kernel == nullptr || !problem_ok(obj_kind, m, n, maxit, prox_kind) ||
      rule_kind < kFixed || rule_kind > kAdaPGM || (record && maxit > 0 && !hist)) {
    return cudaErrorInvalidValue;
  }
  Problem prob{a, at, b, x0, xs, gs, v, res, part, m, n, maxit, p1,
               p2, obj_pad, obj_div, cube_c, obj_kind, prox_kind, record};
  Solve s{gamma0, tol, rule_kind, momentum != 0, maxit, x_out, stats, hist};
  return static_cast<int>(launch(kernel, prob, &s, kParts, part_len, stream_ptr));
}

// K2c, the rule sweep: `rows` solves of one problem in one launch, in record
// mode, in lockstep groups of at most kGroup rows. rows_f (rows, 2): gamma0, tol;
// rows_i (rows, 3): rule, momentum, cap, on the device; the caller has checked
// every rule in [0, 2] and every cap in [0, maxit]. x_out (rows, n), stats
// (rows, 4), hist (rows, 3, maxit; null when maxit is 0). The scratch holds one
// copy of K2's for each row of the largest group (G = min(rows, kGroup)): xs (G,
// 2, n), gs (G, 2, n), v (G, n), res (G, m) and part (part_len >= G kParts SMs,
// zeroed). The other arguments as for adaprox_resident_pg.
int adaprox_resident_pg_sweep(int obj_kind, float obj_pad, float obj_div, float cube_c,
                              const void* a,
                              const void* at, int a_is_bf16, int va, int vt, const float* b,
                              const float* x0, float* xs, float* gs, float* v,
                              float* res, float* part, long long part_len, const float* rows_f,
                              const int* rows_i, int rows, float* x_out, float* stats,
                              float* hist, long long m, long long n, int maxit, float p1,
                              float p2, int prox_kind, void* stream_ptr) {
  const void* kernel = pick_resident_pg_sweep_kernel(a_is_bf16, va, vt);
  if (kernel == nullptr || !problem_ok(obj_kind, m, n, maxit, prox_kind) || rows < 1 ||
      !rows_f || !rows_i || (maxit > 0 && !hist)) {
    return cudaErrorInvalidValue;
  }
  Problem prob{a, at, b, x0, xs, gs, v, res, part, m, n, maxit, p1,
               p2, obj_pad, obj_div, cube_c, obj_kind, prox_kind, 1};
  Rows r{rows_f, rows_i, rows, x_out, stats, hist};
  return static_cast<int>(
      launch(kernel, prob, &r, kParts * (rows < kGroup ? rows : kGroup), part_len, stream_ptr));
}

// K2b, the batch: `count` independent solves in one launch, without records.
// The leading arguments as for adaprox_resident_pg, whose scratch the
// instances share; cube_c is not read (each instance's is its scal row's).
// Instance i reads A at a + i * a_stride and its second layout at at + i *
// at_stride (elements; 0 for one shared A), b (count, m), x0 (count, n) and
// scal (count, 5) = gamma0, tol, p1, p2, cube_c, on the device; it writes
// x_out (count, n) and stats (count, 4). rule_kind, momentum and maxit (every
// instance's cap) are the launch's.
int adaprox_resident_pg_batch(int obj_kind, float obj_pad, float obj_div, float cube_c,
                              const void* a, const void* at, int a_is_bf16, int va, int vt,
                              const float* b, const float* x0, float* xs, float* gs, float* v,
                              float* res, float* part, long long part_len, long long a_stride,
                              long long at_stride, const float* scal, int count, float* x_out,
                              float* stats, long long m, long long n, int maxit, int prox_kind,
                              int rule_kind, int momentum, void* stream_ptr) {
  const void* kernel = pick_resident_pg_batch_kernel(a_is_bf16, va, vt);
  if (kernel == nullptr || !problem_ok(obj_kind, m, n, maxit, prox_kind) ||
      rule_kind < kFixed || rule_kind > kAdaPGM || count < 1 || !scal || a_stride < 0 ||
      at_stride < 0) {
    return cudaErrorInvalidValue;
  }
  Problem prob{a, at, b, x0, xs, gs, v, res, part, m, n, maxit, 0.f,
               0.f, obj_pad, obj_div, cube_c, obj_kind, prox_kind, 0};
  Batch bt{a,     at,        a_stride,      at_stride, b,     x0,
           scal,  count,     rule_kind,     momentum != 0, x_out, stats};
  return static_cast<int>(launch(kernel, prob, &bt, kParts, part_len, stream_ptr));
}

const char* adaprox_resident_pg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
