// K6a, K6b and K6d for Hopper: whole primal-dual solves of the dual SVM in one
// cooperative kernel launch,
//
//     min 0.5 x'Qx - 1'x   over 0 <= x <= C   with   labels'x = 0,
//
// as f = 0.5 x'Qx - 1'x, g = IndBox(0, C), h = IndZero and A = labels' (1 x N),
// so the dual variable y is a scalar and prox_{sigma h*} is the identity. Q is
// the N x N Gram (dense) or, factored, Q = B B' with B (N x d) = D_y X: the
// gradient is then B (B'x) - 1 and the Gram is never formed.
//
// Replaces the Pallas TPU kernels of adaprox_tpu/ops/resident.py:
//   K6a  resident_adapdm_dsvm (_pd_kernel over _pd_core): one AdaPDM solve, dense Q;
//   K6b  resident_adapdm_dsvm_sweep (_pd_sweep_kernel[_rec] over _pd_core): the
//        coupling-t sweep, one AdaPDM solve a value of t, dense or factored;
//   K6d  resident_cv_dsvm (_dsvm_cv_kernel[_rec] over _dsvm_cv_core): one
//        Condat-Vu solve with fixed (gamma, sigma), dense or factored.
// All three reach one device routine (solve below) with a runtime rule switch:
// AdaPDM (the AdaPGM rule with its coupling terms, rho = gamma / gamma_prev) or
// fixed (gamma, sigma) with rho = 1 (Condat-Vu). Q or B is stored as f32 or bf16;
// every iterate, reduction and scalar is f32.
//
// The iteration (_pd_core / _dsvm_cv_core, the engine's order):
//     a_x    = labels'x,  grad = Q x - 1[i < n_true]
//     primal = (v - x) / gamma_prev + grad + labels y_prev
//     gamma  <- rule(||dg||^2, <dg, dx>, ||dx||^2);  sigma = gamma t^2
//     w      = y_prev + sigma ((1 + rho) a_x - rho a_x_prev);  y = w
//     norm_res = sqrt(||primal||^2 + a_x^2)          (the dual residual is -a_x)
//     v = x - gamma (grad + labels y);  x' = clamp(v, 0, C)
// The record row (before the second half): (gamma, norm_res) for AdaPDM,
// (norm_res, f(x)) for Condat-Vu. The linear term is masked by i < n_true, so the
// coordinates a caller zero-padded stay exactly 0. On convergence the x of the
// check is returned, not the extra box step.
//
// What bounds it on the card. Q or B is read from device memory once (6.5 MB at
// svmguide3's 1280^2 f32, 4.2 MB for mushrooms' 8192 x 128 B); an iteration does
// 2 N^2 flops dense or 4 N d factored (0.05 us at 1280^2 on 67 TFLOP/s of f32
// outside the tensor cores). Q stays in the 50 MB L2 across iterations and t
// values, so in practice the grid-wide barriers set the pace: two an iteration
// dense, three factored.
//
// Design (first, simple version; resident_dsvm.cuh has the row dot, phase F, the
// B'x reduce and the launch, which K6c shares):
//   * One persistent cooperative launch, at most one CTA per SM, fewer when N
//     has fewer rows than the grid has warps (heart_scale's 384 rows take 24
//     CTAs of 16 warps). Q, the labels and every vector stay in global memory,
//     so any N runs.
//   * Dense, an iteration is two phases with a grid sync after each:
//       P1  one warp a row i: (Q x)_i = Q_i . x (Q symmetric, 16-byte loads);
//           lane 0 forms grad_i, dg_i and dx_i against the previous gradient
//           (overwritten in place) and point, the primal residual term, and
//           adds to this CTA's partials of labels'x, ||dg||^2, <dg, dx>,
//           ||dx||^2, ||primal||^2 (and, Condat-Vu record, x.Qx and ones.x);
//       P2  every CTA sums the partials in one fixed order (no atomics; warp k
//           sums partial k, the seven at once) and so computes the same gamma,
//           y, norm_res and stop decision from the same bits; then elementwise
//           v = x - gamma (grad + labels y), x' = clamp(v).
//   * Factored, a phase F comes first: each CTA sums B_r x_r over its slice of
//     rows into per-CTA partials of B'x (d of them, column-contiguous), then a
//     grid sync; at the start of P1 every CTA reduces all of them with all its
//     threads (thread (g, c) sums every (512/d)-th CTA's partial of column c,
//     then the groups are added in order) into B'x in shared memory, and P1's
//     row dot is B_i . (B'x). Three syncs an iteration, and no extra reduce
//     phase.
//   * The t-sweep (K6b) runs its rows one after another through the same
//     routine on the same grid, a grid sync between rows, so a dense row equals
//     its single K6a launch bit for bit and a factored row a one-row sweep.
//   * x0 = 0 (the engine's warm-up from y0 = 0): Q x0 = 0, so the warm-up is
//     elementwise, grad0 = -1[i < n_true].
//   * IEEE semantics as K2 (no fast math, IEEE division and square root; 0/0 in
//     the rule guarded to 0, the denominator clamped at 0, NaN-propagating
//     min/max like jnp.minimum and jnp.clip; -fmad=false, so each elementwise
//     expression rounds after every operation as the plain PyTorch version does;
//     the dot products use explicit fmaf).

#include "resident_dsvm.cuh"

namespace {

enum PdRule { kAdaPDM = 0, kCondatVu = 1 };
// Per-CTA partial sums of P1: part[k * grid + cta]. kFqx and kFlin (x.Qx and
// ones.x) feed the Condat-Vu record's objective; the factored F phase writes its
// d partials of B'x after these, at part + kPdParts * grid, as [cta * d + c].
enum PdPart { kAx = 0, kDg2, kDgDx, kDx2, kPrimal2, kFqx, kFlin, kPdParts };

// The problem and the scratch, shared by every solve of a launch.
struct PdProblem {
  const void* q;     // dense: (n, n) symmetric; factored: B (n, d); row-major, f32 or bf16
  const float* lab;  // (n,): the labels, zero on padded coordinates
  float* xs;         // (2, n): x and x_prev by parity
  float* grad;       // (n,): the gradient at the last P1's point
  float* v;          // (n,)
  float* part;       // (kPdParts + d) * grid when factored, kPdParts * grid dense
  long long n, d;    // d: B's columns (factored), 0 dense
  int n_true;        // the linear term's mask: coordinates i < n_true
  int factored;
  float big_c;
  int hist_len;
};

// A launch's solves: `count` rows (one for K6a and K6d), one t each for AdaPDM.
struct PdRows {
  const float* ts;  // (count,) on the device, or null: every row takes t0
  float t0;
  int count;
  int rule;         // kAdaPDM or kCondatVu
  float norm_a, theta;  // AdaPDM: gamma0 = 1 / (2 theta t norm_a), the coupling bound
  float gamma, sigma;   // Condat-Vu: the fixed steps
  float tol;
  int maxit, record;
  float* x_out;  // (count, n)
  float* stats;  // (count, 4): numit, norm_res, gamma, converged; Condat-Vu (3,) without gamma
  float* hist;   // (count, 2, hist_len): AdaPDM gamma, norm_res; Condat-Vu norm_res, f
};

// One row's arguments, in shared memory (as K2c's rows).
struct PdSolve {
  float t;
  float* x_out;
  float* stats;
  float* hist;
};

// One whole solve (_pd_core or _dsvm_cv_core), run by every thread of the grid.
// Returns with every CTA past its last grid sync of the solve.
template <typename T, int V>
__device__ void solve(const PdProblem& p, const PdRows& r, const PdSolve& s) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float warp_part[kPdParts][kWarps];
  __shared__ float s_red[kThreads];
  __shared__ float s_sum[kPdParts];
  __shared__ float s_gamma, s_y;
  __shared__ int s_go, s_conv, s_numit;
  extern __shared__ float4 s_dyn[];
  float* s_btx = reinterpret_cast<float*>(s_dyn);  // factored: B'x, d floats

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * kThreads;
  const long long gwarp = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  const long long n = p.n;
  const long long hl = p.hist_len;
  const bool adapdm = r.rule == kAdaPDM;
  const float t = s.t;
  const float* __restrict__ lab = p.lab;
  float* part_bx = p.part + kPdParts * gridDim.x;

  // the carry: every thread holds gamma and y (the previous step's, for P1's
  // primal residual); thread 0 of each CTA also (it, g1, g0, a_x_prev, norm_res),
  // the same bits in every CTA
  const float gamma0 = adapdm ? 1.f / (2.f * r.theta * t * r.norm_a) : r.gamma;
  float gamma = gamma0, g1 = gamma0, g0 = gamma0, y = 0.f, a_x_prev = 0.f;
  float norm_res = f32_inf();
  int it = 0;
  int par = 0;  // x = xs[par], x_prev = xs[1 - par]

  // warm-up (_pd_core :843-849): x0 = 0, so Q x0 = 0 and grad0 = -1[j < n_true];
  // v = x0 - gamma0 grad0 (A'y0 = 0), x = clamp(v); x_prev = x0
  for (long long j = gtid; j < n; j += nthreads) {
    const float g = 0.f - (j < p.n_true ? 1.f : 0.f);
    p.grad[j] = g;
    p.xs[n + j] = 0.f;
    const float vj = 0.f - gamma0 * g;
    p.v[j] = vj;
    p.xs[j] = nan_min(nan_max(vj, 0.f), p.big_c);
  }
  grid.sync();

  bool go = 0 < r.maxit && norm_res > r.tol;
  bool conv = norm_res <= r.tol;
  if (!go) {
    for (long long j = gtid; j < n; j += nthreads) s.x_out[j] = p.xs[j];
  }

  while (go) {
    const float* x = p.xs + par * n;
    const float* x_prev = p.xs + (1 - par) * n;
    // F (factored): the partials of B'x
    if (p.factored) {
      phase_btx<T>(p.q, n, p.d, x, part_bx, s_red);
      grid.sync();
      reduce_btx(p.d, part_bx, s_btx, s_red);
    }

    // P1: (Q x)_i a warp a row; lane 0 the gradient, the curvature and residual terms
    float acc[kPdParts] = {};
    for (long long i = gwarp; i < n; i += nwarps) {
      const float qx = row_dot<T, V>(p.q, i, n, p.d, p.factored, x, s_btx, lane);
      if (lane == 0) {
        const float one = i < p.n_true ? 1.f : 0.f;
        const float g = qx - one;
        const float xi = x[i];
        const float dg = g - p.grad[i];
        const float dx = xi - x_prev[i];
        p.grad[i] = g;
        const float li = lab[i];
        const float primal = (p.v[i] - xi) / gamma + g + li * y;
        acc[kAx] += li * xi;
        acc[kDg2] += dg * dg;
        acc[kDgDx] += dg * dx;
        acc[kDx2] += dx * dx;
        acc[kPrimal2] += primal * primal;
        acc[kFqx] += xi * qx;
        acc[kFlin] += one * xi;
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kPdParts; ++k) warp_part[k][warp] = acc[k];
    }
    write_partials(warp_part, p.part, 0, kPdParts);
    grid.sync();

    // the step: warp k sums partial k over the CTAs (the seven sums at once), then
    // thread 0 of every CTA takes the step from the same sums in the same order
    if (warp < kPdParts) {
      const float total = sum_part(p.part, warp, lane);
      if (lane == 0) s_sum[warp] = total;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const float* sum = s_sum;
      const float a_x = sum[kAx];
      float w;
      if (adapdm) {
        // AdaPGMRule.update with the coupling (_pd_core :880-892)
        float dd = g1 * (g1 * sum[kDg2] - sum[kDgDx]) / sum[kDx2];
        if (isnan(dd)) dd = 0.f;
        const float xi = t * t * g1 * g1 * r.norm_a * r.norm_a;
        const float m4 = 1.f - 4.f * xi;
        const float denom = nan_max(dd + sqrtf(dd * dd + xi * m4), 0.f);
        const float step = nan_min(
            g1 * sqrtf(1.f + g1 / g0),
            nan_min(1.f / (2.f * r.theta * t * r.norm_a), g1 * sqrtf(m4) / sqrtf(2.f * denom)));
        const float sigma = step * t * t;
        const float rho = step / gamma;
        w = y + sigma * ((1.f + rho) * a_x - rho * a_x_prev);
        g0 = g1;
        g1 = step;
        gamma = step;
      } else {
        w = y + r.sigma * (2.f * a_x - a_x_prev);  // rho = 1
      }
      y = w;  // prox of (IndZero)* = Zero: the identity
      norm_res = sqrtf(sum[kPrimal2] + a_x * a_x);
      if (r.record && blockIdx.x == 0) {
        s.hist[it] = adapdm ? gamma : norm_res;
        s.hist[hl + it] = adapdm ? norm_res : 0.5f * sum[kFqx] - sum[kFlin];
      }
      a_x_prev = a_x;
      ++it;
      s_gamma = gamma;
      s_y = y;
      s_go = it < r.maxit && norm_res > r.tol;  // a NaN residual stops
      s_conv = norm_res <= r.tol;
    }
    __syncthreads();
    gamma = s_gamma;
    y = s_y;
    go = s_go != 0;
    conv = s_conv != 0;

    // P2: the next point
    float* x_new = p.xs + (1 - par) * n;
    for (long long j = gtid; j < n; j += nthreads) {
      const float xj = x[j];
      const float vj = xj - gamma * (p.grad[j] + lab[j] * y);
      p.v[j] = vj;
      const float xn = nan_min(nan_max(vj, 0.f), p.big_c);
      x_new[j] = xn;
      // converged: the iterate at the check, not the extra box step (:921-925)
      if (!go) s.x_out[j] = conv ? xj : xn;
    }
    if (go) grid.sync();
    par ^= 1;
  }

  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) {
      s.stats[0] = static_cast<float>(it);
      s.stats[1] = norm_res;
      if (adapdm) {
        s.stats[2] = gamma;
        s.stats[3] = conv ? 1.f : 0.f;
      } else {
        s.stats[2] = conv ? 1.f : 0.f;
      }
    }
    if (r.record) {
      // histories are zero past numit; thread 0's it is every CTA's
      if (threadIdx.x == 0) s_numit = it;
      __syncthreads();
      for (long long i = s_numit + threadIdx.x; i < hl; i += kThreads) {
        s.hist[i] = 0.f;
        s.hist[hl + i] = 0.f;
      }
    }
  }
}

// K6a, K6b and K6d: the rows one after another, a grid sync between two rows (the
// next solve reuses the scratch that other CTAs may still read).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1) resident_pd_kernel(const PdProblem p,
                                                                 const PdRows r) {
  __shared__ PdSolve s;
  const int stats_w = r.rule == kAdaPDM ? 4 : 3;
  for (int row = 0; row < r.count; ++row) {
    // also a block barrier: every thread is done with the previous row's s
    if (row > 0) cg::this_grid().sync();
    if (threadIdx.x == 0) {
      s = PdSolve{r.ts ? r.ts[row] : r.t0, r.x_out + row * p.n,
                  r.stats + static_cast<long long>(stats_w) * row,
                  r.hist ? r.hist + 2LL * row * p.hist_len : nullptr};
    }
    __syncthreads();
    solve<T, V>(p, r, s);
  }
}

ADAPROX_PICK_DSVM(resident_pd_kernel)

int run(const void* q, int q_is_bf16, int vec, int factored, long long n, long long d,
        const float* lab, int n_true, float big_c, float* xs, float* grad, float* v, float* part,
        long long part_len, PdRows& rows, void* stream_ptr) {
  const void* kernel = pick_resident_pd_kernel(q_is_bf16, vec);
  if (kernel == nullptr || n < 1 || (factored && d < 1) || n_true < 0 || n_true > n ||
      rows.count < 1 || rows.maxit < 0 || !rows.x_out || !rows.stats ||
      (rows.record && rows.maxit > 0 && !rows.hist)) {
    return cudaErrorInvalidValue;
  }
  const int hist_len = (rows.maxit + 127) / 128 * 128;  // _hist_len(maxit)
  PdProblem prob{q, lab, xs, grad, v, part, n, factored ? d : 0, n_true, factored != 0, big_c,
                 hist_len};
  if (!rows.record) rows.hist = nullptr;
  void* args[] = {&prob, &rows};
  return static_cast<int>(launch_dsvm(kernel, args, n, prob.d, prob.factored, kPdParts, part_len,
                                      stream_ptr));
}

}  // namespace

extern "C" {

// The partials a CTA needs: part needs (parts + d) floats for each CTA of the
// grid when factored, parts dense.
int adaprox_resident_pd_parts() { return kPdParts; }

// The problem arguments of every entry: q dense (n, n) or, factored = 1, B (n, d),
// f32 (q_is_bf16 = 0) or bf16; vec: 1, or 4 (f32) / 8 (bf16) when the rows' length
// (n dense, d factored) is a multiple of it and q is 16-byte aligned. lab (n),
// xs (2, n), grad (n), v (n), part (part_len): f32 device buffers the caller owns.
// Histories are (2, hist_len) a row, hist_len = maxit rounded up to 128, zero
// past numit. Each returns the cudaError_t of the launch (0 on success).

// K6a: one AdaPDM solve of coupling t. stats (4): numit, norm_res, gamma,
// converged.
int adaprox_resident_pd(const void* q, int q_is_bf16, int vec, int factored, long long n,
                        long long d, const float* lab, int n_true, float big_c, float* xs,
                        float* grad, float* v, float* part, long long part_len, float t,
                        float norm_a, float theta, float tol, int maxit, int record,
                        float* x_out, float* stats, float* hist, void* stream_ptr) {
  PdRows rows{nullptr, t, 1, kAdaPDM, norm_a, theta, 0.f, 0.f, tol, maxit, record, x_out,
              stats, hist};
  return run(q, q_is_bf16, vec, factored, n, d, lab, n_true, big_c, xs, grad, v, part,
             part_len, rows, stream_ptr);
}

// K6b: `count` AdaPDM solves, one for each t of ts (count,) on the device.
// x_out (count, n), stats (count, 4), hist (count, 2, hist_len).
int adaprox_resident_pd_sweep(const void* q, int q_is_bf16, int vec, int factored, long long n,
                              long long d, const float* lab, int n_true, float big_c,
                              float* xs, float* grad, float* v, float* part, long long part_len,
                              const float* ts, int count, float norm_a, float theta, float tol,
                              int maxit, int record, float* x_out, float* stats, float* hist,
                              void* stream_ptr) {
  if (!ts) return cudaErrorInvalidValue;
  PdRows rows{ts, 0.f, count, kAdaPDM, norm_a, theta, 0.f, 0.f, tol, maxit, record, x_out,
              stats, hist};
  return run(q, q_is_bf16, vec, factored, n, d, lab, n_true, big_c, xs, grad, v, part,
             part_len, rows, stream_ptr);
}

// K6d: one Condat-Vu solve with fixed (gamma, sigma). stats (3): numit, norm_res,
// converged; hist (2, hist_len): norm_res and the objective f(x).
int adaprox_resident_cv(const void* q, int q_is_bf16, int vec, int factored, long long n,
                        long long d, const float* lab, int n_true, float big_c, float* xs,
                        float* grad, float* v, float* part, long long part_len, float gamma,
                        float sigma, float tol, int maxit, int record, float* x_out,
                        float* stats, float* hist, void* stream_ptr) {
  PdRows rows{nullptr, 0.f, 1, kCondatVu, 0.f, 0.f, gamma, sigma, tol, maxit, record, x_out,
              stats, hist};
  return run(q, q_is_bf16, vec, factored, n, d, lab, n_true, big_c, xs, grad, v, part,
             part_len, rows, stream_ptr);
}

const char* adaprox_resident_pd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
