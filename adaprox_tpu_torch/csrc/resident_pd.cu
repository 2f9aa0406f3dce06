// K6d for Hopper: the dual SVM's whole Condat-Vu solve in one cooperative kernel launch,
//
//     min 0.5 x'Qx - 1'x   over 0 <= x <= C   with   labels'x = 0,
//
// as f = 0.5 x'Qx - 1'x, g = IndBox(0, C), h = IndZero and A = labels' (1 x N), so the dual
// variable y is a scalar and prox_{sigma h*} is the identity. Q is the N x N Gram (dense) or,
// factored, Q = B B' with B (N x d) = D_y X: the gradient is then B (B'x) - 1 and the Gram is
// never formed.
//
// Replaces the Pallas TPU kernel of adaprox_tpu/ops/resident.py:
//   K6d  resident_cv_dsvm (_dsvm_cv_kernel[_rec] over _dsvm_cv_core): one Condat-Vu solve
//        with fixed (gamma, sigma), dense or factored.
// (K6a, K6b and K6c, the AdaPDM and Malitsky-Pock sweeps, are resident_dsvm_grid.cu.) Q or B
// is stored as f32 or bf16; every iterate, reduction and scalar is f32.
//
// The iteration (_dsvm_cv_core, the engine's order with the fixed rule, rho = 1):
//     a_x    = labels'x,  grad = Q x - 1[i < n_true]
//     primal = (v - x) / gamma + grad + labels y_prev
//     y      = y_prev + sigma (2 a_x - a_x_prev)
//     norm_res = sqrt(||primal||^2 + a_x^2)          (the dual residual is -a_x)
//     v = x - gamma (grad + labels y);  x' = clamp(v, 0, C)
// The record row (before the second half): norm_res, f(x). The linear term is masked by
// i < n_true, so the coordinates a caller zero-padded stay exactly 0. On convergence the x of
// the check is returned, not the extra box step.
//
// What bounds it on the card. Q or B is read from device memory once (6.5 MB at svmguide3's
// 1280^2 f32, 4.2 MB for mushrooms' 8192 x 128 B); an iteration does 2 N^2 flops dense or
// 4 N d factored (0.05 us at 1280^2 on 67 TFLOP/s of f32 outside the tensor cores). Q stays in
// the 50 MB L2 across iterations, so in practice the grid-wide barriers set the pace: two an
// iteration dense, three factored.
//
// Design (first, simple version; resident_dsvm.cuh has the row dot, phase F, the B'x reduce
// and the launch):
//   * One persistent cooperative launch, at most one CTA per SM, fewer when N has fewer rows
//     than the grid has warps (heart_scale's 384 rows take 24 CTAs of 16 warps). Q, the
//     labels and every vector stay in global memory, so any N runs.
//   * Dense, an iteration is two phases with a grid sync after each:
//       P1  one warp a row i: (Q x)_i = Q_i . x (Q symmetric, 16-byte loads); lane 0 forms
//           grad_i (overwriting the previous gradient in place) and the primal residual term,
//           and adds to this CTA's partials of labels'x, ||primal||^2 and (record) x.Qx and
//           ones.x;
//       P2  every CTA sums the partials in one fixed order (no atomics; warp k sums partial
//           k) and so computes the same y, norm_res and stop decision from the same bits;
//           then elementwise v = x - gamma (grad + labels y), x' = clamp(v).
//   * Factored, a phase F comes first: each CTA sums B_r x_r over its slice of rows into
//     per-CTA partials of B'x (d of them, column-contiguous), then a grid sync; at the start
//     of P1 every CTA reduces all of them with all its threads (thread (g, c) sums every
//     (512/d)-th CTA's partial of column c, then the groups are added in order) into B'x in
//     shared memory, and P1's row dot is B_i . (B'x). Three syncs an iteration.
//   * x0 = 0 (the engine's warm-up from y0 = 0): Q x0 = 0, so the warm-up is elementwise,
//     grad0 = -1[i < n_true].
//   * IEEE semantics as K2 (no fast math, IEEE division and square root; NaN-propagating
//     min/max like jnp.minimum and jnp.clip; -fmad=false, so each elementwise expression
//     rounds after every operation as the plain PyTorch version does; the dot products use
//     explicit fmaf).

#include "resident_dsvm.cuh"

namespace {

// Per-CTA partial sums of P1: part[k * grid + cta]. kFqx and kFlin (x.Qx and ones.x) feed
// the record's objective; the factored F phase writes its d partials of B'x after these, at
// part + kPdParts * grid, as [cta * d + c].
enum PdPart { kAx = 0, kPrimal2, kFqx, kFlin, kPdParts };

// The problem, the scratch and the solve's scalars and outputs.
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
  float gamma, sigma;  // the fixed steps
  float tol;
  int maxit, record;
  float* x_out;  // (n,)
  float* stats;  // (3,): numit, norm_res, converged
  float* hist;   // (2, hist_len): norm_res, f
};

// One whole solve (_dsvm_cv_core), run by every thread of the grid.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1) resident_pd_kernel(const PdProblem p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float warp_part[kPdParts][kWarps];
  __shared__ float s_red[kThreads];
  __shared__ float s_sum[kPdParts];
  __shared__ float s_y;
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
  const float* __restrict__ lab = p.lab;
  float* part_bx = p.part + kPdParts * gridDim.x;

  // the carry: every thread holds y (the previous step's, for P1's primal residual); thread
  // 0 of each CTA also (it, a_x_prev, norm_res), the same bits in every CTA
  const float gamma = p.gamma;
  float y = 0.f, a_x_prev = 0.f;
  float norm_res = f32_inf();
  int it = 0;
  int par = 0;  // x = xs[par], x_prev = xs[1 - par]

  // warm-up (_pd_core :843-849): x0 = 0, so Q x0 = 0 and grad0 = -1[j < n_true];
  // v = x0 - gamma grad0 (A'y0 = 0), x = clamp(v); x_prev = x0
  for (long long j = gtid; j < n; j += nthreads) {
    const float g = 0.f - (j < p.n_true ? 1.f : 0.f);
    p.grad[j] = g;
    p.xs[n + j] = 0.f;
    const float vj = 0.f - gamma * g;
    p.v[j] = vj;
    p.xs[j] = nan_min(nan_max(vj, 0.f), p.big_c);
  }
  grid.sync();

  bool go = 0 < p.maxit && norm_res > p.tol;
  bool conv = norm_res <= p.tol;
  if (!go) {
    for (long long j = gtid; j < n; j += nthreads) p.x_out[j] = p.xs[j];
  }

  while (go) {
    const float* x = p.xs + par * n;
    // F (factored): the partials of B'x
    if (p.factored) {
      phase_btx<T>(p.q, n, p.d, x, part_bx, s_red);
      grid.sync();
      reduce_btx(p.d, part_bx, s_btx, s_red);
    }

    // P1: (Q x)_i a warp a row; lane 0 the gradient and the residual terms
    float acc[kPdParts] = {};
    for (long long i = gwarp; i < n; i += nwarps) {
      const float qx = row_dot<T, V>(p.q, i, n, p.d, p.factored, x, s_btx, lane);
      if (lane == 0) {
        const float one = i < p.n_true ? 1.f : 0.f;
        const float g = qx - one;
        const float xi = x[i];
        p.grad[i] = g;
        const float li = lab[i];
        const float primal = (p.v[i] - xi) / gamma + g + li * y;
        acc[kAx] += li * xi;
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

    // the step: warp k sums partial k over the CTAs (the sums at once), then thread 0 of
    // every CTA takes the step from the same sums in the same order
    if (warp < kPdParts) {
      const float total = sum_part(p.part, warp, lane);
      if (lane == 0) s_sum[warp] = total;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const float* sum = s_sum;
      const float a_x = sum[kAx];
      y = y + p.sigma * (2.f * a_x - a_x_prev);  // rho = 1; prox of (IndZero)* = Zero
      norm_res = sqrtf(sum[kPrimal2] + a_x * a_x);
      if (p.record && blockIdx.x == 0) {
        p.hist[it] = norm_res;
        p.hist[hl + it] = 0.5f * sum[kFqx] - sum[kFlin];
      }
      a_x_prev = a_x;
      ++it;
      s_y = y;
      s_go = it < p.maxit && norm_res > p.tol;  // a NaN residual stops
      s_conv = norm_res <= p.tol;
    }
    __syncthreads();
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
      if (!go) p.x_out[j] = conv ? xj : xn;
    }
    if (go) grid.sync();
    par ^= 1;
  }

  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) {
      p.stats[0] = static_cast<float>(it);
      p.stats[1] = norm_res;
      p.stats[2] = conv ? 1.f : 0.f;
    }
    if (p.record) {
      // histories are zero past numit; thread 0's it is every CTA's
      if (threadIdx.x == 0) s_numit = it;
      __syncthreads();
      for (long long i = s_numit + threadIdx.x; i < hl; i += kThreads) {
        p.hist[i] = 0.f;
        p.hist[hl + i] = 0.f;
      }
    }
  }
}

ADAPROX_PICK_DSVM(resident_pd_kernel)

}  // namespace

extern "C" {

// The partials a CTA needs: part needs (parts + d) floats for each CTA of the grid when
// factored, parts dense.
int adaprox_resident_pd_parts() { return kPdParts; }

// K6d: one Condat-Vu solve with fixed (gamma, sigma). q dense (n, n) or, factored = 1, B
// (n, d), f32 (q_is_bf16 = 0) or bf16; vec: 1, or 4 (f32) / 8 (bf16) when the rows' length
// (n dense, d factored) is a multiple of it and q is 16-byte aligned. lab (n), xs (2, n),
// grad (n), v (n), part (part_len): f32 device buffers the caller owns. x_out (n); stats
// (3): numit, norm_res, converged; hist (2, hist_len): norm_res and the objective f(x),
// hist_len = maxit rounded up to 128, zero past numit. Returns the cudaError_t of the launch
// (0 on success).
int adaprox_resident_cv(const void* q, int q_is_bf16, int vec, int factored, long long n,
                        long long d, const float* lab, int n_true, float big_c, float* xs,
                        float* grad, float* v, float* part, long long part_len, float gamma,
                        float sigma, float tol, int maxit, int record, float* x_out,
                        float* stats, float* hist, void* stream_ptr) {
  const void* kernel = pick_resident_pd_kernel(q_is_bf16, vec);
  if (kernel == nullptr || n < 1 || (factored && d < 1) || n_true < 0 || n_true > n ||
      maxit < 0 || !x_out || !stats || (record && maxit > 0 && !hist)) {
    return cudaErrorInvalidValue;
  }
  PdProblem prob{q, lab, xs, grad, v, part, n, factored ? d : 0, n_true, factored != 0, big_c,
                 (maxit + 127) / 128 * 128,  // _hist_len(maxit)
                 gamma, sigma, tol, maxit, record, x_out, stats, record ? hist : nullptr};
  void* args[] = {&prob};
  return static_cast<int>(launch_dsvm(kernel, args, n, prob.d, prob.factored, kPdParts,
                                      part_len, stream_ptr));
}

const char* adaprox_resident_pd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
