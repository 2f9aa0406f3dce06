// K6c for Hopper: the Malitsky-Pock coupling sweep of the dual SVM in one
// cooperative kernel launch, with the linesearch on the device,
//
//     min 0.5 x'Qx - 1'x   over 0 <= x <= C   with   labels'x = 0,
//
// as f = 0.5 x'Qx - 1'x, g = IndBox(0, C), h = IndZero and A = labels' (1 x N):
// the dual variable y is a scalar and prox_{sigma h*} is the identity. Q is the
// N x N Gram (dense) or, factored, Q = B B' with B (N x d) = D_y X.
//
// Replaces the Pallas TPU kernel of adaprox_tpu/ops/resident.py:
//   K6c  _resident_mp_dsvm_sweep_jit (_dsvm_mp_sweep_kernel[_rec] over
//        _dsvm_mp_core): one whole Malitsky-Pock solve for each coupling t.
// Q or B is stored as f32 or bf16; every iterate, reduction and scalar is f32.
//
// The iteration (_dsvm_mp_core, the engine's solvers/malitsky_pock order), from
// x0 = 0 (Q x0 = 0, f(0) = 0: the start makes no matvec) and y0 = 0:
//     y = y + sigma a_x;  sigma_prev = sigma;  s = sigma sqrt(2)
//     trial: theta = s / sigma_prev, gamma = t t s,
//            v = x_prev - gamma((1 + theta) labels y - theta labels y_prev + Q x_prev - 1)
//            x = clamp(v, 0, C);  a_x = labels'x;  Q x;  f = 0.5 x.Qx - 1'x
//            breg = f - f_prev - <Q x_prev - 1, dx>, or max(0.5 <dx, Qx - Qx_prev>, 0)
//            lhs = gamma s (a_x - a_x_prev)^2 + 2 gamma breg
//     halve s while lhs > 0.95 ||dx||^2 and fewer than 101 trials ran; a test still
//     failing at the cap is latched into ls_failed;
//     norm_res = sqrt(||(v - x)/gamma + Q x - 1 + labels y||^2 + a_x^2)
// The accepted trial's Q x and f are the next iteration's Q x_prev and f_prev: one
// Q matvec a trial. The record row: gamma, s, norm_res, trials, f. The linear term
// is masked by i < n_true, so the coordinates a caller zero-padded stay exactly 0.
//
// What bounds it on the card. Q or B is read from device memory once (6.5 MB at
// svmguide3's 1280^2 f32, 4.2 MB for mushrooms' 8192 x 128 B); a trial does 2 N^2
// flops dense or 4 N d factored. Q stays in the 50 MB L2 across trials and t
// values, so in practice the grid-wide barriers set the pace: two a trial dense,
// three factored, and about 1.5 trials an iteration.
//
// Design (first, simple version; resident_dsvm.cuh has what K6 shares):
//   * One persistent cooperative launch on K6's grid (launch_dsvm): a warp a row,
//     at most one CTA per SM. Q, the labels and every vector stay in global memory.
//   * A trial is two phases with a grid sync after each (three factored):
//       T   elementwise: v and the trial x from x_prev, Q x_prev and the scalars
//           every thread holds (y, y_prev, theta, gamma);
//       F   (factored) K6's per-CTA partials of B'x, then every CTA reduces them
//           into its shared memory;
//       P1  a warp a row i: (Q x)_i into the trial's Q x buffer; lane 0 adds to
//           this CTA's partials of labels'x, ||dx||^2, x.Qx, 1'x, <dx, Qx - Qx_prev>,
//           <Q x_prev - 1, dx> and ||primal||^2.
//     Then warp k of every CTA sums partial k over the CTAs in one fixed order (no
//     atomics) and every thread takes the accept, halve or cap decision from the
//     same bits, so every CTA runs the same trials: a CTA that decided otherwise
//     would wait at a barrier the others never reach. NaN compares false, as in jnp.
//   * Every partial is written after the trial's first grid sync: a CTA that has
//     decided and runs the next trial's T writes no partial, so one slot set does
//     (K4, whose T writes partials, alternates two).
//   * x/x_prev and Qx/Qx_prev are two buffers each, swapped by parity on
//     acceptance: no copy.
//   * The rows run one after another through the same routine on the same grid, a
//     grid sync between rows, so each row equals a one-row launch bit for bit.
//   * IEEE semantics as K6 (no fast math, IEEE division and square root,
//     NaN-propagating min/max like jnp.clip; -fmad=false, so each elementwise
//     expression rounds after every operation as the plain PyTorch version does;
//     the dot products use explicit fmaf).

#include "resident_dsvm.cuh"

namespace {

// Per-CTA partial sums of P1: part[k * grid + cta]; the factored F phase writes
// its d partials of B'x after these, at part + kMpParts * grid.
enum MpPart { kAx = 0, kDx2, kXqx, kLin, kDq, kGdx, kPrimal2, kMpParts };
// the initial trial and up to 100 halvings (the engine's _MAX_TRIALS = 100)
constexpr int kMaxTrials = 101;

// The problem and the scratch, shared by every row of a launch.
struct MpProblem {
  const void* q;     // dense: (n, n) symmetric; factored: B (n, d); row-major, f32 or bf16
  const float* lab;  // (n,): the labels, zero on padded coordinates
  float* xs;         // (2, n): x and x_prev by parity
  float* qxs;        // (2, n): Q x and Q x_prev by the same parity
  float* v;          // (n,): the last trial's v
  float* part;       // (kMpParts + d) * grid when factored, kMpParts * grid dense
  long long n, d;    // d: B's columns (factored), 0 dense
  int n_true;        // the linear term's mask: coordinates i < n_true
  int factored;
  float big_c;
  int hist_len;
};

// The sweep: `count` rows, one t each; the other entries of JAX's per-row scalar
// table (sigma0, C, tol, n_true) are the same for every row of a sweep.
struct MpRows {
  const float* ts;  // (count,) on the device
  int count;
  float sigma0, tol;
  int exact;        // the acceptance test's exact Bregman form
  int maxit, record;
  float* x_out;  // (count, n)
  float* stats;  // (count, 4): numit, norm_res, converged, ls_failed
  float* hist;   // (count, 5, hist_len): gamma, sigma, norm_res, trials, f
};

// One row's arguments, in shared memory.
struct MpSolve {
  float t;
  float* x_out;
  float* stats;
  float* hist;
};

// One whole solve (_dsvm_mp_core), run by every thread of the grid. Every thread
// carries the same scalars and takes the same branches. Returns with every CTA
// past its last grid sync of the solve; the caller syncs before the scratch is
// used again.
template <typename T, int V>
__device__ void mp_solve(const MpProblem& p, const MpRows& r, const MpSolve& s) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float warp_part[kMpParts][kWarps];
  __shared__ float s_red[kThreads];
  __shared__ float s_sum[kMpParts];
  __shared__ int s_numit;
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
  const float t = s.t;
  const float sqrt2 = sqrtf(2.f);
  const float* __restrict__ lab = p.lab;
  float* part_bx = p.part + kMpParts * gridDim.x;

  // the start: x0 = 0 and Q x0 = 0 in the parity-0 buffers
  for (long long j = gtid; j < n; j += nthreads) {
    p.xs[j] = 0.f;
    p.qxs[j] = 0.f;
  }
  grid.sync();

  float y = 0.f, a_x = 0.f, f_x = 0.f, sigma = r.sigma0, norm_res = f32_inf();
  int it = 0, par = 0;  // x = xs[par], Q x = qxs[par]: the last accepted trial's
  bool ls_failed = false;
  bool go = 0 < r.maxit && norm_res > r.tol;
  if (!go) {
    for (long long j = gtid; j < n; j += nthreads) s.x_out[j] = 0.f;
  }

  while (go) {
    const float* x_prev = p.xs + par * n;
    const float* qx_prev = p.qxs + par * n;
    float* x = p.xs + (1 - par) * n;
    float* qx = p.qxs + (1 - par) * n;
    // the dual step: w = y + sigma a_x, y = prox of (IndZero)* = Zero: the identity
    const float y_prev = y;
    y = y + sigma * a_x;
    const float sigma_prev = sigma;
    float st = sigma * sqrt2;
    int trials = 1;
    for (;;) {
      const float theta = st / sigma_prev;
      const float gamma = t * t * st;

      // T: the trial point
      for (long long j = gtid; j < n; j += nthreads) {
        const float one = j < p.n_true ? 1.f : 0.f;
        const float lj = lab[j];
        const float ybar = (1.f + theta) * (lj * y) - theta * (lj * y_prev);
        const float vj = x_prev[j] - gamma * (ybar + (qx_prev[j] - one));
        p.v[j] = vj;
        x[j] = nan_min(nan_max(vj, 0.f), p.big_c);
      }
      grid.sync();

      // F (factored): the partials of B'x, then B'x in every CTA
      if (p.factored) {
        phase_btx<T>(p.q, n, p.d, x, part_bx, s_red);
        grid.sync();
        reduce_btx(p.d, part_bx, s_btx, s_red);
      }

      // P1: (Q x)_i a warp a row; lane 0 the partials
      float acc[kMpParts] = {};
      for (long long i = gwarp; i < n; i += nwarps) {
        const float qxi = row_dot<T, V>(p.q, i, n, p.d, p.factored, x, s_btx, lane);
        if (lane == 0) {
          const float one = i < p.n_true ? 1.f : 0.f;
          const float xi = x[i];
          const float qpi = qx_prev[i];
          const float li = lab[i];
          const float dx = xi - x_prev[i];
          qx[i] = qxi;
          const float primal = (p.v[i] - xi) / gamma + (qxi - one) + li * y;
          acc[kAx] += li * xi;
          acc[kDx2] += dx * dx;
          acc[kXqx] += xi * qxi;
          acc[kLin] += one * xi;
          acc[kDq] += dx * (qxi - qpi);
          acc[kGdx] += (qpi - one) * dx;
          acc[kPrimal2] += primal * primal;
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kMpParts; ++k) warp_part[k][warp] = acc[k];
      }
      write_partials(warp_part, p.part, 0, kMpParts);
      grid.sync();

      // the test: warp k sums partial k over the CTAs (the seven sums at once), then
      // every thread decides from the same sums in the same order
      if (warp < kMpParts) {
        const float total = sum_part(p.part, warp, lane);
        if (lane == 0) s_sum[warp] = total;
      }
      __syncthreads();
      const float a_new = s_sum[kAx];
      const float f_new = 0.5f * s_sum[kXqx] - s_sum[kLin];
      const float dax = a_new - a_x;
      const float breg = r.exact ? nan_max(0.5f * s_sum[kDq], 0.f)
                                 : f_new - f_x - s_sum[kGdx];
      const float lhs = gamma * st * dax * dax + 2.f * gamma * breg;
      const bool failed = lhs > 0.95f * s_sum[kDx2];
      if (failed && trials < kMaxTrials) {
        st = st / 2.f;
        ++trials;
        continue;
      }

      // accepted (or the cap): the carry moves to this trial
      ls_failed = ls_failed || failed;
      norm_res = sqrtf(s_sum[kPrimal2] + a_new * a_new);  // the dual residual is -a_x
      if (r.record && blockIdx.x == 0 && threadIdx.x == 0) {
        s.hist[it] = gamma;
        s.hist[hl + it] = st;
        s.hist[2 * hl + it] = norm_res;
        s.hist[3 * hl + it] = static_cast<float>(trials);
        s.hist[4 * hl + it] = f_new;
      }
      a_x = a_new;
      f_x = f_new;
      sigma = st;
      ++it;
      par ^= 1;
      go = it < r.maxit && norm_res > r.tol;  // a NaN residual stops
      if (!go) {
        for (long long j = gtid; j < n; j += nthreads) s.x_out[j] = x[j];
      }
      break;
    }
  }

  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) {
      s.stats[0] = static_cast<float>(it);
      s.stats[1] = norm_res;
      s.stats[2] = norm_res <= r.tol ? 1.f : 0.f;
      s.stats[3] = ls_failed ? 1.f : 0.f;
    }
    if (r.record) {
      // histories are zero past numit
      if (threadIdx.x == 0) s_numit = it;
      __syncthreads();
      for (long long i = s_numit + threadIdx.x; i < hl; i += kThreads) {
#pragma unroll
        for (int k = 0; k < 5; ++k) s.hist[k * hl + i] = 0.f;
      }
    }
  }
}

// K6c: the rows one after another, a grid sync between two rows (the next solve
// reuses the scratch that other CTAs may still read).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1) resident_mp_kernel(const MpProblem p,
                                                                 const MpRows r) {
  __shared__ MpSolve s;
  for (int row = 0; row < r.count; ++row) {
    // also a block barrier: every thread is done with the previous row's s
    if (row > 0) cg::this_grid().sync();
    if (threadIdx.x == 0) {
      s = MpSolve{r.ts[row], r.x_out + row * p.n, r.stats + 4LL * row,
                  r.hist ? r.hist + 5LL * row * p.hist_len : nullptr};
    }
    __syncthreads();
    mp_solve<T, V>(p, r, s);
  }
}

ADAPROX_PICK_DSVM(resident_mp_kernel)

}  // namespace

extern "C" {

// The partials a CTA needs: part needs (parts + d) floats for each CTA of the
// grid when factored, parts dense.
int adaprox_resident_mp_parts() { return kMpParts; }

// K6c: `count` Malitsky-Pock solves, one for each t of ts (count,) on the device,
// from the first dual step sigma0. q dense (n, n) or, factored = 1, B (n, d), f32
// (q_is_bf16 = 0) or bf16; vec: 1, or 4 (f32) / 8 (bf16) when the rows' length (n
// dense, d factored) is a multiple of it and q is 16-byte aligned. lab (n), xs
// (2, n), qxs (2, n), v (n), part (part_len): f32 device buffers the caller owns.
// exact = 1: the acceptance test's exact Bregman form. x_out (count, n), stats
// (count, 4): numit, norm_res, converged, ls_failed; hist (count, 5, hist_len),
// hist_len = maxit rounded up to 128, zero past numit. Returns the cudaError_t of
// the launch (0 on success).
int adaprox_resident_mp_sweep(const void* q, int q_is_bf16, int vec, int factored, long long n,
                              long long d, const float* lab, int n_true, float big_c, float* xs,
                              float* qxs, float* v, float* part, long long part_len,
                              const float* ts, int count, float sigma0, float tol, int exact,
                              int maxit, int record, float* x_out, float* stats, float* hist,
                              void* stream_ptr) {
  const void* kernel = pick_resident_mp_kernel(q_is_bf16, vec);
  if (kernel == nullptr || !ts || n < 1 || (factored && d < 1) || n_true < 0 || n_true > n ||
      count < 1 || maxit < 0 || !x_out || !stats || (record && maxit > 0 && !hist)) {
    return cudaErrorInvalidValue;
  }
  const int hist_len = (maxit + 127) / 128 * 128;  // _hist_len(maxit)
  MpProblem prob{q, lab, xs, qxs, v, part, n, factored ? d : 0, n_true, factored != 0, big_c,
                 hist_len};
  MpRows rows{ts, count, sigma0, tol, exact != 0, maxit, record, x_out, stats,
              record ? hist : nullptr};
  void* args[] = {&prob, &rows};
  return static_cast<int>(launch_dsvm(kernel, args, n, prob.d, prob.factored, kMpParts, part_len,
                                      stream_ptr));
}

const char* adaprox_resident_mp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
