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
// 4 N d factored (0.05 us at 1280^2 on 67 TFLOP/s of f32 outside the tensor cores). So in
// practice the grid-wide barrier and the latency of the reads around it set the pace.
//
// Design (the layout from the shape alone: pd_plan in resident_dsvm.cuh, which
// ops/resident_pd.py::k6d_plan mirrors):
//   * One persistent cooperative launch, at most one CTA per SM, fewer when N has fewer rows
//     than the grid has warps (heart_scale's 384 rows take 24 CTAs of 16 warps). Warp w of
//     CTA c owns rows c * 16 + w, + 16 * grid, ... in every iteration.
//   * ONE grid sync an iteration, dense or factored. The dependencies allow it: labels'x of
//     the next iterate is summed by the warps that write it, so y_k is known before the row
//     pass of iteration k, which then takes the step for its own rows; norm_res_k is needed
//     only for the stop decision, which waits for the next sync (x_k is still in the other
//     half of xs then, so a converged solve returns it). An iteration k:
//       after the sync   every CTA sums the last pass's partials, each in one fixed order
//                        (warps 0-3 the scalars; the other warps meanwhile stage x_k in
//                        shared memory, dense, or reduce the grid's partials of B'x_k into
//                        it, factored), then thread 0 takes norm_res_{k-1}, the record row,
//                        the stop decision and y_k from the same bits in every CTA;
//       the row pass     a warp a row: (Q x_k)_i from Q_i and x_k (dense) or B_i and B'x_k
//                        (factored); lane 0 forms grad_i, the residual term, v_i and
//                        x_{k+1,i} = clamp(v_i) into the other half of xs, and adds to the
//                        CTA's partials of labels'x_{k+1}, ||primal||^2, x_k.Qx_k and
//                        ones.x_k; factored, the lanes add x_{k+1,i} B_i into the warp's
//                        partial of B'x_{k+1} (the same columns a lane read in the dot),
//                        which the CTA then sums over its warps in warp order;
//       grid.sync()
//     The partials alternate between two halves of `part`, as x between the halves of xs: a
//     CTA may write the next pass's while another still sums the last's.
//   * Route 0 (where the plan finds room, as at all three of the driver's shapes): each CTA
//     holds its rows of Q or B in shared memory, loaded once before the loop, with each held
//     row's v, label and (factored) x; route 1 reads the rows from device memory (the L2)
//     every pass, v and the labels too. Dense x is staged in shared memory once a CTA an
//     iteration where it fits (route 1 past 57856 points reads it from device memory), and
//     the warps' partials of B'x live in shared memory where they fit (else in `part`).
//   * Dense, the bits are those of the kernel with two grid syncs an iteration that this one
//     replaced (experiments/k6_clusters.py --k6d-against compares them): the same warp owns
//     the same row, the dot is warp_dot's order whichever memory holds the row, and the
//     partials are written and summed in the same order (write_partials, sum_part).
//     Factored, B'x's partials are sums over the rows a CTA owns, not over a contiguous
//     slice, so the bits differ within rounding.
//   * x0 = 0 (the engine's warm-up from y0 = 0): the warm-up pass forms Q x0 as the plain
//     version does (0, or NaN where Q or B holds a value that is not finite; factored, B'x0
//     takes one grid sync more, once a launch) and writes x_0 by the row ownership, so that
//     labels'x_0's partials (and B'x_0's) are summed in the loop's order.
//   * IEEE semantics as K2 (no fast math, IEEE division and square root; NaN-propagating
//     min/max like jnp.minimum and jnp.clip; -fmad=false, so each elementwise expression
//     rounds after every operation as the plain PyTorch version does; the dot products use
//     explicit fmaf).

#include "resident_dsvm.cuh"

namespace {

// The problem, the scratch, the layout and the solve's scalars and outputs.
struct PdProblem {
  const void* q;     // dense: (n, n) symmetric; factored: B (n, d); row-major, f32 or bf16
  const float* lab;  // (n,): the labels, zero on padded coordinates
  float* xs;         // (2, n): the iterates by parity
  float* v;          // (n,): route 1's v (route 0 holds each row's in shared memory)
  float* part;       // PdPlan::part_len floats
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
  PdPlan plan;
};

__device__ __forceinline__ float box(float v, float big_c) {
  return nan_min(nan_max(v, 0.f), big_c);
}

// One whole solve (_dsvm_cv_core), run by every thread of the grid. kHeld: route 0.
template <typename T, int V, bool kHeld>
__global__ void __launch_bounds__(kThreads, 1) resident_pd_kernel(const PdProblem p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float warp_part[kPdParts][kWarps];
  __shared__ float s_sum[kPdParts];
  __shared__ float s_y[2];
  __shared__ int s_go, s_conv;
  extern __shared__ float4 s_dyn[];
  char* const dyn = reinterpret_cast<char*>(s_dyn);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * kThreads;
  const long long gwarp = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  const long long n = p.n, d = p.d;
  const bool factored = p.factored != 0;
  const long long len = factored ? d : n;  // a row of Q or B
  const long long rpw = p.plan.rows_per_warp;
  const long long rpc = p.plan.rows_per_cta;
  const T* __restrict__ q = static_cast<const T*>(p.q);
  const float* __restrict__ lab = p.lab;
  const float gamma = p.gamma;

  // shared memory (route 0: the rows, then each row's v, label and x by slot warp * rpw + j)
  T* const s_rows = reinterpret_cast<T*>(dyn);
  float* const slot_v = reinterpret_cast<float*>(dyn + p.plan.off_slots);
  float* const slot_lab = slot_v + rpc;
  float* const slot_x = slot_lab + rpc;
  float* const s_vec = reinterpret_cast<float*>(dyn + p.plan.off_vec);  // x_k or B'x_k
  float4* const s_red = reinterpret_cast<float4*>(dyn + p.plan.off_red);
  const bool x_shared = kHeld || p.plan.x_shared;
  // this warp's partial of B'x (factored): shared memory, or its slice of part past the
  // two parities' partials
  const long long half = (kPdParts + d) * gridDim.x;  // one parity of the partials
  float* const acc_cta = (kHeld || p.plan.acc_shared)
                             ? reinterpret_cast<float*>(dyn + p.plan.off_acc)
                             : p.part + 2 * half + static_cast<long long>(blockIdx.x) * kWarps * d;
  float* const wacc = acc_cta + warp * d;

  // This CTA's partials into the half of part for iterate z: the scalars from warp_part (which
  // lane 0 of each warp has written), and factored B'x summed over the warps in warp order.
  auto write_pass = [&](int z) {
    float* half_z = p.part + (z & 1) * half;
    write_partials(warp_part, half_z, 0, kPdParts);  // a block barrier first
    if (factored) {
      float* out = half_z + kPdParts * gridDim.x + static_cast<long long>(blockIdx.x) * d;
      for (long long c = threadIdx.x; c < d; c += kThreads) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += acc_cta[w * d + c];
        out[c] = s;
      }
    }
  };

  // The B'x reduce of the partials in half_c, by the threads of warps kPdParts.. (t >= 0);
  // finish_pass adds its groups after a block barrier.
  auto reduce_pass = [&](const float* half_c, int t) {
    if constexpr (V > 1) {
      reduce_btx<4>(d, half_c + kPdParts * gridDim.x, s_vec, s_red, t);
    } else {
      reduce_btx<1>(d, half_c + kPdParts * gridDim.x, s_vec, s_red, t);
    }
  };
  auto finish_pass = [&](int t, int nt) {
    if constexpr (V > 1) {
      finish_btx<4>(d, s_vec, s_red, t, nt);
    } else {
      finish_btx<1>(d, s_vec, s_red, t, nt);
    }
  };

  // warm-up (_dsvm_cv_core's engine _init): x0 = 0, y0 = 0, grad0 = Q x0 - 1[i < n_true],
  // v = x0 - gamma grad0, x_0 = clamp(v). Q x0 is formed as the plain version forms it: +-0,
  // or NaN in a row (factored: everywhere) where Q or B holds a value that is not finite.
  // Route 0 loads its rows and slots here.
  if (factored) {
    // B'x0 first: the warps' partials over their rows, the grid's sum into s_vec
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kPdParts; ++k) warp_part[k][warp] = 0.f;
    }
    zero_acc<V>(wacc, d, lane);
    long long j = 0;
    for (long long i = gwarp; i < n; i += nwarps, ++j) {
      const long long s = warp * rpw + j;
      if (kHeld) copy_row<T, V>(s_rows + s * len, q + i * len, len, lane);
      add_row<T, V, kHeld>(wacc, kHeld ? s_rows + s * len : q + i * len, 0.f, d, lane);
    }
    write_pass(1);
    grid.sync();
    if (warp >= kPdParts) reduce_pass(p.part + half, threadIdx.x - 32 * kPdParts);
    __syncthreads();
    finish_pass(threadIdx.x, kThreads);
    __syncthreads();
  }
  {
    float ax = 0.f;
    if (factored) zero_acc<V>(wacc, d, lane);
    long long j = 0;
    for (long long i = gwarp; i < n; i += nwarps, ++j) {
      const long long s = warp * rpw + j;
      const T* row = kHeld ? s_rows + s * len : q + i * len;
      if (kHeld && !factored) copy_row<T, V>(s_rows + s * len, q + i * len, len, lane);
      const float qx0 = factored ? row_dot<T, V, kHeld>(row, s_vec, d, lane)
                                 : row_dot<T, V, kHeld, true>(row, nullptr, n, lane);
      float z = 0.f;
      if (lane == 0) {
        const float g = qx0 - (i < p.n_true ? 1.f : 0.f);
        const float vi = 0.f - gamma * g;
        const float li = __ldg(lab + i);
        z = box(vi, p.big_c);
        p.xs[i] = z;
        if (kHeld) {
          slot_v[s] = vi;
          slot_lab[s] = li;
          slot_x[s] = z;
        } else {
          p.v[i] = vi;
        }
        ax += li * z;
      }
      if (factored) add_row<T, V, kHeld>(wacc, row, __shfl_sync(kFull, z, 0), d, lane);
    }
    if (lane == 0) {
      warp_part[kAx][warp] = ax;
      warp_part[kPrimal2][warp] = warp_part[kFqx][warp] = warp_part[kFlin][warp] = 0.f;
    }
    write_pass(0);
  }
  grid.sync();

  // the carry, on thread 0 of each CTA (the same bits in every CTA): a_x of the last iterate,
  // y of the last two iterations, the last norm_res; every thread counts the iterates
  float a_x = 0.f, y_prev = 0.f, y = 0.f;
  float norm_res = f32_inf();
  bool conv = false;
  int cur = 0;  // the last pass wrote x_cur into xs[cur & 1]
  for (;;) {
    // the last pass's sums: warps 0-3 the scalar partials; meanwhile the others stage x_cur
    // (dense) or reduce the grid's partials of B'x_cur (factored) into s_vec
    const float* half_c = p.part + (cur & 1) * half;
    const float* x_c = p.xs + (cur & 1) * n;
    const int t = static_cast<int>(threadIdx.x) - 32 * kPdParts;
    if (warp < kPdParts) {
      const float total = sum_part(half_c, warp, lane);
      if (lane == 0) s_sum[warp] = total;
    } else if (factored) {
      reduce_pass(half_c, t);
    } else if (x_shared) {
      if constexpr (V > 1) {
        for (long long u = t; u < n / 4; u += kRedThreads) {
          reinterpret_cast<float4*>(s_vec)[u] = __ldcg(reinterpret_cast<const float4*>(x_c) + u);
        }
      } else {
        for (long long u = t; u < n; u += kRedThreads) s_vec[u] = __ldcg(x_c + u);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const float a_next = s_sum[kAx];
      if (cur > 0) {
        // iteration cur - 1's residual, record row and stop decision
        norm_res = sqrtf(s_sum[kPrimal2] + a_x * a_x);
        if (p.record && blockIdx.x == 0) {
          p.hist[cur - 1] = norm_res;
          p.hist[p.hist_len + cur - 1] = 0.5f * s_sum[kFqx] - s_sum[kFlin];
        }
      }
      const bool go = cur < p.maxit && norm_res > p.tol;  // a NaN residual stops
      if (go) {
        y_prev = y;
        y = y + p.sigma * (2.f * a_next - a_x);  // rho = 1; prox of (IndZero)* = Zero
        a_x = a_next;
      }
      s_go = go;
      s_conv = norm_res <= p.tol;
      s_y[0] = y_prev;
      s_y[1] = y;
    } else if (factored && threadIdx.x >= 32) {
      finish_pass(threadIdx.x - 32, kThreads - 32);
    }
    __syncthreads();
    conv = s_conv != 0;
    if (!s_go) {
      // converged: the iterate at the check, not the extra box step (:921-925); x_0 when no
      // iteration ran
      const float* src = conv && cur > 0 ? p.xs + ((cur - 1) & 1) * n : x_c;
      for (long long j = gtid; j < n; j += nthreads) p.x_out[j] = __ldcg(src + j);
      break;
    }
    const float yp = s_y[0], yc = s_y[1];

    // the row pass: iteration cur's step for this warp's rows, x_{cur+1} into the other half
    const float* vec = factored || x_shared ? s_vec : x_c;
    float* x_n = p.xs + ((cur + 1) & 1) * n;
    float acc[kPdParts] = {};
    if (factored) zero_acc<V>(wacc, d, lane);
    long long j = 0;
    for (long long i = gwarp; i < n; i += nwarps, ++j) {
      const long long s = warp * rpw + j;
      const T* row = kHeld ? s_rows + s * len : q + i * len;
      float xi = 0.f, vi = 0.f, li = 0.f;
      if (lane == 0) {
        xi = factored ? (kHeld ? slot_x[s] : x_c[i]) : vec[i];
        vi = kHeld ? slot_v[s] : p.v[i];
        li = kHeld ? slot_lab[s] : __ldg(lab + i);
      }
      const float qx = row_dot<T, V, kHeld>(row, vec, len, lane);
      float z = 0.f;
      if (lane == 0) {
        const float one = i < p.n_true ? 1.f : 0.f;
        const float g = qx - one;
        const float primal = (vi - xi) / gamma + g + li * yp;
        const float vn = xi - gamma * (g + li * yc);
        z = box(vn, p.big_c);
        x_n[i] = z;
        if (kHeld) {
          slot_v[s] = vn;
          if (factored) slot_x[s] = z;
        } else {
          p.v[i] = vn;
        }
        acc[kAx] += li * z;
        acc[kPrimal2] += primal * primal;
        acc[kFqx] += xi * qx;
        acc[kFlin] += one * xi;
      }
      if (factored) add_row<T, V, kHeld>(wacc, row, __shfl_sync(kFull, z, 0), d, lane);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kPdParts; ++k) warp_part[k][warp] = acc[k];
    }
    write_pass(cur + 1);
    grid.sync();  // the iteration's one grid-wide barrier
    ++cur;
  }

  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) {
      p.stats[0] = static_cast<float>(cur);
      p.stats[1] = norm_res;
      p.stats[2] = conv ? 1.f : 0.f;
    }
    if (p.record) {
      // histories are zero past numit
      for (long long i = cur + threadIdx.x; i < p.hist_len; i += kThreads) {
        p.hist[i] = 0.f;
        p.hist[p.hist_len + i] = 0.f;
      }
    }
  }
}

ADAPROX_PICK_DSVM(resident_pd_kernel)

}  // namespace

extern "C" {

// The scalar partials a CTA writes each pass (part's size: adaprox_resident_pd_plan).
int adaprox_resident_pd_parts() { return kPdParts; }

// K6d's layout for (n, d, factored, itemsize) on a card of sms SMs: out[kPdPlanOut] = route (0
// rows held in shared memory, 1 read from device memory), grid, rows a warp, rows a CTA,
// dynamic shared memory bytes, x staged in shared memory (dense), the warps' partials of B'x
// in shared memory (factored), the floats of part a launch needs. Returns 0, or
// cudaErrorInvalidValue for a shape it refuses.
int adaprox_resident_pd_plan(long long n, long long d, int factored, int itemsize, int sms,
                             long long* out) {
  PdPlan plan;
  if (!out || !pd_plan(n, d, factored != 0, itemsize, sms, &plan)) return cudaErrorInvalidValue;
  const long long nums[kPdPlanOut] = {plan.route, plan.grid, plan.rows_per_warp,
                                      plan.rows_per_cta, plan.smem, plan.x_shared,
                                      plan.acc_shared, plan.part_len};
  for (int k = 0; k < kPdPlanOut; ++k) out[k] = nums[k];
  return 0;
}

// K6d: one Condat-Vu solve with fixed (gamma, sigma). q dense (n, n) or, factored = 1, B
// (n, d), f32 (q_is_bf16 = 0) or bf16; vec: 1, or 4 (f32) / 8 (bf16) when the rows' length
// (n dense, d factored) is a multiple of it and q is 16-byte aligned. lab (n), xs (2, n), v
// (n), part (part_len >= the plan's part_len): f32 device buffers the caller owns; grad is
// not read (the argument stays so that a build of the two-sync kernel, which kept the
// gradient there, loads with the same signature). x_out (n); stats (3): numit, norm_res,
// converged; hist (2, hist_len): norm_res and the objective f(x), hist_len = maxit rounded up
// to 128, zero past numit. Returns the cudaError_t of the launch (0 on success).
int adaprox_resident_cv(const void* q, int q_is_bf16, int vec, int factored, long long n,
                        long long d, const float* lab, int n_true, float big_c, float* xs,
                        float* grad, float* v, float* part, long long part_len, float gamma,
                        float sigma, float tol, int maxit, int record, float* x_out,
                        float* stats, float* hist, void* stream_ptr) {
  (void)grad;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  PdPlan plan;
  if (n_true < 0 || n_true > n || maxit < 0 || !x_out || !stats ||
      (record && maxit > 0 && !hist) ||
      !pd_plan(n, d, factored != 0, q_is_bf16 ? 2 : 4, sms, &plan)) {
    return cudaErrorInvalidValue;
  }
  const void* kernel = pick_resident_pd_kernel(q_is_bf16, vec, plan.route == 0);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  PdProblem prob{q, lab, xs, v, part, n, factored ? d : 0, n_true, factored != 0, big_c,
                 (maxit + 127) / 128 * 128,  // _hist_len(maxit)
                 gamma, sigma, tol, maxit, record, x_out, stats, record ? hist : nullptr, plan};
  void* args[] = {&prob};
  return static_cast<int>(launch_pd(kernel, args, plan, part_len, stream_ptr));
}

const char* adaprox_resident_pd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
