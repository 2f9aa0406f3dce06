// K4 and K4b for Hopper: whole backtracking solves of f(x) + g(x) in one
// cooperative kernel launch: backtracking proximal gradient (the trial step
// inflated by xi each iteration) and backtracking Nesterov (theta momentum), with
// f any objective of K2 ("ls", "logreg", "cubic", the same runtime switch) and g
// any prox of its menu.
//
// Replaces the Pallas TPU kernels of adaprox_tpu/ops/resident_bt.py over its
// core _bt_core:
//   K4   resident_backtracking (bodies _bt_kernel / _bt_kernel_rec): one solve,
//        record mode a runtime flag;
//   K4b  resident_bt_sweep (body _bt_sweep_kernel_rec): R method rows of one
//        problem, each with its own gamma0, xi and momentum flag, in record mode.
// A is stored as f32 or bf16; every iterate, reduction and scalar is f32.
//
// The iteration (_bt_core): from x, with f_x and grad_x known, try
// z = prox(x - gamma grad_x) with gamma = gamma_prev * xi; while the
// sufficient-descent test
//     f(z) > f_x + <grad_x, z - x> + ||z - x||^2 / (2 gamma)
// (or, with exact_bregman and "ls", 0.5 ||res_z - res_x||^2 > ||z - x||^2 / (2 gamma))
// holds and fewer than 101 evaluations ran, shrink gamma and try again. A test
// still violated at the cap is latched into ls_failed; a NaN f(z) passes the test
// and is accepted, as in the JAX kernel. Then norm_res = ||z - x|| / gamma, the
// record row, and the next x: z itself (PG, its gradient from the trial's
// residual) or the momentum point z + ((theta - 1) / theta') (z - z_prev) with its
// own forward pass and gradient (Nesterov).
//
// What bounds it on the card. A is read from device memory once (16.8 MB at
// 4096x1024 f32, 5 us at 3.35 TB/s); a trial does 2 m n flops (A z), an accepted
// PG iteration 2 m n more (A^T res; none for "cubic", whose gradient is
// elementwise from H z) and a momentum point 4 m n (A x and A^T res; 2 n^2 for
// "cubic"). As for K2, what holds it back in practice is streaming A and A^T
// from L2 each phase and the grid-wide barriers: a one-trial PG iteration waits at
// three, a Nesterov iteration at five.
//
// Design (first, simple version; resident_common.cuh has the shared pieces):
//   * One persistent cooperative launch on K2's grid (launch()): at most one CTA
//     per SM, A and A^T in global memory (at the reference size both fit the
//     50 MB L2), the vectors in global memory too, so any shape runs.
//   * A trial is two phases with a grid sync after each:
//       T   z = prox(x - gamma grad_x) for the thread's coordinates, and this
//           CTA's partials of <grad_x, dz>, ||dz||^2, sum |z| and sum z^2;
//       P1  K2's forward phase at z (phase_res): res_z = A z - b (or the
//           logistic / cubic forms) and the partial of f, and under exact the
//           partial of ||res_z - res_x||^2.
//     Then every CTA sums the partials in one fixed order and decides the test
//     from the same bits, so every CTA takes the same number of trials: a CTA
//     that decided otherwise would wait at a barrier the others never reach.
//     T's partials alternate between two sets of slots by trial parity: a CTA
//     that has decided may start the next trial's T while another still reads
//     the last trial's sums.
//   * After acceptance, PG: P2 (for_each_grad), grad = A^T res_z (cubic:
//     elementwise from H z and ||z||^2, P1's kP1F slot, which nothing writes
//     between the two), and a sync. Nesterov: the momentum point, a sync, P1 at
//     it, a sync, P2 there, a sync. The stop test reads norm_res, known since T.
//   * The residuals at x and at z live in two buffers swapped by parity (exact
//     reads res_x while P1 writes res_z); z and the last accepted z likewise.
//   * K4 and K4b run the same device routine (bt_solve). K4b walks its rows one
//     after another, every CTA in the same order, with a grid sync between rows,
//     its row's arguments in shared memory as K2c's are. The same shape gives the
//     same grid, so row j of a sweep is bit-identical to one K4 launch with row
//     j's arguments. No atomics: two launches give the same bits.
//   * IEEE semantics as K2 (no fast math, IEEE division and square root,
//     NaN-propagating min/max, -fmad=false so each elementwise expression rounds
//     after every operation as the plain PyTorch version does).

#include "resident_common.cuh"

namespace {

// Per-CTA partial sums: part[k * grid + cta]. Slots 0-2 are P1's (kP1F, kP1Obj,
// kP1Breg); then T's four, at kT0 + parity * kTParts.
enum TPart { kGdz = 0, kDz2, kAbsZ, kZ2, kTParts };
constexpr int kT0 = kP1Breg + 1;
constexpr int kBtParts = kT0 + 2 * kTParts;
// the initial trial and up to 100 shrinks (the engine's _MAX_TRIALS = 100)
constexpr int kMaxEvals = 101;

// K4's use of the scratch: xs (2, n) the last accepted z and the trial z by
// parity, gs the gradient at x (its first n), v the momentum point, res (2, m)
// the residuals at x and at the trial z by parity.

// One solve: K4's arguments, or one row of K4b's table.
struct BtSolve {
  float gamma0, xi, shrink, tol;
  int nesterov, maxit, exact;
  float* x_out;  // (n,)
  float* stats;  // (5,): numit, norm_res, gamma, converged, ls_failed
  float* hist;   // (4, hist_len): gamma, norm_res, objective, trials; null unless record
};

// K4b's rows table, on the device, and what its rows share.
struct BtRows {
  const float* rows;  // (count, 3): gamma0, xi, nesterov flag (0 or 1)
  int count;
  float shrink, tol;
  int maxit, exact;
  float* x_out;  // (count, n)
  float* stats;  // (count, 5)
  float* hist;   // (count, 4, hist_len)
};

// One whole solve (_bt_core), run by every thread of the grid. Every thread
// carries the same scalars and takes the same branches. Returns with every CTA
// past its last grid sync of the solve; the caller syncs before the scratch is
// used again.
template <typename T, int VA, int VT>
__device__ void bt_solve(const Problem& p, const BtSolve& s) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float warp_part[kBtParts][kWarps];
  __shared__ float s_fx, s_fz, s_dz2, s_absz, s_z2;
  __shared__ int s_viol, s_more;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * kThreads;
  const long long m = p.m, n = p.n;
  const long long hl = p.hist_len;
  float* zs = p.xs;
  float* grad = p.gs;
  float* xm = p.v;
  // only the least-squares aux (the residual) gives the exact Bregman form
  const bool exact = s.exact && p.obj == kLs;

  // f(x0) from P1's sums, by warp 0 of every CTA, into s_fx
  auto objective_to = [&](float* out) {
    if (warp == 0) {
      const float sf = sum_part(p.part, kP1F, lane);
      const float so = p.obj == kCubic ? sum_part(p.part, kP1Obj, lane) : 0.f;
      if (lane == 0) *out = objective_of(p, sf, so);
    }
  };

  // the start: z = x0 (the first momentum step's z_prev), f and the gradient at
  // x0; the residual at x0 goes to res[0]
  for (long long j = gtid; j < n; j += nthreads) zs[j] = p.x0[j];
  phase_res<T, VA, true>(p, p.x0, p.res, nullptr, warp_part);
  grid.sync();
  objective_to(&s_fx);
  for_each_grad<T, VT>(p, p.x0, p.res, [&](long long j, float g) { grad[j] = g; });
  grid.sync();

  const float* x = p.x0;
  float f_x = s_fx;
  float gamma = s.gamma0, theta = 1.f, norm_res = f32_inf();
  int it = 0, zp = 0, rx = 0, tpar = 0;  // zs[zp] last accepted z, res[rx] residual at x
  bool ls_failed = false;
  bool go = 0 < s.maxit && norm_res > s.tol;

  while (go) {
    float* z = zs + (1 - zp) * n;
    const float* z_prev = zs + zp * n;
    float* res_z = p.res + (1 - rx) * m;
    const float* res_x = p.res + rx * m;
    float tg = gamma * s.xi;
    int evals = 1;
    for (;;) {
      // T: the trial point and its partials
      float acc[kTParts] = {};
      for (long long j = gtid; j < n; j += nthreads) {
        const float xj = x[j];
        const float gj = grad[j];
        const float zj = prox(p.prox, xj - tg * gj, tg, p.p1, p.p2);
        z[j] = zj;
        const float dz = zj - xj;
        acc[kGdz] += gj * dz;
        acc[kDz2] += dz * dz;
        acc[kAbsZ] += fabsf(zj);
        acc[kZ2] += zj * zj;
      }
      const int t0 = kT0 + tpar * kTParts;
#pragma unroll
      for (int k = 0; k < kTParts; ++k) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_down_sync(kFull, acc[k], off);
        if (lane == 0) warp_part[t0 + k][warp] = acc[k];
      }
      write_partials(warp_part, p.part, t0, t0 + kTParts);
      grid.sync();

      // P1 at z
      phase_res<T, VA, true>(p, z, res_z, exact ? res_x : nullptr, warp_part);
      grid.sync();

      // the test, from the same partials in the same order in every CTA
      if (warp == 0) {
        const float sf = sum_part(p.part, kP1F, lane);
        const float so = p.obj == kCubic ? sum_part(p.part, kP1Obj, lane) : 0.f;
        const float sb = exact ? sum_part(p.part, kP1Breg, lane) : 0.f;
        const float gdz = sum_part(p.part, t0 + kGdz, lane);
        const float dz2 = sum_part(p.part, t0 + kDz2, lane);
        const float absz = sum_part(p.part, t0 + kAbsZ, lane);
        const float z2 = sum_part(p.part, t0 + kZ2, lane);
        if (lane == 0) {
          const float f_z = objective_of(p, sf, so);
          const bool viol = exact ? 0.5f * sb > dz2 / (2.f * tg)
                                  : f_z > f_x + gdz + dz2 / (2.f * tg);
          s_viol = viol;
          s_more = viol && evals < kMaxEvals;
          s_fz = f_z;
          s_dz2 = dz2;
          s_absz = absz;
          s_z2 = z2;
        }
      }
      __syncthreads();
      tpar ^= 1;
      if (!s_more) break;
      tg = tg * s.shrink;
      ++evals;
    }

    // accepted (or the cap hit): the record row and the stop test
    gamma = tg;
    ls_failed = ls_failed || s_viol != 0;
    norm_res = sqrtf(s_dz2) / gamma;
    if (p.record && blockIdx.x == 0 && threadIdx.x == 0) {
      s.hist[it] = gamma;
      s.hist[hl + it] = norm_res;
      s.hist[2 * hl + it] = s_fz + gval_of(p, s_absz, s_z2);
      s.hist[3 * hl + it] = static_cast<float>(evals);
    }
    ++it;
    zp ^= 1;
    go = it < s.maxit && norm_res > s.tol;  // a NaN residual stops
    if (!go) break;

    // the next x, its f and its gradient; its residual goes to res_z's buffer
    if (s.nesterov) {
      const float theta_next = (1.f + sqrtf(1.f + 4.f * theta * theta)) / 2.f;
      const float coef = (theta - 1.f) / theta_next;
      theta = theta_next;
      for (long long j = gtid; j < n; j += nthreads) {
        const float zj = z[j];
        xm[j] = zj + coef * (zj - z_prev[j]);
      }
      grid.sync();
      phase_res<T, VA, true>(p, xm, res_z, nullptr, warp_part);
      grid.sync();
      objective_to(&s_fx);
      for_each_grad<T, VT>(p, xm, res_z, [&](long long j, float g) { grad[j] = g; });
      x = xm;
    } else {
      f_x = s_fz;
      for_each_grad<T, VT>(p, z, res_z, [&](long long j, float g) { grad[j] = g; });
      x = z;
    }
    rx ^= 1;
    grid.sync();
    if (s.nesterov) f_x = s_fx;
  }

  // x_out = the last accepted z (x0 when no iteration ran); each thread wrote
  // its own coordinates of it
  const float* z_last = zs + zp * n;
  for (long long j = gtid; j < n; j += nthreads) s.x_out[j] = z_last[j];
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) {
      s.stats[0] = static_cast<float>(it);
      s.stats[1] = norm_res;
      s.stats[2] = gamma;
      s.stats[3] = norm_res <= s.tol ? 1.f : 0.f;
      s.stats[4] = ls_failed ? 1.f : 0.f;
    }
    if (p.record) {
      // records are zero past numit
      for (long long i = it + threadIdx.x; i < hl; i += kThreads) {
        s.hist[i] = 0.f;
        s.hist[hl + i] = 0.f;
        s.hist[2 * hl + i] = 0.f;
        s.hist[3 * hl + i] = 0.f;
      }
    }
  }
}

// K4: one solve.
template <typename T, int VA, int VT>
__global__ void __launch_bounds__(kThreads, 1) resident_bt_kernel(const Problem p,
                                                                 const BtSolve s) {
  bt_solve<T, VA, VT>(p, s);
}

// K4b: the rows one after another, with a grid sync between two rows (the next
// solve reuses the scratch that other CTAs may still read); the row's arguments
// sit in shared memory, as K2c's do.
template <typename T, int VA, int VT>
__global__ void __launch_bounds__(kThreads, 1) resident_bt_sweep_kernel(const Problem p,
                                                                       const BtRows r) {
  __shared__ BtSolve s;
  for (int row = 0; row < r.count; ++row) {
    // also a block barrier: every thread is done with the previous row's s
    if (row > 0) cg::this_grid().sync();
    if (threadIdx.x == 0) {
      s = BtSolve{r.rows[3 * row],
                  r.rows[3 * row + 1],
                  r.shrink,
                  r.tol,
                  r.rows[3 * row + 2] > 0.f,
                  r.maxit,
                  r.exact,
                  r.x_out + row * p.n,
                  r.stats + 5LL * row,
                  r.hist + 4LL * row * p.hist_len};
    }
    __syncthreads();
    bt_solve<T, VA, VT>(p, s);
  }
}

ADAPROX_PICK(resident_bt_kernel)
ADAPROX_PICK(resident_bt_sweep_kernel)
#undef ADAPROX_PICK

}  // namespace

extern "C" {

// Partials per CTA: part needs kBtParts floats for each CTA of the grid.
int adaprox_resident_bt_parts() { return kBtParts; }

// K4, one whole backtracking solve. The problem arguments (obj_kind .. part_len)
// as for adaprox_resident_pg, except res: (2, m). x_out (n), stats (5) and, when
// record, hist (4, maxit; null when maxit is 0): f32 device buffers the caller
// owns. xi: the trial step's inflation (pass 1 for Nesterov); shrink: gamma's
// factor after a failed trial; nesterov: 0 PG, 1 Nesterov; exact: the
// exact-Bregman test (taken for obj_kind 0 only). Returns the cudaError_t of the
// launch (0 on success).
int adaprox_resident_bt(int obj_kind, float obj_pad, float obj_div, float cube_c, const void* a,
                        const void* at, int a_is_bf16, int va, int vt, const float* b,
                        const float* x0, float* xs, float* gs, float* v, float* res, float* part,
                        long long part_len, float* x_out, float* stats, float* hist, long long m,
                        long long n, int maxit, float gamma0, float xi, float shrink, float tol,
                        float p1, float p2, int prox_kind, int nesterov, int exact, int record,
                        void* stream_ptr) {
  const void* kernel = pick_resident_bt_kernel(a_is_bf16, va, vt);
  if (kernel == nullptr || !problem_ok(obj_kind, m, n, maxit, prox_kind) ||
      (record && maxit > 0 && !hist)) {
    return cudaErrorInvalidValue;
  }
  Problem prob{a, at, b, x0, xs, gs, v, res, part, m, n, maxit, p1,
               p2, obj_pad, obj_div, cube_c, obj_kind, prox_kind, record};
  BtSolve s{gamma0, xi, shrink, tol, nesterov != 0, maxit, exact != 0, x_out, stats, hist};
  return static_cast<int>(launch(kernel, prob, &s, kBtParts, part_len, stream_ptr));
}

// K4b, the backtracking sweep: `count` solves of one problem in one launch, in
// record mode. rows (count, 3) on the device: gamma0, xi, nesterov flag; the
// caller has checked every flag in {0, 1}. x_out (count, n), stats (count, 5),
// hist (count, 4, maxit; null when maxit is 0); the other arguments as for
// adaprox_resident_bt.
int adaprox_resident_bt_sweep(int obj_kind, float obj_pad, float obj_div, float cube_c,
                              const void* a, const void* at, int a_is_bf16, int va, int vt,
                              const float* b, const float* x0, float* xs, float* gs, float* v,
                              float* res, float* part, long long part_len, const float* rows,
                              int count, float* x_out, float* stats, float* hist, long long m,
                              long long n, int maxit, float shrink, float tol, float p1, float p2,
                              int prox_kind, int exact, void* stream_ptr) {
  const void* kernel = pick_resident_bt_sweep_kernel(a_is_bf16, va, vt);
  if (kernel == nullptr || !problem_ok(obj_kind, m, n, maxit, prox_kind) || count < 1 ||
      !rows || (maxit > 0 && !hist)) {
    return cudaErrorInvalidValue;
  }
  Problem prob{a, at, b, x0, xs, gs, v, res, part, m, n, maxit, p1,
               p2, obj_pad, obj_div, cube_c, obj_kind, prox_kind, 1};
  BtRows r{rows, count, shrink, tol, maxit, exact != 0, x_out, stats, hist};
  return static_cast<int>(launch(kernel, prob, &r, kBtParts, part_len, stream_ptr));
}

const char* adaprox_resident_bt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
