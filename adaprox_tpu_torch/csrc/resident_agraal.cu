// K4's aGRAAL core for Hopper: a whole aGRAAL solve of f(x) + g(x) in one
// cooperative kernel launch, with f any objective of K2 ("ls", "logreg",
// "cubic", the same runtime switch) and g any prox of its menu.
//
// Replaces the Pallas TPU kernel of adaprox_tpu/ops/resident_bt.py
// resident_agraal (bodies _ag_kernel / _ag_kernel_rec over _agraal_core): one
// solve, record mode a runtime flag. A is stored as f32 or bf16; every iterate,
// reduction and scalar is f32.
//
// The iteration (_agraal_core, reference src/AdaProx.jl:150-192): from x with
// the gradient g at x, the previous step's ||dx||^2 and ||dg||^2,
//     C      = ||dx||^2 / ||dg||^2                  (NaN, from 0/0, taken as +inf)
//     gamma' = min(rho gamma, phi theta C / (4 gamma), gamma_max),  rho = 1/phi + 1/phi^2
//     theta' = phi gamma' / gamma
//     x_bar' = ((phi - 1) x + x_bar) / phi
//     x'     = prox(x_bar' - gamma' g, gamma')
//     norm_res = ||x' - x|| / gamma'
// and the record row (gamma', norm_res, f(x') + g(x')). The start evaluates the
// gradient at x1 and at the companion point x0; gamma0 <= 0 selects the secant
// estimate ||x1 - x0|| / ||g1 - g0||, as sqrt over sqrt.
//
// What bounds it on the card. A is read from device memory once (16.8 MB at
// 4096x1024 f32, 5 us at 3.35 TB/s); an iteration does 4 m n flops (A x' and
// A^T res; 2 n^2 for "cubic", whose gradient is elementwise from H x'), the
// start 8 m n. As for K2, what holds it back in practice is streaming A and A^T
// from L2 each phase and the three grid-wide barriers an iteration.
//
// Design (first, simple version; resident_common.cuh has the shared pieces):
//   * One persistent cooperative launch on K2's grid (launch()): at most one CTA
//     per SM, A and A^T in global memory, the vectors in global memory too, so
//     any shape runs.
//   * An iteration is three phases with a grid sync after each:
//       T   x_bar and x' for the thread's coordinates, x updated in place, and
//           this CTA's partials of ||x' - x||^2, sum |x'| and sum x'^2;
//       P1  K2's forward phase at x' (phase_res): the residual and the partials
//           of f, which give the record's objective with no extra matvec;
//       P2  the gradient at x' (for_each_grad) written in place over the old
//           one, each coordinate's thread adding its (g' - g)^2 to the partial
//           of the next iteration's ||dg||^2 (its ||dx||^2 is T's sum).
//     The stop test is known after T: P1 runs only for the record or when the
//     solve goes on, P2 only when it goes on.
//   * Every warp of every CTA sums the partials in one fixed order (sum_part
//     and a broadcast from lane 0), so every thread holds the same bits of
//     every scalar and takes the same branches: a CTA that decided otherwise
//     would wait at a barrier the others never reach.
//   * No atomics: two launches give the same bits.
//   * IEEE semantics as K2 (no fast math, IEEE division and square root,
//     NaN-propagating min/max, -fmad=false so each elementwise expression rounds
//     after every operation as the plain PyTorch version does).

#include "resident_common.cuh"

namespace {

// Per-CTA partial sums: part[k * grid + cta]. Slots 0-2 are P1's (kP1F, kP1Obj,
// kP1Breg, the last unused here); then T's three and P2's one.
enum AgPart { kDx2 = kP1Breg + 1, kAbsX, kX2, kDg2, kAgParts };

// The scratch: xs's first n the average x_bar, gs's first n the gradient at x,
// res (m) the residual of the last P1. x itself lives in x_out.

// One solve's arguments.
struct AgSolve {
  const float* x0;  // (n,): the companion point
  float gamma0, gamma_max, phi, tol;
  int maxit;
  float* x_out;  // (n,): x1 in, updated in place, the final x out
  float* stats;  // (5,): numit, norm_res, gamma, converged, 0
  float* hist;   // (3, hist_len): gamma, norm_res, objective; null unless record
};

// The sum over CTAs of partial k, the same bits in every thread of the grid.
__device__ __forceinline__ float total(const float* part, int k, int lane) {
  return __shfl_sync(kFull, sum_part(part, k, lane), 0);
}

// The warp sum of v into warp_part[k][warp].
__device__ __forceinline__ void warp_partial(float v, float (*warp_part)[kWarps], int k,
                                             int lane, int warp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  if (lane == 0) warp_part[k][warp] = v;
}

// One whole solve (_agraal_core), run by every thread of the grid.
template <typename T, int VA, int VT>
__device__ void ag_solve(const Problem& p, const AgSolve& s) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float warp_part[kAgParts][kWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * kThreads;
  const long long n = p.n;
  const long long hl = p.hist_len;
  float* x = s.x_out;
  float* x_bar = p.xs;
  float* grad = p.gs;

  // the start: x = x_bar = x1 and the partial of ||x1 - x0||^2
  float acc = 0.f;
  for (long long j = gtid; j < n; j += nthreads) {
    const float x1 = p.x0[j];
    x[j] = x1;
    x_bar[j] = x1;
    const float d = x1 - s.x0[j];
    acc += d * d;
  }
  warp_partial(acc, warp_part, kDx2, lane, warp);
  write_partials(warp_part, p.part, kDx2, kDx2 + 1);
  // P1 and P2 at the companion point: grad = g0
  phase_res<T, VA, false>(p, s.x0, p.res, nullptr, warp_part);
  grid.sync();
  // read now: T first writes the slot three barriers later
  float dx2 = total(p.part, kDx2, lane);
  for_each_grad<T, VT>(p, s.x0, p.res, [&](long long j, float g) { grad[j] = g; });
  grid.sync();
  // P1 and P2 at x1: grad = g1, and the partial of ||g1 - g0||^2
  phase_res<T, VA, false>(p, x, p.res, nullptr, warp_part);
  grid.sync();
  float dg = 0.f;
  for_each_grad<T, VT>(p, x, p.res, [&](long long j, float g) {
    const float d = g - grad[j];
    dg += d * d;
    grad[j] = g;
  });
  if (lane == 0) warp_part[kDg2][warp] = dg;  // the gradient's lanes 0 carry the sums
  write_partials(warp_part, p.part, kDg2, kDg2 + 1);
  grid.sync();
  float dg2 = total(p.part, kDg2, lane);

  const float phi = s.phi;
  const float rho = 1.f / phi + 1.f / (phi * phi);
  // gamma0 <= 0 (or NaN) selects the secant estimate
  float gamma = s.gamma0 > 0.f ? s.gamma0 : sqrtf(dx2) / sqrtf(dg2);
  float theta = 1.f, norm_res = f32_inf();
  int it = 0;
  bool go = 0 < s.maxit && norm_res > s.tol;

  while (go) {
    // identical iterates give 0/0 = NaN: taken as +inf, so the min keeps the
    // growth bound (engine semantics)
    float curv = dx2 / dg2;
    if (isnan(curv)) curv = f32_inf();
    const float gamma_new =
        nan_min(nan_min(rho * gamma, phi * theta * curv / (4.f * gamma)), s.gamma_max);
    theta = phi * gamma_new / gamma;
    gamma = gamma_new;

    // T: x_bar, x' and their partials; x updated in place
    float a_dx2 = 0.f, a_abs = 0.f, a_x2 = 0.f;
    const float phi_m1 = phi - 1.f;
    for (long long j = gtid; j < n; j += nthreads) {
      const float xj = x[j];
      const float xb = (phi_m1 * xj + x_bar[j]) / phi;
      x_bar[j] = xb;
      const float xn = prox(p.prox, xb - gamma * grad[j], gamma, p.p1, p.p2);
      x[j] = xn;
      const float d = xn - xj;
      a_dx2 += d * d;
      a_abs += fabsf(xn);
      a_x2 += xn * xn;
    }
    warp_partial(a_dx2, warp_part, kDx2, lane, warp);
    warp_partial(a_abs, warp_part, kAbsX, lane, warp);
    warp_partial(a_x2, warp_part, kX2, lane, warp);
    write_partials(warp_part, p.part, kDx2, kX2 + 1);
    grid.sync();

    dx2 = total(p.part, kDx2, lane);
    norm_res = sqrtf(dx2) / gamma;
    ++it;
    go = it < s.maxit && norm_res > s.tol;  // a NaN residual stops
    if (p.record || go) {
      // P1 at x': f for the record, the residual for P2
      phase_res<T, VA, false>(p, x, p.res, nullptr, warp_part);
      grid.sync();
      if (p.record && blockIdx.x == 0 && warp == 0) {
        const float sf = sum_part(p.part, kP1F, lane);
        const float so = p.obj == kCubic ? sum_part(p.part, kP1Obj, lane) : 0.f;
        const float sa = sum_part(p.part, kAbsX, lane);
        const float sx = sum_part(p.part, kX2, lane);
        if (lane == 0) {
          s.hist[it - 1] = gamma;
          s.hist[hl + it - 1] = norm_res;
          s.hist[2 * hl + it - 1] = objective_of(p, sf, so) + gval_of(p, sa, sx);
        }
      }
    }
    if (!go) break;

    // P2: the gradient at x' over the old one, and the partial of ||g' - g||^2
    dg = 0.f;
    for_each_grad<T, VT>(p, x, p.res, [&](long long j, float g) {
      const float d = g - grad[j];
      dg += d * d;
      grad[j] = g;
    });
    if (lane == 0) warp_part[kDg2][warp] = dg;
    write_partials(warp_part, p.part, kDg2, kDg2 + 1);
    grid.sync();
    dg2 = total(p.part, kDg2, lane);
  }

  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) {
      s.stats[0] = static_cast<float>(it);
      s.stats[1] = norm_res;
      s.stats[2] = gamma;
      s.stats[3] = norm_res <= s.tol ? 1.f : 0.f;
      s.stats[4] = 0.f;
    }
    if (p.record) {
      // records are zero past numit
      for (long long i = it + threadIdx.x; i < hl; i += kThreads) {
        s.hist[i] = 0.f;
        s.hist[hl + i] = 0.f;
        s.hist[2 * hl + i] = 0.f;
      }
    }
  }
}

template <typename T, int VA, int VT>
__global__ void __launch_bounds__(kThreads, 1) resident_agraal_kernel(const Problem p,
                                                                     const AgSolve s) {
  ag_solve<T, VA, VT>(p, s);
}

ADAPROX_PICK(resident_agraal_kernel)
#undef ADAPROX_PICK

}  // namespace

extern "C" {

// Partials per CTA: part needs kAgParts floats for each CTA of the grid.
int adaprox_resident_agraal_parts() { return kAgParts; }

// K4's aGRAAL core, one whole solve. The problem arguments (obj_kind .. part_len)
// as for adaprox_resident_pg, with x1 in the x0 slot; x0c (n) the companion
// point. x_out (n), stats (5) and, when record, hist (3, maxit; null when maxit is
// 0): f32 device buffers the caller owns. gamma0 <= 0 selects the secant
// estimate. Returns the cudaError_t of the launch (0 on success).
int adaprox_resident_agraal(int obj_kind, float obj_pad, float obj_div, float cube_c,
                            const void* a, const void* at, int a_is_bf16, int va, int vt,
                            const float* b, const float* x1, float* xs, float* gs, float* v,
                            float* res, float* part, long long part_len, const float* x0c,
                            float* x_out, float* stats, float* hist, long long m, long long n,
                            int maxit, float gamma0, float gamma_max, float phi, float tol,
                            float p1, float p2, int prox_kind, int record, void* stream_ptr) {
  const void* kernel = pick_resident_agraal_kernel(a_is_bf16, va, vt);
  if (kernel == nullptr || !problem_ok(obj_kind, m, n, maxit, prox_kind) || !x0c ||
      (record && maxit > 0 && !hist)) {
    return cudaErrorInvalidValue;
  }
  Problem prob{a, at, b, x1, xs, gs, v, res, part, m, n, maxit, p1,
               p2, obj_pad, obj_div, cube_c, obj_kind, prox_kind, record};
  AgSolve s{x0c, gamma0, gamma_max, phi, tol, maxit, x_out, stats, hist};
  return static_cast<int>(launch(kernel, prob, &s, kAgParts, part_len, stream_ptr));
}

const char* adaprox_resident_agraal_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
