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
// "cubic"). What holds it back in practice is streaming A and A^T from L2 each
// phase and the grid-wide barriers between the phases.
//
// Design (resident_common.cuh has the shared pieces):
//   * One persistent cooperative launch on K2's grid: at most one CTA per SM, A
//     and A^T in global memory (at the reference size both fit the 50 MB L2), the
//     vectors in global memory too, so any shape runs.
//   * A phase is one pass with one grid sync after it. A trial is ONE phase: the
//     threads that own coordinate j (j = gtid, + grid threads, ...) form
//     z_j = prox(x_j - gamma grad_j), write it and add to this CTA's partials of
//     <grad_x, dz>, ||dz||^2, sum |z| and sum z^2; and the same phase's pass over A
//     (res_z = A z - b, or the logistic or cubic terms, and the partial of f, under
//     exact of ||res_z - res_x||^2) reads z without waiting for those writes: on
//     route "staged" every CTA first forms all n coordinates of z into shared
//     memory, on route "fly" each dot forms z_j as it goes. Both form z_j with the
//     owner's expression (one inlined prox, -fmad=false), so the dots see the
//     owner's bits. The momentum point z + coef (z - z_prev) is formed the same
//     way inside the pass that follows acceptance. So a PG iteration of one trial
//     takes two syncs (the trial, then the gradient A^T res_z), each extra trial
//     one, a Nesterov iteration three (the trial, the momentum point's forward
//     pass, its gradient); the parent's took three, two and five.
//   * After each sync every CTA sums the partials in one fixed order and decides
//     from the same bits (accept, shrink and retry, latch ls_failed at 101
//     evaluations, stop), so every CTA takes the same branches: a CTA that decided
//     otherwise would wait at a barrier the others never reach. A phase writes its
//     partials one sync after another CTA may still read the last phase's, so each
//     row's forward passes alternate between two halves of its slots by parity.
//     Cubic's gradient reads ||x||^2 of its point from the half the pass that
//     formed the point wrote.
//   * K4b runs its rows in lockstep groups of up to kGroup on K2's grid, as K2c
//     does: in a phase each running row takes its own next step (a trial, a
//     momentum point or a gradient), the forward rows' dots of a row of A sharing
//     one pass over it (group_dot), then the gradient rows' over A^T, with one sync
//     for the group. Row g keeps K4's scratch of its own (xs, gs, v, res (2, m) and
//     its slots), every sum in K4's order on K4's grid, so row g is one K4 launch
//     with its arguments bit for bit, wherever it lands. The warm-up (f and the
//     gradient at x0, the same bits for every row) runs once for the group. A group
//     pays the syncs of its longest row; a table of more than kGroup rows runs its
//     groups in turn, with a sync between two. K4 is the same routine instantiated
//     for one row (its own kernel: no group bookkeeping in its loops).
//   * No atomics: two launches give the same bits. IEEE semantics as K2 (no fast
//     math, IEEE division and square root, NaN-propagating min/max, -fmad=false so
//     each elementwise expression rounds after every operation as the plain version
//     does).

#include "resident_common.cuh"

namespace {

// Per-CTA partial sums of row g of a group: part[(g kBtParts + q kHalf + k) grid + cta],
// q the parity of the forward pass that wrote them. k: P1's kP1F, kP1Obj, kP1Breg, then
// the trial's four.
enum BtPart { kGdz = kP1Breg + 1, kDz2, kAbsZ, kZ2, kHalf };
constexpr int kBtParts = 2 * kHalf;
// the initial trial and up to 100 shrinks (the engine's _MAX_TRIALS = 100)
constexpr int kMaxEvals = 101;
// the shared memory a CTA may take, and what the launcher keeps of it for the
// kernel's static shared memory; route "staged" holds the group's points in the rest
constexpr long long kCtaSmem = 232448;
constexpr long long kStaticSmem = 8192;

// What a row runs in the coming phase (or, in a decision, ran in the last one).
enum Step { kStart = 0, kTrial, kMom, kGrad, kDone };

// The launch's rows: K4b's table, or K4's one row.
struct BtRows {
  const float* rows;  // (count, 3) on the device: gamma0, xi, nesterov flag; null for K4
  float gamma0, xi;   // K4's row
  int nesterov;
  int count;
  float shrink, tol;
  int maxit, exact, staged;
  int held, rows_per_warp;  // A's rows held in shared memory, and the rows a warp owns
  float* x_out;  // (count, n)
  float* stats;  // (count, 5): numit, norm_res, gamma, converged, ls_failed
  float* hist;   // (count, 4, hist_len): gamma, norm_res, objective, trials; null unless record
  int* syncs;    // the grid syncs the launch took, or null
};

// A row's arguments and carry, in shared memory. Lane 0 of warp g writes row g's in
// the decision; every thread reads them after the barrier that follows.
struct RowSt {
  float gamma0, xi;
  int nesterov;
  float tg, gamma, theta, coef, f_x, norm_res;
  float cg;  // "cubic": ||x|| c / 2 of the next trial's fused gradient
  int fused; // the next trial forms its gradient ("cubic", after an iteration)
  int it, evals, failed;
  int zp;    // xs[zp] the last accepted z
  int rx;    // res[rx] the residual at x
  int par;   // the half of the slots the row's next forward pass writes
  int next;  // Step
  int fin;   // stopped in this decision
};

// K4's use of a row's scratch: xs (2, n) the last accepted z and the trial z by
// parity, gs its first n the gradient at x, v the momentum point, res (2, m) the
// residuals at x and at the trial z by parity.

// The point of a forward pass: the trial z_j = prox(u_j - s w_j) (u = x, w = grad_x,
// s = the trial's gamma) or the momentum point u_j + s (u_j - w_j) (u = z, w = z_prev,
// s = coef); its owners write it to out. "cubic" forms a trial's gradient inside it
// (fused): w = H x, the residual of the pass that formed x, and grad_j = (w_j + q_j) +
// cg x_j, for_each_grad's expression with cg = ||x|| c / 2, which its owners write to
// gout (a shrunk trial reads it there).
struct Pt {
  const float* u;
  const float* w;
  float* out;
  float* gout;
  float s, cg;
  int trial, fused;
};

// grad_j of a trial: w_j, or formed (fused) from w_j = (H x)_j, q_j = b_j and x_j = u_j
__device__ __forceinline__ float pt_grad(const Pt& q, float uj, float wj, float bj) {
  return q.fused ? (wj + bj) + q.cg * uj : wj;
}

__device__ __forceinline__ float pt_val(const Problem& p, const Pt& q, float uj, float wj,
                                        float bj) {
  if (!q.trial) return uj + q.s * (uj - wj);
  return prox(p.prox, uj - q.s * pt_grad(q, uj, wj, bj), q.s, p.p1, p.p2);
}

__device__ __forceinline__ float pt_at(const Problem& p, const Pt& q, long long j) {
  return pt_val(p, q, q.u[j], q.w[j], q.fused ? p.b[j] : 0.f);
}

// CTAs a lane of sum_parts takes at a time: up to 160 CTAs in one round of loads.
constexpr int kSumAhead = 5;

// sum_part over the K slots k0.. at once: each slot's total in sum_part's order (the
// same bits), the loads of every slot and of kSumAhead CTAs a lane in flight together;
// the totals in lane 0.
template <int K>
__device__ __forceinline__ void sum_parts(const float* part, int k0, int lane, float (&t)[K]) {
  const int grid = gridDim.x;
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = 0.f;
  for (int c0 = lane; c0 < grid; c0 += 32 * kSumAhead) {
    float v[kSumAhead][K];
#pragma unroll
    for (int i = 0; i < kSumAhead; ++i) {
      const int c = c0 + 32 * i;
#pragma unroll
      for (int k = 0; k < K; ++k) v[i][k] = c < grid ? part[(k0 + k) * grid + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kSumAhead; ++i) {
      if (c0 + 32 * i >= grid) break;
#pragma unroll
      for (int k = 0; k < K; ++k) t[k] += v[i][k];
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t[k] += __shfl_down_sync(kFull, t[k], off);
  }
}

// warp_dot with the vector formed as it goes (route "fly"): the same lanes, the same
// elements in the same fmaf chain (VEC consecutive ones a lane a step, each loaded
// alone: a vector load and VEC points in flight cost the registers the other routes
// need), the same shuffle tree; the total in lane 0.
template <typename T, int VEC>
__device__ __forceinline__ float fly_dot(const T* __restrict__ row, const Problem& p, const Pt& q,
                                         long long len, int lane) {
  float acc = 0.f;
  const long long steps = len / VEC;
  for (long long k = lane; k < steps; k += 32) {
#pragma unroll 1
    for (int e = 0; e < VEC; ++e) {
      float a;
      load_a<1>(row + k * VEC + e, &a);
      acc = fmaf(a, pt_at(p, q, k * VEC + e), acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(kFull, acc, off);
  return acc;
}

// group_dot of one row with plain loads (K4's A pass): the same packed loads in flight,
// the same fmaf chain and shuffle tree, so the same bits, without a second row's
// registers (group_dot's own for one row spilled in K4's kernel).
template <typename T, int VEC>
__device__ __forceinline__ float one_dot(const T* row, const float* vec, long long len,
                                         int lane) {
  constexpr int kAhead = kGroupAhead<VEC>;
  const long long steps = len / VEC;
  float s = 0.f;
  long long k = lane;
#pragma unroll 1
  for (; k + 32 * (kAhead - 1) < steps; k += 32 * kAhead) {
    Packed<T, VEC> a[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) a[u].load_plain(row + (k + 32 * u) * VEC);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      float xv[VEC];
      load_f32<VEC>(vec + (k + 32 * u) * VEC, xv);
#pragma unroll
      for (int q = 0; q < VEC; ++q) s = fmaf(a[u].at(q), xv[q], s);
    }
  }
#pragma unroll 1
  for (; k < steps; k += 32) {
    Packed<T, VEC> a;
    a.load_plain(row + k * VEC);
    float xv[VEC];
    load_f32<VEC>(vec + k * VEC, xv);
#pragma unroll
    for (int q = 0; q < VEC; ++q) s = fmaf(a.at(q), xv[q], s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
  return s;
}

// A row of A (or A^T) dotted with the vectors of the rows of `mask`, in warp_dot's
// order: lane g of the warp gets row g's (one row: lane 0). vec[g] the vectors
// (group_dot, K2c's, two rows a pass; one f32 row warp_dot; for bf16 warp_dot's unrolling
// keeps more registers in flight than group_dot's packed loads, and spilled here), or
// (fly) pts[g] the points formed in the dot. kPlain: the row read with plain loads (A's
// rows held in shared memory, or read without the read-only path), by group_dot (K4's
// one row: one_dot).
template <typename T, int VEC, int kMax, bool kPlain = false>
__device__ __forceinline__ float rows_dot(const T* __restrict__ row, unsigned mask, bool fly,
                                          const float* const* vec, const Problem& p,
                                          const Pt* pts, long long len, int lane) {
  float d[kGroup];
  if constexpr (kMax == 1 && kPlain) {
    if (!fly) return one_dot<T, VEC>(row, vec[0], len, lane);
  }
  if (fly) {
#pragma unroll 1
    for (int g = 0; g < kMax; ++g) {
      if (!(mask >> g & 1u)) continue;
      const float s = fly_dot<T, VEC>(row, p, pts[g], len, lane);
#pragma unroll
      for (int h = 0; h < kMax; ++h) {
        if (h == g) d[h] = s;
      }
    }
  } else if (!kPlain && sizeof(T) == 4 && !(mask & (mask - 1))) {
    // one f32 row: warp_dot, whose unrolling keeps more of a long row in flight
    const int g = __ffs(mask) - 1;
    const float s = warp_dot<T, VEC>(row, vec[g], len, lane);
    if constexpr (kMax == 1) {
      return s;
    } else {
      return __shfl_sync(kFull, s, 0);
    }
  } else {
    group_dot<T, VEC, kPlain>(row, vec, mask, len, lane, d);
  }
  if constexpr (kMax == 1) {
    return d[0];
  } else {
    return lane_row(d, lane);
  }
}

// P1 (phase_res) for the rows of `mask`, lane g of the warp that owns row i of A taking
// row g's terms: res = A x_g - b (or the logistic or cubic terms) into out[g] (and, for
// the warm-up, into the first buffer of `copies` rows), and the warp's partials of row
// g's kP1F, kP1Obj and, with prev[g] (exact), kP1Breg into wp[g]; each sum in
// phase_res's order. held: this CTA's rows of A in shared memory, row gwarp + k nwarps at
// held + (k kWarps + warp) n (route "held"), else null.
template <typename T, int VA, int kMax>
__device__ __forceinline__ void group_res(const Problem& p, unsigned mask, bool fly,
                                          const float* const* vec, const Pt* pts,
                                          float* const* out, const float* const* prev, int copies,
                                          const T* held, float (*wp)[kHalf][kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gwarp = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  const long long m = p.m, n = p.n;
  const T* __restrict__ a = static_cast<const T*>(p.a);
  const int g = lane;
  const bool mine = g < kMax && (mask >> g & 1u);
  float* res = mine ? out[g] : nullptr;
  const float* rp = mine ? prev[g] : nullptr;
  float f = 0.f, obj = 0.f, breg = 0.f;
  for (long long i = gwarp, k = 0; i < m; i += nwarps, ++k) {
    // one code path for both memories (a second spilled): plain loads
    const T* row = held ? held + (k * kWarps + warp) * n : a + i * n;
    const float d = rows_dot<T, VA, kMax, true>(row, mask, fly, vec, p, pts, n, lane);
    if (!mine) continue;
    const float bi = p.b[i];
    float v;
    if (p.obj == kCubic) {
      const float xi = fly ? pt_at(p, pts[g], i) : vec[g][i];
      v = d;
      f += xi * xi;
      obj += xi * d + 2.f * (bi * xi);
    } else if (p.obj == kLogreg) {
      v = 1.f / (1.f + expf(-d)) - bi;
      // softplus(-z) = logaddexp(0, -z), written stably
      const float softplus_neg = nan_max(-d, 0.f) + log1pf(expf(-fabsf(d)));
      f += (bi - 1.f) * d - softplus_neg;
    } else {
      v = d - bi;
      f += v * v;
      if (rp) {
        const float dr = v - rp[i];
        breg += dr * dr;
      }
    }
    for (int h = 0; h < copies; ++h) res[2 * m * h + i] = v;
  }
  if (mine) {
    wp[g][kP1F][warp] = f;
    wp[g][kP1Obj][warp] = obj;
    wp[g][kP1Breg][warp] = breg;
  }
}

// The gradient (for_each_grad) for the rows of `mask`: lane g of the warp that owns
// coordinate j writes row g's grad_j into grad[g] (for the warm-up into the gradient of
// `copies` rows), A^T's row j dotted with res[g]; "cubic" elementwise from res[g] = H x,
// x[g] and ||x|| from the P1 partials at slots[g] (those of the pass that formed res[g]).
template <typename T, int VT, int kMax>
__device__ __forceinline__ void group_grad(const Problem& p, unsigned mask,
                                           const float* const* res, const float* const* x,
                                           const float* const* slots, float* const* grad,
                                           int copies) {
  const int lane = threadIdx.x & 31;
  // coordinate j's warp: the CTAs in turn, then the warps (j's bits are its own dot's, so
  // no order of sums depends on which warp takes it); fewer rows than warps spread over
  // every SM
  const long long jwarp = static_cast<long long>(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  const long long m = p.m, n = p.n;
  const int g = lane;
  const bool mine = g < kMax && (mask >> g & 1u);
  if (p.obj == kCubic) {
    float coef = 0.f;
    for (int h = 0; h < kMax; ++h) {
      if (!(mask >> h & 1u)) continue;
      const float c = sqrtf(sum_part(slots[h], kP1F, lane)) * p.cube_c / 2.f;
      const float c0 = __shfl_sync(kFull, c, 0);
      if (lane == h) coef = c0;
    }
    if (!mine) return;
    for (long long j = jwarp; j < n; j += nwarps) {
      const float gj = (res[g][j] + p.b[j]) + coef * x[g][j];
      for (int h = 0; h < copies; ++h) grad[g][2 * n * h + j] = gj;
    }
    return;
  }
  const T* __restrict__ at = static_cast<const T*>(p.at);
  for (long long j = jwarp; j < n; j += nwarps) {
    const float d = rows_dot<T, VT, kMax>(at + j * m, mask, false, res, p, nullptr, m, lane);
    if (mine) {
      for (int h = 0; h < copies; ++h) grad[g][2 * n * h + j] = d;
    }
  }
}

// Coordinates a thread forms at a time: their loads in flight together.
constexpr int kForm = 4;

// The points of the forward rows of `mask`. Thread gtid owns coordinates gtid, + grid
// threads, ... of every row: it writes the row's point there and, for a trial, adds to
// the trial's four partials in the parent's order (the warp's sums into
// wp[g][kGdz..kZ2]). A CTA that stages (`staged` not null) forms every coordinate into
// staged[g n + j], thread t those of j = t, + kThreads, ...: among them, in the same
// order, the coordinates it owns (j / kThreads = blockIdx.x mod grid).
template <int kMax>
__device__ __forceinline__ void form_points(const Problem& p, const Pt* pts, unsigned mask,
                                            float* staged, float (*wp)[kHalf][kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long nthreads = static_cast<long long>(gridDim.x) * kThreads;
  const long long n = p.n;
  const long long first = staged ? threadIdx.x : static_cast<long long>(blockIdx.x) * kThreads +
                                                     threadIdx.x;
  const long long step = staged ? kThreads : nthreads;
#pragma unroll 1
  for (int g = 0; g < kMax; ++g) {
    if (!(mask >> g & 1u)) continue;
    const Pt q = pts[g];
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    // staged: j = threadIdx.x + chunk kThreads, owned where chunk = blockIdx.x mod grid
    long long chunk = 0, own = blockIdx.x;
    for (long long j0 = first; j0 < n; j0 += kForm * step) {
      float u[kForm], w[kForm], b[kForm];
#pragma unroll
      for (int e = 0; e < kForm; ++e) {
        const long long j = j0 + e * step;
        if (j < n) {
          u[e] = q.u[j];
          w[e] = q.w[j];
          b[e] = q.fused ? p.b[j] : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < kForm; ++e) {
        const long long j = j0 + e * step;
        if (j >= n) continue;
        const float gj = pt_grad(q, u[e], w[e], b[e]);
        const float zj = q.trial ? prox(p.prox, u[e] - q.s * gj, q.s, p.p1, p.p2)
                                 : u[e] + q.s * (u[e] - w[e]);
        if (staged) {
          staged[g * n + j] = zj;
          if (chunk + e != own) continue;
          own += gridDim.x;
        }
        q.out[j] = zj;
        if (q.fused) q.gout[j] = gj;
        if (q.trial) {
          const float dz = zj - u[e];
          acc[0] += gj * dz;
          acc[1] += dz * dz;
          acc[2] += fabsf(zj);
          acc[3] += zj * zj;
        }
      }
      chunk += kForm;
    }
    if (q.trial) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_down_sync(kFull, acc[k], off);
        if (lane == 0) wp[g][kGdz + k][warp] = acc[k];
      }
    }
  }
}

// write_partials for the forward rows of `mask`: row g's slots k < kGdz (every k for
// the rows of `trials`) in the half st[g].par, the sum over this CTA's warps in warp
// order.
template <int kMax>
__device__ __forceinline__ void bt_partials(float* part, float (*wp)[kHalf][kWarps],
                                            const RowSt* st, unsigned mask, unsigned trials) {
  __syncthreads();
  static_assert(kMax * kHalf <= kThreads, "a thread a (row, slot)");
  const int t = threadIdx.x;
  if (t < kMax * kHalf) {
    const int g = t / kHalf, k = t % kHalf;
    if ((mask >> g & 1u) && (k < kGdz || (trials >> g & 1u))) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += wp[g][k][w];
      part[(g * kBtParts + st[g].par * kHalf + k) * gridDim.x + blockIdx.x] = s;
    }
  }
}

// The launch's rows, groups of up to kMax in turn, each group's rows in lockstep (see
// the design note), run by every thread of the grid.
template <typename T, int VA, int VT, int kMax>
__device__ void bt_rows(const Problem& p, const BtRows& r) {
  cg::grid_group grid = cg::this_grid();
  // dynamic shared memory: this CTA's rows of A (route "held"), then the group's points
  // (G, n) on route "staged"
  extern __shared__ float4 bt_dynamic[];
  const long long held_bytes =
      r.held ? (static_cast<long long>(kWarps) * r.rows_per_warp * p.n * sizeof(T) + 15) / 16 * 16
             : 0;
  T* held = r.held ? reinterpret_cast<T*>(bt_dynamic) : nullptr;
  float* staged = reinterpret_cast<float*>(reinterpret_cast<char*>(bt_dynamic) + held_bytes);
  __shared__ RowSt st[kMax];
  __shared__ Pt pts[kMax];
  __shared__ float wp[kMax][kHalf][kWarps];
  // each row's pointers for the coming phase: its forward pass's vector, residual
  // out and residual at x (exact), its gradient pass's residual, point, P1 slots
  // and gradient out
  __shared__ const float* vec[kMax];
  __shared__ float* out[kMax];
  __shared__ const float* prev[kMax];
  __shared__ const float* rvec[kMax];
  __shared__ const float* xpt[kMax];
  __shared__ const float* slots[kMax];
  __shared__ float* gout[kMax];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * kThreads;
  const long long m = p.m, n = p.n;
  const long long hl = p.hist_len;
  const int grid_n = gridDim.x;
  // only the least-squares aux (the residual) gives the exact Bregman form
  const bool exact = r.exact && p.obj == kLs;
  const bool go = 0 < r.maxit && f32_inf() > r.tol;
  int syncs = 0;

  if (held) {
    // once a launch: warp w copies its rows of A (gwarp + k nwarps) to held + (k kWarps +
    // w) n, 16 bytes a lane at a time where rows are whole 16-byte vectors
    const long long gwarp = static_cast<long long>(blockIdx.x) * kWarps + warp;
    const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
    const T* a = static_cast<const T*>(p.a);
    for (long long i = gwarp, k = 0; i < m; i += nwarps, ++k) {
      const T* src = a + i * n;
      T* dst = held + (k * kWarps + warp) * n;
      if constexpr (VA > 1) {
        const uint4* s4 = reinterpret_cast<const uint4*>(src);
        uint4* d4 = reinterpret_cast<uint4*>(dst);
        for (long long c = lane; c < n / VA; c += 32) d4[c] = __ldg(s4 + c);
      } else {
        for (long long c = lane; c < n; c += 32) dst[c] = __ldg(src + c);
      }
    }
    __syncthreads();
  }

  for (int first = 0; first < r.count; first += kMax) {
    // also a block barrier: every thread is done with the previous group's st
    if (first > 0) {
      grid.sync();
      ++syncs;
    }
    const int G = min(kMax, r.count - first);
    if (threadIdx.x < G) {
      const int g = threadIdx.x;
      const int row = first + g;
      RowSt& s = st[g];
      if (r.rows) {
        s.gamma0 = r.rows[3 * row];
        s.xi = r.rows[3 * row + 1];
        s.nesterov = r.rows[3 * row + 2] > 0.f;
      } else {
        s.gamma0 = r.gamma0;
        s.xi = r.xi;
        s.nesterov = r.nesterov;
      }
      s.gamma = s.gamma0;
      s.tg = s.coef = s.f_x = s.cg = 0.f;
      s.fused = 0;
      s.theta = 1.f;
      s.norm_res = f32_inf();
      s.it = s.evals = s.failed = s.zp = s.rx = s.par = s.fin = 0;
      s.next = kStart;
      // the warm-up's: row 0's P1 at x0 into its first residual and slots
      vec[g] = p.x0;
      out[g] = p.res;
      prev[g] = nullptr;
      rvec[g] = p.res;
      xpt[g] = p.x0;
      slots[g] = p.part;
      gout[g] = p.gs;
    }
    __syncthreads();
    if (go) {
      // the start, once for the group (every row has the same bits): z = x0 (the
      // first momentum step's z_prev), P1 at x0 (row 0's slots, half 0) with its
      // residual in every row's res[0], then the gradient at x0 into every row's and
      // f(x0) into every row's f_x
      for (long long t = gtid; t < G * n; t += nthreads) {
        const int g = static_cast<int>(t / n);
        const long long j = t - g * n;
        p.xs[2 * n * g + j] = p.x0[j];
      }
      group_res<T, VA, kMax>(p, 1u, false, vec, pts, out, prev, G, held, wp);
      bt_partials<kMax>(p.part, wp, st, 1u, 0u);
      grid.sync();
      ++syncs;
      if (warp == 0) {
        float t[2];
        sum_parts<2>(p.part, kP1F, lane, t);
        if (lane == 0) {
          const float f0 = objective_of(p, t[0], p.obj == kCubic ? t[1] : 0.f);
          for (int h = 0; h < G; ++h) st[h].f_x = f0;
        }
      }
      group_grad<T, VT, kMax>(p, 1u, rvec, xpt, slots, gout, G);
      grid.sync();
      ++syncs;
    }

    for (;;) {
      // each row's decision on what it ran in the last phase, from its own partials
      // (lane 0 of warp g, the same bits in every CTA), and its pointers for the next
      if (warp < G) {
        const int g = warp;
        const int ran = st[g].next, q = st[g].par;
        const float* part = p.part + (g * kBtParts + q * kHalf) * grid_n;
        // the sums the decision needs (every slot of the half a forward pass wrote)
        float t[kHalf];
        if (ran == kTrial) {
          sum_parts<kHalf>(part, 0, lane, t);
        } else if (ran == kMom) {
          float f2[2];
          sum_parts<2>(part, kP1F, lane, f2);
          t[kP1F] = f2[0];
          t[kP1Obj] = f2[1];
        }
        __syncwarp();
        if (lane == 0) {
          // the row's state in registers, written back once
          RowSt s = st[g];
          s.fin = 0;
          if (ran == kTrial) {
            const float tg = s.tg;
            const float f_z = objective_of(p, t[kP1F], p.obj == kCubic ? t[kP1Obj] : 0.f);
            const float dz2 = t[kDz2];
            const bool viol = exact ? 0.5f * t[kP1Breg] > dz2 / (2.f * tg)
                                    : f_z > s.f_x + t[kGdz] + dz2 / (2.f * tg);
            s.par = q ^ 1;
            // a shrunk trial reads the gradient the fused one wrote
            s.fused = 0;
            if (viol && s.evals < kMaxEvals) {
              // shrink and try again
              s.tg = tg * r.shrink;
              ++s.evals;
            } else {
              // accepted (or the cap hit): the record row and the stop test
              s.gamma = tg;
              s.failed = s.failed || viol;
              const float norm_res = sqrtf(dz2) / tg;
              s.norm_res = norm_res;
              if (p.record && blockIdx.x == 0) {
                float* h = r.hist + 4LL * (first + g) * hl;
                h[s.it] = tg;
                h[hl + s.it] = norm_res;
                h[2 * hl + s.it] = f_z + gval_of(p, t[kAbsZ], t[kZ2]);
                h[3 * hl + s.it] = static_cast<float>(s.evals);
              }
              ++s.it;
              s.zp ^= 1;
              if (!(s.it < r.maxit && norm_res > r.tol)) {  // a NaN residual stops
                s.next = kDone;
                s.fin = 1;
              } else if (s.nesterov) {
                const float theta_next = (1.f + sqrtf(1.f + 4.f * s.theta * s.theta)) / 2.f;
                s.coef = (s.theta - 1.f) / theta_next;
                s.theta = theta_next;
                s.next = kMom;
              } else {
                s.f_x = f_z;
                s.next = kGrad;
              }
            }
          } else if (ran == kMom) {
            // f at the momentum point, its gradient next
            s.f_x = objective_of(p, t[kP1F], p.obj == kCubic ? t[kP1Obj] : 0.f);
            s.par = q ^ 1;
            s.next = kGrad;
          }
          if (s.next == kGrad && p.obj == kCubic) {
            // "cubic": the gradient is elementwise, formed inside the next trial from
            // the residual and ||x||^2 of the pass that formed x, this decision's sums
            s.cg = sqrtf(t[kP1F]) * p.cube_c / 2.f;
            s.fused = 1;
          }
          if (ran == kGrad || (s.next == kGrad && s.fused)) {
            // x is the point whose gradient the last phase formed (or the next trial
            // forms): the next iteration
            s.rx ^= 1;
            s.tg = s.gamma * s.xi;
            s.evals = 1;
            s.next = kTrial;
          } else if (ran == kStart) {
            s.tg = s.gamma0 * s.xi;
            s.evals = 1;
            s.next = go ? kTrial : kDone;
            s.fin = !go;
          }
          st[g] = s;
          // the row's pointers for the coming phase
          float* zs = p.xs + 2 * n * g;
          float* xm = p.v + n * g;
          float* res = p.res + 2 * m * g;
          if (s.next == kTrial) {
            const float* x = s.it == 0 ? p.x0 : (s.nesterov ? xm : zs + s.zp * n);
            float* gs = p.gs + 2 * n * g;
            pts[g] = Pt{x, s.fused ? res + s.rx * m : gs, zs + (1 - s.zp) * n, gs, s.tg, s.cg,
                        1, s.fused};
          } else if (s.next == kMom) {
            pts[g] = Pt{zs + s.zp * n, zs + (1 - s.zp) * n, xm, nullptr, s.coef, 0.f, 0, 0};
          }
          vec[g] = staged + g * n;
          out[g] = res + (1 - s.rx) * m;
          prev[g] = s.next == kTrial && exact ? res + s.rx * m : nullptr;
          // the gradient at the accepted z (PG) or the momentum point, whose residual
          // the last forward pass wrote to res[1 - rx] and its P1 sums to the other half
          rvec[g] = res + (1 - s.rx) * m;
          xpt[g] = s.nesterov ? xm : zs + s.zp * n;
          slots[g] = p.part + (g * kBtParts + (s.par ^ 1) * kHalf) * grid_n;
          gout[g] = p.gs + 2 * n * g;
        }
      }
      __syncthreads();
      unsigned trials = 0, moms = 0, grads = 0, fins = 0;
#pragma unroll
      for (int g = 0; g < kMax; ++g) {
        if (g >= G) break;
        const int next = st[g].next;
        if (next == kTrial) trials |= 1u << g;
        if (next == kMom) moms |= 1u << g;
        if (next == kGrad) grads |= 1u << g;
        if (st[g].fin) fins |= 1u << g;
      }
      if (fins) {
        // the rows that stopped: x_out = the last accepted z (x0 when none ran); CTA
        // 0 their stats and the records zero past numit
        for (long long t = gtid; t < G * n; t += nthreads) {
          const int g = static_cast<int>(t / n);
          const long long j = t - g * n;
          const RowSt& s = st[g];
          if (s.fin) r.x_out[(first + g) * n + j] = s.it ? p.xs[2 * n * g + s.zp * n + j] : p.x0[j];
        }
        if (blockIdx.x == 0) {
          for (int g = 0; g < G; ++g) {
            const RowSt& s = st[g];
            if (!s.fin) continue;
            const int row = first + g;
            if (threadIdx.x == 0) {
              float* stats = r.stats + 5LL * row;
              stats[0] = static_cast<float>(s.it);
              stats[1] = s.norm_res;
              stats[2] = s.gamma;
              stats[3] = s.norm_res <= r.tol ? 1.f : 0.f;
              stats[4] = s.failed ? 1.f : 0.f;
            }
            if (p.record) {
              float* h = r.hist + 4LL * row * hl;
              for (long long i = s.it + threadIdx.x; i < hl; i += kThreads) {
                h[i] = 0.f;
                h[hl + i] = 0.f;
                h[2 * hl + i] = 0.f;
                h[3 * hl + i] = 0.f;
              }
            }
          }
        }
      }
      if (!(trials | moms | grads)) break;

      // the phase: each running row's step
      const unsigned fwd = trials | moms;
      if (fwd) {
        // a CTA stages its points only where its warps have rows of A to dot them with
        const bool stage = r.staged && static_cast<long long>(blockIdx.x) * kWarps < m;
        form_points<kMax>(p, pts, fwd, stage ? staged : nullptr, wp);
        if (stage) __syncthreads();
        group_res<T, VA, kMax>(p, fwd, !r.staged, vec, pts, out, prev, 1, held, wp);
      }
      if (grads) group_grad<T, VT, kMax>(p, grads, rvec, xpt, slots, gout, 1);
      if (fwd) bt_partials<kMax>(p.part, wp, st, fwd, trials);
      grid.sync();
      ++syncs;
    }
  }
  if (r.syncs && blockIdx.x == 0 && threadIdx.x == 0) *r.syncs = syncs;
}

// K4: one solve, the routine for one row.
template <typename T, int VA, int VT>
__global__ void __launch_bounds__(kThreads, 1) resident_bt_kernel(const Problem p,
                                                                 const BtRows r) {
  bt_rows<T, VA, VT, 1>(p, r);
}

// K4b: the table's rows in lockstep groups of up to kGroup.
template <typename T, int VA, int VT>
__global__ void __launch_bounds__(kThreads, 1) resident_bt_sweep_kernel(const Problem p,
                                                                       const BtRows r) {
  bt_rows<T, VA, VT, kGroup>(p, r);
}

ADAPROX_PICK(resident_bt_kernel)
ADAPROX_PICK(resident_bt_sweep_kernel)
#undef ADAPROX_PICK

// K4/K4b's plan for `count` rows at (m, n), A's elements of `itemsize` bytes, on `sms`
// SMs (ops/resident_bt.py::k4b_plan computes the same): K2's grid, the rows of the
// largest group, the route (staged when the group's points fit a CTA's shared memory
// beside the static; held when, on top, the CTA's rows of A do: kWarps rows_per_warp
// rows, each row a warp owns, 16-byte aligned) and its dynamic shared memory.
struct BtPlan {
  int grid, group, staged, held, rows_per_warp;
  long long smem;
};

BtPlan bt_plan(int count, long long m, long long n, int itemsize, int sms) {
  const long long rows = m > n ? m : n;
  const long long want = (rows + kWarps - 1) / kWarps;
  BtPlan pl;
  pl.grid = static_cast<int>(want < sms ? want : sms);
  pl.group = count < kGroup ? count : kGroup;
  const long long nwarps = static_cast<long long>(pl.grid) * kWarps;
  pl.rows_per_warp = static_cast<int>((m + nwarps - 1) / nwarps);
  const long long points = 4LL * pl.group * n;
  const long long held = (kWarps * pl.rows_per_warp * n * itemsize + 15) / 16 * 16;
  const long long budget = kCtaSmem - kStaticSmem;
  pl.staged = points <= budget;
  pl.held = pl.staged && held + points <= budget;
  pl.smem = (pl.held ? held : 0) + (pl.staged ? points : 0);
  return pl;
}

// Launch kernel cooperatively on bt_plan's grid with its dynamic shared memory (K2's
// launch() takes none); part holds kBtParts partials a CTA for each row of a group.
cudaError_t bt_launch(const void* kernel, Problem& prob, BtRows& rows, int itemsize,
                      long long part_len, void* stream_ptr) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const BtPlan pl = bt_plan(rows.count, prob.m, prob.n, itemsize, sms);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (static_cast<long long>(attr.sharedSizeBytes) > kStaticSmem) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pl.smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      static_cast<size_t>(pl.smem));
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (static_cast<long long>(kBtParts) * pl.group * pl.grid > part_len) return cudaErrorInvalidValue;
  rows.staged = pl.staged;
  rows.held = pl.held;
  rows.rows_per_warp = pl.rows_per_warp;
  void* args[] = {&prob, &rows};
  err = cudaLaunchCooperativeKernel(kernel, dim3(pl.grid), dim3(kThreads), args,
                                    static_cast<size_t>(pl.smem),
                                    static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Partials per CTA and row of a group: part needs kBtParts floats for each CTA of the
// grid and each row of the largest group.
int adaprox_resident_bt_parts() { return kBtParts; }

// K4b's rows a lockstep group.
int adaprox_resident_bt_group() { return kGroup; }

// bt_plan for `count` rows at (m, n), A's `itemsize` (4 f32, 2 bf16), on `sms` SMs: out =
// grid, the rows of the largest group, the route (0 staged, 1 fly), A's rows held (0 or
// 1), the rows a warp owns, the dynamic shared memory in bytes. Returns 0, or
// cudaErrorInvalidValue for arguments no launch takes.
int adaprox_resident_bt_plan(int count, long long m, long long n, int itemsize, int sms,
                             long long* out) {
  if (count < 1 || m < 1 || n < 1 || sms < 1 || (itemsize != 2 && itemsize != 4) || !out) {
    return cudaErrorInvalidValue;
  }
  const BtPlan pl = bt_plan(count, m, n, itemsize, sms);
  out[0] = pl.grid;
  out[1] = pl.group;
  out[2] = pl.staged ? 0 : 1;
  out[3] = pl.held;
  out[4] = pl.rows_per_warp;
  out[5] = pl.smem;
  return 0;
}

// K4, one whole backtracking solve. The problem arguments (obj_kind .. part_len)
// as for adaprox_resident_pg, except res: (2, m). x_out (n), stats (5) and, when
// record, hist (4, maxit; null when maxit is 0): f32 device buffers the caller
// owns. xi: the trial step's inflation (pass 1 for Nesterov); shrink: gamma's
// factor after a failed trial; nesterov: 0 PG, 1 Nesterov; exact: the
// exact-Bregman test (taken for obj_kind 0 only); syncs: an int on the device for
// the grid syncs the launch takes, or null. Returns the cudaError_t of the launch
// (0 on success).
int adaprox_resident_bt(int obj_kind, float obj_pad, float obj_div, float cube_c, const void* a,
                        const void* at, int a_is_bf16, int va, int vt, const float* b,
                        const float* x0, float* xs, float* gs, float* v, float* res, float* part,
                        long long part_len, float* x_out, float* stats, float* hist, long long m,
                        long long n, int maxit, float gamma0, float xi, float shrink, float tol,
                        float p1, float p2, int prox_kind, int nesterov, int exact, int record,
                        int* syncs, void* stream_ptr) {
  const void* kernel = pick_resident_bt_kernel(a_is_bf16, va, vt);
  if (kernel == nullptr || !problem_ok(obj_kind, m, n, maxit, prox_kind) ||
      (record && maxit > 0 && !hist)) {
    return cudaErrorInvalidValue;
  }
  Problem prob{a, at, b, x0, xs, gs, v, res, part, m, n, maxit, p1,
               p2, obj_pad, obj_div, cube_c, obj_kind, prox_kind, record};
  BtRows r{nullptr, gamma0, xi, nesterov != 0, 1, shrink, tol, maxit, exact != 0, 0, 0, 0,
           x_out, stats, record ? hist : nullptr, syncs};
  return static_cast<int>(bt_launch(kernel, prob, r, a_is_bf16 ? 2 : 4, part_len, stream_ptr));
}

// K4b, the backtracking sweep: `count` solves of one problem in one launch, in
// record mode, in lockstep groups of at most kGroup rows. rows (count, 3) on the
// device: gamma0, xi, nesterov flag; the caller has checked every flag in {0, 1}.
// x_out (count, n), stats (count, 5), hist (count, 4, maxit; null when maxit is 0).
// The scratch holds K4's once for each row of the largest group (G = min(count,
// kGroup)): xs (G, 2, n), gs (G, 2, n), v (G, n), res (G, 2, m) and part (part_len >=
// G kBtParts SMs). The other arguments as for adaprox_resident_bt.
int adaprox_resident_bt_sweep(int obj_kind, float obj_pad, float obj_div, float cube_c,
                              const void* a, const void* at, int a_is_bf16, int va, int vt,
                              const float* b, const float* x0, float* xs, float* gs, float* v,
                              float* res, float* part, long long part_len, const float* rows,
                              int count, float* x_out, float* stats, float* hist, long long m,
                              long long n, int maxit, float shrink, float tol, float p1, float p2,
                              int prox_kind, int exact, int* syncs, void* stream_ptr) {
  const void* kernel = pick_resident_bt_sweep_kernel(a_is_bf16, va, vt);
  if (kernel == nullptr || !problem_ok(obj_kind, m, n, maxit, prox_kind) || count < 1 ||
      !rows || (maxit > 0 && !hist)) {
    return cudaErrorInvalidValue;
  }
  Problem prob{a, at, b, x0, xs, gs, v, res, part, m, n, maxit, p1,
               p2, obj_pad, obj_div, cube_c, obj_kind, prox_kind, 1};
  BtRows r{rows, 0.f, 0.f, 0, count, shrink, tol, maxit, exact != 0, 0, 0, 0,
           x_out, stats, hist, syncs};
  return static_cast<int>(bt_launch(kernel, prob, r, a_is_bf16 ? 2 : 4, part_len, stream_ptr));
}

const char* adaprox_resident_bt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
