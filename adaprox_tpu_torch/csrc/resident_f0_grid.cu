// K7a and K7b for Hopper: the coupling sweeps and the (dataset x t) grids of the f = 0
// composite family, one cooperative kernel launch each, with the linesearch on the device,
//
//     min lam_d ||x||_1 + h_d(A_d x),   h_d = Translate(inner, -bv_d),   inner = NormL2 or NormL1,
//
// the square-root lasso's (NormL2) and the least absolute deviation's (NormL1) sweep over
// t (experiments/square_root_lasso/runme.jl:80-95) and their whole multi-dataset
// experiment (:100-110 over the datasets x :80-95 over t): one whole early-exit solve for
// each (dataset, coupling t) cell, with one of two cores, each its own kernel.
//
// Replaces the Pallas TPU kernels adaprox_tpu/ops/resident.py::_f0_sweep (K7a, entered by
// resident_mpls_sweep and resident_adapdmp_sweep) and ::_f0_grid (K7b, entered by
// resident_mpls_grid and resident_adapdmp_grid), each over _mpls_core or _adapdmp_core.
// JAX's grid is its sweep with a dataset axis; here a sweep is the grid of one dataset.
// The D datasets come zero-padded to one common (m, n) (exact for this translate family:
// padded rows and columns stay exactly 0), stacked as A (D, m, n) and A' (D, n, m), f32
// or bf16, and bv (D, m); each dataset has its own lam and p2 (sigma0 for MP, eta0 = its
// ||A||_F for AdaPDM+), the t values are shared. Every iterate, reduction and scalar is
// f32. The solve routines and what they compute are in resident_f0_cores.cuh.
//
// What bounds it on the card. A trial does 2 m n flops (0.03 us at 8192 x 128 on 67
// TFLOP/s of f32 outside the tensor cores) on a dataset's A and A', which stay in the
// 50 MB L2 (8 MB at 8192 x 128 f32) while its cells run. The grid-wide barriers and the
// phases' latency set the pace, at the common shape: a dataset smaller than the common
// one runs at the common shape's iteration.
//
// Design:
//   * One persistent cooperative launch for all D x T cells (launch_f0 sizes the grid from
//     the common shape). The cells run one after another, d-major (cell i = d T + t, the
//     order of JAX's _f0_grid_kernel), a grid sync between two cells, through the same
//     routine on the same grid. So each cell equals the one-row launch on its dataset's
//     slice bit for bit.
//   * A cell's problem is a copy of the launch's, in shared memory, with its dataset's a,
//     at and bv slices (64-bit offsets) and lam; its rows a copy with its dataset's p2.
//     Thread 0 writes both from the device tables of lam and p2 before the routine runs,
//     and the block barrier that follows publishes them.
//   * The scratch is the launch's: each solve writes every slot it reads before reading
//     it (x0 = 0, y0 = 0, A x0 = 0, A'y0 = 0 to start), so nothing of the previous
//     dataset's cells, NaN included, reaches the next.

#include "resident_f0_cores.cuh"

namespace {

// The per-dataset entries of JAX's (D x T, 4) scalar table [t, p2_d, lam_d, tol]; t, tol
// and the rest come in SwRows.
struct GridSets {
  const float* lams;  // (D,) on the device
  const float* p2s;   // (D,): sigma0 (MP) or eta0 (AdaPDM+)
  int dcount;
};

// The cells one after another, a grid sync between two cells (the next solve reuses the
// scratch that other CTAs may still read). Each cell's problem and rows are copies in
// shared memory with its dataset's slice and scalars.
template <typename T, int V, int CORE>
__device__ __forceinline__ void grid_cells(const SwProblem& p, const SwRows& r, const GridSets& g,
                                           SwShared& sm, SwProblem& cp, SwRows& cr) {
  const long long mn = p.m * p.n;
  const int cells = g.dcount * r.count;
  for (int i = 0; i < cells; ++i) {
    // also a block barrier: every thread is done with the previous cell's sm, cp and cr
    if (i > 0) cg::this_grid().sync();
    if (threadIdx.x == 0) {
      const long long d = i / r.count;
      cp = p;
      cp.a = static_cast<const T*>(p.a) + d * mn;
      cp.at = static_cast<const T*>(p.at) + d * mn;
      cp.bv = p.bv + d * p.m;
      cp.lam = g.lams[d];
      cr = r;
      cr.p2 = g.p2s[d];
      sm.t = r.ts[i % r.count];
      sm.x_out = r.x_out + i * p.n;
      sm.stats = r.stats + 4LL * i;
      sm.hist = r.hist ? r.hist + 5LL * i * p.hist_len : nullptr;
    }
    __syncthreads();
    if constexpr (CORE == kCoreMp) {
      mp_solve<T, V>(cp, cr, sm);
    } else {
      adapdmp_solve<T, V>(cp, cr, sm);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1) resident_f0_grid_mp_kernel(const SwProblem p,
                                                                         const SwRows r,
                                                                         const GridSets g) {
  __shared__ SwShared sm;
  __shared__ SwProblem cp;
  __shared__ SwRows cr;
  grid_cells<T, V, kCoreMp>(p, r, g, sm, cp, cr);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1) resident_f0_grid_adapdmp_kernel(
    const SwProblem p, const SwRows r, const GridSets g) {
  __shared__ SwShared sm;
  __shared__ SwProblem cp;
  __shared__ SwRows cr;
  grid_cells<T, V, kCoreAdapdmp>(p, r, g, sm, cp, cr);
}

ADAPROX_PICK_F0(resident_f0_grid_mp_kernel)
ADAPROX_PICK_F0(resident_f0_grid_adapdmp_kernel)

}  // namespace

extern "C" {

// The partials a CTA needs: part holds this many floats for each CTA of the grid.
int adaprox_resident_f0_grid_parts() { return kSwParts; }

// K7b, and K7a at dcount 1: dcount x count solves of one core (0: Malitsky-Pock from the
// first dual step sigma0; 1: AdaPDM+ from the operator-norm estimate eta0), one for each
// (dataset d, coupling ts[t]) cell, d-major. a (dcount, m, n) and at (dcount, n, m) row-major, f32
// (a_is_bf16 = 0) or bf16; vec: 1, or 4 (f32) / 8 (bf16) when m and n are multiples of it
// and a and at are 16-byte aligned. bv (dcount, m); lams and p2s (dcount) and ts (count) on
// the device. xs (2, n), v (n), at_ys (2, n), ys (2, m), axs (2, m), w (m), part
// (part_len): f32 device buffers the caller owns. h_kind: 0 NormL2, 1 NormL1. x_out
// (dcount, count, n); stats (dcount, count, 4): numit, norm_res, converged, ls_failed;
// hist (dcount, count, 5, hist_len), hist_len = maxit rounded up to 128: gamma, sigma,
// norm_res, trials, the objective, zero past numit. Returns the cudaError_t of the launch
// (0 on success).
int adaprox_resident_f0_grid(const void* a, const void* at, int a_is_bf16, int vec, long long m,
                             long long n, const float* bv, int h_kind, const float* lams,
                             const float* p2s, int dcount, int core, float* xs, float* v,
                             float* at_ys, float* ys, float* axs, float* w, float* part,
                             long long part_len, const float* ts, int count, float tol,
                             int maxit, int record, float* x_out, float* stats, float* hist,
                             void* stream_ptr) {
  const void* kernel = core == kCoreMp ? pick_resident_f0_grid_mp_kernel(a_is_bf16, vec)
                       : core == kCoreAdapdmp
                           ? pick_resident_f0_grid_adapdmp_kernel(a_is_bf16, vec)
                           : nullptr;
  if (kernel == nullptr || !ts || !lams || !p2s || m < 1 || n < 1 ||
      (h_kind != kHL2 && h_kind != kHL1) || dcount < 1 || count < 1 ||
      static_cast<long long>(dcount) * count > 0x7fffffffLL || maxit < 0 || !x_out || !stats ||
      (record && maxit > 0 && !hist)) {
    return cudaErrorInvalidValue;
  }
  const int hist_len = (maxit + 127) / 128 * 128;  // _hist_len(maxit)
  // lam and p2 are each cell's; the launch's are placeholders the cells overwrite
  SwProblem prob{a, at, bv, xs, v, at_ys, ys, axs, w, part, m, n, h_kind, 0.f, hist_len};
  SwRows rows{ts, count, 0.f, tol, maxit, record, x_out, stats, record ? hist : nullptr};
  GridSets sets{lams, p2s, dcount};
  void* kargs[] = {&prob, &rows, &sets};
  return static_cast<int>(launch_f0(kernel, kargs, m, n, kSwParts, part_len, stream_ptr));
}

const char* adaprox_resident_f0_grid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
