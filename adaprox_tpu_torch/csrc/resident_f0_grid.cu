// K7a and K7b for Hopper: the coupling sweeps and the (dataset x t) grids of the f = 0
// composite family, one kernel launch each, with the linesearch on the device,
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
// padded rows and columns stay exactly 0), stacked as A (D, m, n), f32 or bf16, and bv
// (D, m); each dataset has its own lam and p2 (sigma0 for MP, eta0 = its ||A||_F for
// AdaPDM+), the t values are shared. Every iterate, reduction and scalar is f32. The solve
// routines and what they compute are in resident_f0_cores.cuh.
//
// What bounds it on the card. A trial does 2 m n flops (0.03 us at 8192 x 128 on 67
// TFLOP/s of f32 outside the tensor cores) and A is read once: the barriers between the
// phases and their latency set the pace. JAX keeps A and A' in VMEM for the whole launch;
// here a cell's A lives in the shared memory of the cluster that solves it.
//
// Design:
//   * One cell = one thread-block cluster of C CTAs (cudaLaunchKernelEx with a cluster
//     dimension; no cooperative launch, no grid-wide barrier). The grid is persistent:
//     as many clusters as cudaOccupancyMaxActiveClusters allows (at most one a cell).
//   * The cells run at once: rank 0 of a cluster takes the next cell from a device counter
//     (the launch's only atomic; zeroed by the caller for every launch) and hands it to its
//     peers through distributed shared memory; a cell that stops early frees its cluster.
//   * C is picked from the shape alone (f0_plan): the smallest cluster whose CTAs hold
//     their whole block of A's rows, the rows' vectors and the n-vectors in shared memory,
//     else kMaxCluster, with as many rows held as fit and the rest read from device memory
//     (L2) in each pass. So a cell gives the same bits on any cluster, in any wave, in a
//     sweep or in a grid: each sweep row equals its one-row launch and each grid cell the
//     sweep on its dataset's slice, bit for bit.
//   * A cell's CTAs load its rows of A and bv from its dataset's slice (64-bit offsets),
//     write every vector before reading it, and start from the cell's own lam, p2 and t, so
//     nothing of an earlier cell, NaN included, reaches the next.
//   * A CTA never leaves, and never takes a new cell, while a peer may still read its shared
//     memory: every cell begins with a cluster barrier, and the kernel ends with one.

#include "resident_f0_cores.cuh"

#include <mutex>

namespace {

// The launch: the datasets, the cells and where their outputs go; the CTAs' layout.
struct F0Grid {
  const void* a;     // (dcount, m, n) row-major, f32 or bf16
  const float* bv;   // (dcount, m)
  const float* lams;  // (dcount,) on the device
  const float* p2s;   // (dcount,): sigma0 (MP) or eta0 (AdaPDM+)
  const float* ts;    // (count,)
  long long m, n;
  int dcount, count, h_kind, maxit, record, hist_len;
  float tol;
  float* x_out;  // (dcount, count, n)
  float* stats;  // (dcount, count, 4)
  float* hist;   // (dcount, count, 5, hist_len)
  int* counter;  // the next cell
  float* scratch;  // (grid, per_cta): what shared memory does not hold
  long long per_cta;
  int rows_per, held, lda;
};

// The float counts of a CTA's vectors: red (kThreads V), the n-vectors (xs, v, at_ys,
// colpart: 7n) and the row vectors (ys, axs, w, bv: 6 R), each rounded up to 16 bytes.
__host__ __device__ constexpr long long round4(long long k) { return (k + 3) / 4 * 4; }
__host__ __device__ constexpr long long nvec_floats(long long n) { return round4(7 * n); }
__host__ __device__ constexpr long long rvec_floats(long long rows) { return round4(6 * rows); }
// A's row stride in shared memory: a whole number of V groups, an odd number of them, so that
// the threads of a quarter warp, a row each, read 16 bytes from distinct banks.
__host__ __device__ constexpr long long padded_lda(long long n, int vec) {
  return (n / vec + ((n / vec) % 2 == 0 ? 1 : 2)) * vec;
}

// kSmemVec: the vectors live in shared memory (else in the scratch, for shapes whose n or
// rows a CTA cannot hold them), so that the compiler reads them as shared memory.
template <typename T, int V, int CORE, bool kSmemVec>
__global__ void __launch_bounds__(kThreads, 1) resident_f0_cells_kernel(const F0Grid g) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ SwShared sm;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int csize = static_cast<int>(cl.num_blocks());
  const long long m = g.m, n = g.n;
  const int cells = g.dcount * g.count;

  // this CTA's rows and where its vectors live
  const long long r0 = static_cast<long long>(rank) * g.rows_per;
  const long long left = m - r0 < 0 ? 0 : m - r0;
  const int rows = static_cast<int>(left < g.rows_per ? left : g.rows_per);
  const int held = g.held < rows ? g.held : rows;
  float* f = reinterpret_cast<float*>(dyn);
  Cell c;
  c.red = f;
  f += kThreads * V;
  float* nv = f;
  if constexpr (kSmemVec) {
    f += nvec_floats(n) + rvec_floats(g.rows_per);
    c.colpart_global = nullptr;
  } else {
    nv = g.scratch + static_cast<long long>(blockIdx.x) * g.per_cta;
    c.colpart_global = g.scratch + static_cast<long long>(blockIdx.x - rank) * g.per_cta + 5 * n;
  }
  float* rv = nv + nvec_floats(n);
  T* a_s = reinterpret_cast<T*>(f);
  c.xs = nv;
  c.v = nv + 2 * n;
  c.at_ys = nv + 3 * n;
  c.colpart = nv + 5 * n;
  c.peer_stride = g.per_cta;
  c.ys = rv;
  c.axs = rv + 2 * g.rows_per;
  c.w = rv + 4 * g.rows_per;
  float* bv_s = rv + 5 * g.rows_per;
  c.bv = bv_s;
  c.a_s = a_s;
  c.rows = rows;
  c.held = held;
  c.lda = g.lda;
  c.n = n;
  c.rank = rank;
  c.csize = csize;
  c.h_kind = g.h_kind;
  c.maxit = g.maxit;
  c.record = g.record;
  c.hist_len = g.hist_len;
  c.tol = g.tol;

  int par = 0;
  for (;;) {
    // rank 0 takes the next cell; the barrier hands it to the peers (and keeps every CTA
    // from writing this cell's partials while a peer still reads the last cell's)
    if (rank == 0 && threadIdx.x == 0) sm.cell[par] = atomicAdd(g.counter, 1);
    cl.sync();
    if (threadIdx.x == 0) sm.cell_now = *cl.map_shared_rank(&sm.cell[par], 0);
    __syncthreads();
    const int cell = sm.cell_now;
    par ^= 1;
    if (cell >= cells) break;

    const long long d = cell / g.count;
    const T* a_d = static_cast<const T*>(g.a) + d * m * n + r0 * n;
    c.a_g = a_d;
    c.lam = g.lams[d];
    c.p2 = g.p2s[d];
    c.t = g.ts[cell % g.count];
    c.x_out = g.x_out + static_cast<long long>(cell) * n;
    c.stats = g.stats + 4LL * cell;
    c.hist = g.hist ? g.hist + 5LL * cell * g.hist_len : nullptr;
    // the cell's rows of A (the first `held` into shared memory) and of bv
    const long long units = n / V;
    for (long long k = threadIdx.x; k < held * units; k += kThreads) {
      const long long i = k / units, u = k % units;
      const T* src = a_d + i * n + u * V;
      T* dst = a_s + i * g.lda + u * V;
      if constexpr (V == 1) {
        *dst = *src;
      } else {
        *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
      }
    }
    for (int i = threadIdx.x; i < rows; i += kThreads) bv_s[i] = g.bv[d * m + r0 + i];
    __syncthreads();
    if constexpr (CORE == kCoreMp) {
      mp_solve<T, V>(c, sm);
    } else {
      adapdmp_solve<T, V>(c, sm);
    }
  }
  // no CTA leaves while a peer may still read its shared memory
  cl.sync();
}

template <typename T, int V, int CORE>
const void* kernel_of(bool smem_vec) {
  return smem_vec ? reinterpret_cast<const void*>(&resident_f0_cells_kernel<T, V, CORE, true>)
                  : reinterpret_cast<const void*>(&resident_f0_cells_kernel<T, V, CORE, false>);
}

template <typename T, int V>
const void* kernel_of(int core, bool smem_vec) {
  return core == kCoreMp ? kernel_of<T, V, kCoreMp>(smem_vec)
                         : kernel_of<T, V, kCoreAdapdmp>(smem_vec);
}

// The instantiation for (core, storage, vector width of A's rows, where the vectors live),
// or null.
const void* pick(int core, int a_is_bf16, int vec, bool smem_vec) {
  if (core != kCoreMp && core != kCoreAdapdmp) return nullptr;
  if (a_is_bf16) {
    if (vec == 1) return kernel_of<__nv_bfloat16, 1>(core, smem_vec);
    if (vec == 8) return kernel_of<__nv_bfloat16, 8>(core, smem_vec);
  } else {
    if (vec == 1) return kernel_of<float, 1>(core, smem_vec);
    if (vec == 4) return kernel_of<float, 4>(core, smem_vec);
  }
  return nullptr;
}

// The layout of a launch, from the shape alone (and the device's shared memory).
struct F0Plan {
  int cluster, rows_per, held, lda, smem_vec;
  long long smem, per_cta;
};

F0Plan f0_plan(long long m, long long n, int elt, int vec, long long budget) {
  const long long lda = padded_lda(n, vec);
  const long long red = 4LL * kThreads * vec, nvec = 4 * nvec_floats(n);
  F0Plan p{};
  p.cluster = kMaxCluster;
  for (int c = 1; c <= kMaxCluster; c *= 2) {
    const long long rows = (m + c - 1) / c;
    if (red + nvec + 4 * rvec_floats(rows) + rows * lda * elt <= budget) {
      p.cluster = c;
      break;
    }
  }
  const long long rows = (m + p.cluster - 1) / p.cluster;
  const long long vecs = nvec + 4 * rvec_floats(rows);
  long long avail = budget - red;
  p.smem_vec = vecs <= avail;
  if (p.smem_vec) avail -= vecs;
  const long long fit = avail > 0 ? avail / (lda * elt) : 0;
  p.rows_per = static_cast<int>(rows);
  p.held = static_cast<int>(fit < rows ? fit : rows);
  p.lda = static_cast<int>(lda);
  p.smem = budget - avail + static_cast<long long>(p.held) * lda * elt;
  p.per_cta = p.smem_vec ? 0 : nvec_floats(n) + rvec_floats(rows);
  return p;
}

// The plan of a launch of `core` at this shape, its kernel and the clusters that can be
// resident at once (asked of the occupancy calculator once a (device, kernel, shape)).
cudaError_t plan_for(int core, int a_is_bf16, int vec, long long m, long long n, F0Plan* plan,
                     const void** kernel_out, int* active) {
  struct Entry {
    int dev, core, bf16, vec;
    long long m, n;
    F0Plan plan;
    const void* kernel;
    int active;
  };
  const void* probe = pick(core, a_is_bf16, vec, true);
  if (probe == nullptr) return cudaErrorInvalidValue;
  static std::mutex mu;
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used; ++i) {
      const Entry& e = cache[i];
      if (e.dev == dev && e.core == core && e.bf16 == a_is_bf16 && e.vec == vec && e.m == m &&
          e.n == n) {
        *plan = e.plan;
        *kernel_out = e.kernel;
        *active = e.active;
        return cudaSuccess;
      }
    }
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr{};  // the static shared memory: the same in every instantiation
  err = cudaFuncGetAttributes(&attr, probe);
  if (err != cudaSuccess) return err;
  const long long budget = optin - static_cast<long long>(attr.sharedSizeBytes);
  const F0Plan p = f0_plan(m, n, a_is_bf16 ? 2 : 4, vec, budget);
  const void* kernel = pick(core, a_is_bf16, vec, p.smem_vec);
  // the kernel's cap on dynamic shared memory: the same for every shape
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(budget));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = p.cluster;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(p.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.attrs = la;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  *plan = p;
  *kernel_out = kernel;
  *active = clusters;
  std::lock_guard<std::mutex> lock(mu);
  if (used < 64) cache[used++] = Entry{dev, core, a_is_bf16, vec, m, n, p, kernel, clusters};
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The layout a launch at this shape takes, in out[0..7): the cluster size C, the clusters
// the launch runs (the resident ones, at most `cells`), the dynamic shared memory a CTA
// (bytes), the rows a CTA owns, the rows it holds in shared memory, whether the vectors are
// in shared memory (1) or in the scratch (0), and the floats of scratch the launch needs.
// Returns the cudaError_t.
int adaprox_resident_f0_grid_plan(long long m, long long n, int a_is_bf16, int vec, int core,
                                  int cells, long long* out) {
  if (m < 1 || n < 1 || cells < 1 || !out) return cudaErrorInvalidValue;
  F0Plan p{};
  const void* kernel = nullptr;
  int active = 0;
  const cudaError_t err = plan_for(core, a_is_bf16, vec, m, n, &p, &kernel, &active);
  if (err != cudaSuccess) return err;
  const int clusters = active < cells ? active : cells;
  out[0] = p.cluster;
  out[1] = clusters;
  out[2] = p.smem;
  out[3] = p.rows_per;
  out[4] = p.held;
  out[5] = p.smem_vec;
  out[6] = static_cast<long long>(clusters) * p.cluster * p.per_cta;
  return cudaSuccess;
}

// K7b, and K7a at dcount 1: dcount x count solves of one core (0: Malitsky-Pock from the
// first dual step sigma0; 1: AdaPDM+ from the operator-norm estimate eta0), one for each
// (dataset d, coupling ts[t]) cell, d-major. a (dcount, m, n) row-major, f32 (a_is_bf16 =
// 0) or bf16; vec: 1, or 4 (f32) / 8 (bf16) when n is a multiple of it and a is 16-byte
// aligned. bv (dcount, m); lams and p2s (dcount) and ts (count) on the device. counter: one
// int the caller zeroes for every launch; scratch: the floats adaprox_resident_f0_grid_plan
// asks for (scratch_len of them). h_kind: 0 NormL2, 1 NormL1. x_out (dcount, count, n);
// stats (dcount, count, 4): numit, norm_res, converged, ls_failed; hist (dcount, count, 5,
// hist_len), hist_len = maxit rounded up to 128: gamma, sigma, norm_res, trials, the
// objective, zero past numit. Returns the cudaError_t of the launch (0 on success).
int adaprox_resident_f0_grid(const void* a, int a_is_bf16, int vec, long long m, long long n,
                             const float* bv, int h_kind, const float* lams, const float* p2s,
                             int dcount, int core, int* counter, float* scratch,
                             long long scratch_len, const float* ts, int count, float tol,
                             int maxit, int record, float* x_out, float* stats, float* hist,
                             void* stream_ptr) {
  if (!ts || !lams || !p2s || !counter || m < 1 || n < 1 ||
      (h_kind != kHL2 && h_kind != kHL1) || dcount < 1 || count < 1 ||
      static_cast<long long>(dcount) * count > 0x7fffffffLL || maxit < 0 || !x_out || !stats ||
      (record && maxit > 0 && !hist) || (vec > 1 && n % vec != 0)) {
    return cudaErrorInvalidValue;
  }
  F0Plan p{};
  const void* kernel = nullptr;
  int active = 0;
  cudaError_t err = plan_for(core, a_is_bf16, vec, m, n, &p, &kernel, &active);
  if (err != cudaSuccess) return err;
  const int cells = dcount * count;
  const int clusters = active < cells ? active : cells;
  if (static_cast<long long>(clusters) * p.cluster * p.per_cta > scratch_len ||
      (p.per_cta > 0 && !scratch)) {
    return cudaErrorInvalidValue;
  }
  F0Grid g{a, bv, lams, p2s, ts, m, n, dcount, count, h_kind, maxit, record,
           (maxit + 127) / 128 * 128,  // _hist_len(maxit)
           tol, x_out, stats, record ? hist : nullptr, counter, scratch, p.per_cta,
           p.rows_per, p.held, p.lda};
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = p.cluster;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(clusters * p.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = static_cast<cudaStream_t>(stream_ptr);
  cfg.attrs = la;
  cfg.numAttrs = 1;
  void* kargs[] = {&g};
  err = cudaLaunchKernelExC(&cfg, kernel, kargs);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

const char* adaprox_resident_f0_grid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
