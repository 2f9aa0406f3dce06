// K6a, K6b and K6c for Hopper: the dual SVM's coupling sweeps, one kernel launch each, every
// value of t a whole early-exit solve on its own thread-block cluster, the rows at once,
//
//     min 0.5 x'Qx - 1'x   over 0 <= x <= C   with   labels'x = 0,
//
// the AdaPDM and the Malitsky-Pock sweeps of experiments/dual_svm/runme.jl:61 over the twelve
// couplings, with one of two cores, each its own kernel. Q is the N x N Gram (dense) or,
// factored, Q = B B' with B (N x d) = D_y X.
//
// Replaces the Pallas TPU kernels of adaprox_tpu/ops/resident.py:
//   K6a  resident_adapdm_dsvm (_pd_kernel over _pd_core): one AdaPDM solve, dense Q; here the
//        AdaPDM core's launch over one row, so a dense K6b row equals it bit for bit;
//   K6b  resident_adapdm_dsvm_sweep (_pd_sweep_kernel[_rec] over _pd_core): the AdaPDM sweep,
//        dense or factored;
//   K6c  _resident_mp_dsvm_sweep_jit (_dsvm_mp_sweep_kernel[_rec] over _dsvm_mp_core): the
//        Malitsky-Pock sweep with the linesearch on the device, dense or factored.
// Q or B is stored as f32 or bf16; every iterate, reduction and scalar is f32. The solve
// routines and what they compute are in resident_dsvm_cores.cuh. (K6d, the Condat-Vu solve,
// stays on its cooperative kernel in resident_pd.cu.)
//
// What bounds it on the card. An iteration or trial does 2 N^2 flops dense or 4 N d factored
// and Q is read once: the barriers between the phases and their latency set the pace. JAX
// keeps Q in VMEM for the whole launch; here a row's Q lives in the shared memory of the
// cluster that solves it, as far as it fits.
//
// Design:
//   * One row (one t) = one thread-block cluster of C CTAs (cudaLaunchKernelEx with a cluster
//     dimension; no cooperative launch, no grid-wide barrier). The grid is persistent: as many
//     clusters as cudaOccupancyMaxActiveClusters allows (at most one a row).
//   * The rows run at once: rank 0 of a cluster takes the next row from a device counter (the
//     launch's only atomic; zeroed by the caller for every launch) and hands it to its peers
//     through distributed shared memory; a row that stops early frees its cluster.
//   * C is picked from the shape and the storage alone (dsvm_plan): the smallest cluster whose
//     CTAs hold their whole block of Q's (or B's) rows and their vectors in shared memory, else
//     kMaxCluster, with as many rows held as fit and the rest read from device memory (L2) in
//     every pass. So a row gives the same bits on any cluster, in any wave, beside any other
//     rows: each sweep row equals its one-row launch bit for bit.
//   * Each CTA loads its held rows of Q and the labels once, for every row it solves; a row
//     writes every vector before reading it and starts from its own t, so nothing of an
//     earlier row, NaN included, reaches the next.
//   * A CTA never leaves, and never takes a new row, while a peer may still read its shared
//     memory: every row begins with a cluster barrier, and the kernel ends with one.
//   * A layout whose vectors do not fit a CTA's shared memory at C = kMaxCluster (dense N past
//     about 9000, factored d past about 15000) is refused: the plan says so and the launch
//     returns cudaErrorInvalidValue.

#include "resident_dsvm_cores.cuh"

#include <mutex>

namespace {

// The launch: the problem, the rows and where their outputs go; the CTAs' layout.
struct DsvmGrid {
  const void* q;     // dense: (n, n); factored: B (n, d); row-major, f32 or bf16
  const float* lab;  // (n,): the labels, zero on padded coordinates
  const float* ts;   // (count,) on the device
  long long n, d;    // d: the row length (n dense)
  int n_true, count, maxit, record, hist_len, exact;
  float big_c, p1, p2, tol;
  float* x_out;  // (count, n)
  float* stats;  // (count, 4)
  float* hist;   // (count, 2 or 5, hist_len)
  int* counter;  // the next row
  int rows_per, held;
};

// The float counts of a CTA's vectors (the kernel's layout, every block 16-byte aligned): the
// labels, x and x_prev, the gradient or Q x (two slots) and v over the kept coordinates (every
// coordinate dense, the CTA's rows factored); dense, Q x's slice (two slots); factored, the
// column partials (two slots), B'x and the row groups' partials (kThreads V).
__host__ __device__ constexpr long long round4(long long k) { return (k + 3) / 4 * 4; }
__host__ __device__ constexpr long long vec_floats(bool factored, long long n, long long d,
                                                   long long rows, int vec) {
  return factored ? 6 * round4(rows) + round4(3 * d) + static_cast<long long>(kThreads) * vec
                  : 6 * round4(n) + round4(2 * rows);
}

template <typename T, int V, int CORE, bool kFactored>
__global__ void __launch_bounds__(kThreads, 1) resident_dsvm_rows_kernel(const DsvmGrid g) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ DsShared sm;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const long long n = g.n, d = g.d, rows_per = g.rows_per;

  // this CTA's rows and where its vectors live
  const long long r0 = rank * rows_per;
  const long long left = n - r0 < 0 ? 0 : n - r0;
  Row c;
  c.rows = static_cast<int>(left < rows_per ? left : rows_per);
  c.held = g.held < c.rows ? g.held : c.rows;
  c.rows_per = g.rows_per;
  c.n = n;
  c.units = d / V;
  c.len = kFactored ? rows_per : n;
  c.off = kFactored ? r0 : 0;
  c.rank = rank;
  c.csize = static_cast<int>(cl.num_blocks());
  c.n_true = g.n_true;
  c.big_c = g.big_c;
  c.p1 = g.p1;
  c.p2 = g.p2;
  c.tol = g.tol;
  c.exact = g.exact;
  c.maxit = g.maxit;
  c.record = g.record;
  c.hist_len = g.hist_len;
  float* f = reinterpret_cast<float*>(dyn);
  const long long len4 = round4(c.len);
  float* lab = f;
  c.lab = lab;
  c.xs = f + len4;
  c.gs = c.xs + 2 * len4;
  c.v = c.gs + 2 * len4;
  f = c.v + len4;
  if constexpr (kFactored) {
    c.colpart = f;
    c.btx = f + 2 * d;
    c.red = f + round4(3 * d);
    c.qslot = nullptr;
  } else {
    c.qslot = f;
    c.colpart = c.btx = c.red = nullptr;
  }
  f = reinterpret_cast<float*>(dyn) + vec_floats(kFactored, n, d, rows_per, V);
  T* q_s = reinterpret_cast<T*>(f);
  const T* q_g = static_cast<const T*>(g.q) + r0 * d;
  c.q_s = q_s;
  c.q_g = q_g;

  // the held rows of Q (or B) and the labels, once for every row this CTA solves
  for (long long k = threadIdx.x; k < c.held * c.units; k += kThreads) {
    if constexpr (V == 1) {
      q_s[k] = q_g[k];
    } else {
      reinterpret_cast<uint4*>(q_s)[k] = __ldg(reinterpret_cast<const uint4*>(q_g) + k);
    }
  }
  for (long long j = threadIdx.x; j < c.len; j += kThreads) {
    lab[j] = c.off + j < n ? g.lab[c.off + j] : 0.f;
  }
  __syncthreads();

  const int hist_rows = CORE == kCoreMp ? 5 : 2;
  int par = 0;
  for (;;) {
    // rank 0 takes the next row; the barrier hands it to the peers (and keeps every CTA from
    // writing this row's slots while a peer still reads the last row's)
    if (rank == 0 && threadIdx.x == 0) sm.row[par] = atomicAdd(g.counter, 1);
    cl.sync();
    if (threadIdx.x == 0) sm.row_now = *cl.map_shared_rank(&sm.row[par], 0);
    __syncthreads();
    const int row = sm.row_now;
    par ^= 1;
    if (row >= g.count) break;

    c.t = g.ts[row];
    c.x_out = g.x_out + static_cast<long long>(row) * n;
    c.stats = g.stats + 4LL * row;
    c.hist = g.hist ? g.hist + static_cast<long long>(hist_rows) * row * g.hist_len : nullptr;
    if constexpr (CORE == kCoreMp) {
      mp_solve<T, V, kFactored>(c, sm);
    } else {
      pd_solve<T, V, kFactored>(c, sm);
    }
  }
  // no CTA leaves while a peer may still read its shared memory
  cl.sync();
}

template <typename T, int V, int CORE>
const void* kernel_of(bool factored) {
  return factored ? reinterpret_cast<const void*>(&resident_dsvm_rows_kernel<T, V, CORE, true>)
                  : reinterpret_cast<const void*>(&resident_dsvm_rows_kernel<T, V, CORE, false>);
}

template <typename T, int V>
const void* kernel_of(int core, bool factored) {
  return core == kCoreMp ? kernel_of<T, V, kCoreMp>(factored)
                         : kernel_of<T, V, kCoreAdapdm>(factored);
}

// The instantiation for (core, storage, vector width of Q's rows, factored), or null.
const void* pick(int core, int q_is_bf16, int vec, bool factored) {
  if (core != kCoreAdapdm && core != kCoreMp) return nullptr;
  if (q_is_bf16) {
    if (vec == 1) return kernel_of<__nv_bfloat16, 1>(core, factored);
    if (vec == 8) return kernel_of<__nv_bfloat16, 8>(core, factored);
  } else {
    if (vec == 1) return kernel_of<float, 1>(core, factored);
    if (vec == 4) return kernel_of<float, 4>(core, factored);
  }
  return nullptr;
}

// The layout of a launch, from the shape and the storage alone (and the device's shared
// memory).
struct DsvmPlan {
  int cluster, rows_per, held, fits;
  long long smem;
};

DsvmPlan dsvm_plan(long long n, long long d, bool factored, int elt, int vec, long long budget) {
  const long long row_bytes = d * elt;
  DsvmPlan p{};
  p.cluster = kMaxCluster;
  for (int c = 1; c <= kMaxCluster; c *= 2) {
    const long long rows = (n + c - 1) / c;
    if (4 * vec_floats(factored, n, d, rows, vec) + rows * row_bytes <= budget) {
      p.cluster = c;
      break;
    }
  }
  const long long rows = (n + p.cluster - 1) / p.cluster;
  const long long vecs = 4 * vec_floats(factored, n, d, rows, vec);
  const long long avail = budget - vecs;
  p.fits = avail >= 0;
  const long long fit = p.fits ? avail / row_bytes : 0;
  p.rows_per = static_cast<int>(rows);
  p.held = static_cast<int>(fit < rows ? fit : rows);
  p.smem = vecs + static_cast<long long>(p.held) * row_bytes;
  return p;
}

// The plan of a launch at this shape, its kernel and the clusters that can be resident at
// once (asked of the occupancy calculator once a (device, core, storage, shape)).
cudaError_t plan_for(int core, int q_is_bf16, int vec, int factored, long long n, long long d,
                     DsvmPlan* plan, const void** kernel_out, int* active) {
  struct Entry {
    int dev, core, bf16, vec, factored;
    long long n, d;
    DsvmPlan plan;
    const void* kernel;
    int active;
  };
  const void* kernel = pick(core, q_is_bf16, vec, factored != 0);
  if (kernel == nullptr) return cudaErrorInvalidValue;
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
      if (e.dev == dev && e.core == core && e.bf16 == q_is_bf16 && e.vec == vec &&
          e.factored == factored && e.n == n && e.d == d) {
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
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const long long budget = optin - static_cast<long long>(attr.sharedSizeBytes);
  const DsvmPlan p = dsvm_plan(n, d, factored != 0, q_is_bf16 ? 2 : 4, vec, budget);
  int clusters = 0;
  if (p.fits) {
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
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
  }
  *plan = p;
  *kernel_out = kernel;
  *active = clusters;
  std::lock_guard<std::mutex> lock(mu);
  if (used < 64) {
    cache[used++] = Entry{dev, core, q_is_bf16, vec, factored, n, d, p, kernel, clusters};
  }
  return cudaSuccess;
}

bool shape_ok(long long n, long long d, int factored, int vec) {
  return n >= 1 && d >= 1 && (factored || d == n) && (vec == 1 || d % vec == 0);
}

}  // namespace

extern "C" {

// The layout a launch at this shape takes, in out[0..6): the cluster size C, the clusters the
// launch runs (the resident ones, at most `rows`), the dynamic shared memory a CTA (bytes),
// the rows of Q (or B) a CTA owns, the rows it holds in shared memory, and whether the
// layout fits (1) or is refused (0: the vectors do not fit a CTA's shared memory). q dense
// (n, n) (d = n) or, factored = 1, B (n, d); core 0 AdaPDM, 1 Malitsky-Pock. Returns the
// cudaError_t.
int adaprox_resident_dsvm_plan(long long n, long long d, int factored, int q_is_bf16, int vec,
                               int core, int rows, long long* out) {
  if (!shape_ok(n, d, factored, vec) || rows < 1 || !out) return cudaErrorInvalidValue;
  DsvmPlan p{};
  const void* kernel = nullptr;
  int active = 0;
  const cudaError_t err = plan_for(core, q_is_bf16, vec, factored, n, d, &p, &kernel, &active);
  if (err != cudaSuccess) return err;
  out[0] = p.cluster;
  out[1] = active < rows ? active : rows;
  out[2] = p.smem;
  out[3] = p.rows_per;
  out[4] = p.held;
  out[5] = p.fits;
  return cudaSuccess;
}

// K6b and K6c, and K6a at count 1: `count` solves of one core, one for each coupling ts[k].
// q dense (n, n) with d = n, or, factored = 1, B (n, d); row-major, f32 (q_is_bf16 = 0) or
// bf16; vec: 1, or 4 (f32) / 8 (bf16) when d is a multiple of it and q is 16-byte aligned.
// lab (n,) and ts (count,) on the device; n_true: the linear term's mask. core 0, AdaPDM: p1 =
// ||labels||, p2 = Theta (gamma0 = 1 / (2 Theta t p1)); stats (count, 4): numit, norm_res,
// gamma, converged; hist (count, 2, hist_len): gamma, norm_res. core 1, Malitsky-Pock: p1 =
// sigma0, exact = 1 for the acceptance test's exact Bregman form; stats (count, 4): numit,
// norm_res, converged, ls_failed; hist (count, 5, hist_len): gamma, sigma, norm_res, trials,
// f. hist_len = maxit rounded up to 128, zero past numit; x_out (count, n). counter: one int
// the caller zeroes for every launch. Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for a refused layout).
int adaprox_resident_dsvm_rows(const void* q, int q_is_bf16, int vec, int factored, long long n,
                               long long d, const float* lab, int n_true, float big_c, int core,
                               int* counter, const float* ts, int count, float p1, float p2,
                               int exact, float tol, int maxit, int record, float* x_out,
                               float* stats, float* hist, void* stream_ptr) {
  if (!shape_ok(n, d, factored, vec) || !lab || !ts || !counter || n_true < 0 || n_true > n ||
      count < 1 || maxit < 0 || !x_out || !stats || (record && maxit > 0 && !hist)) {
    return cudaErrorInvalidValue;
  }
  DsvmPlan p{};
  const void* kernel = nullptr;
  int active = 0;
  cudaError_t err = plan_for(core, q_is_bf16, vec, factored, n, d, &p, &kernel, &active);
  if (err != cudaSuccess) return err;
  if (!p.fits) return cudaErrorInvalidValue;
  const int clusters = active < count ? active : count;
  DsvmGrid g{q, lab, ts, n, d, n_true, count, maxit, record,
             (maxit + 127) / 128 * 128,  // _hist_len(maxit)
             exact != 0, big_c, p1, p2, tol, x_out, stats, record ? hist : nullptr, counter,
             p.rows_per, p.held};
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

const char* adaprox_resident_dsvm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
