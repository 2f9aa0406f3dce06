// K1 for Hopper: f = 0.5 * ||A x - b||^2 and grad = A^T (A x - b).
//
// Replaces the Pallas TPU kernel adaprox_tpu/ops/kernels.py::fused_ls_value_grad (body
// _ls_kernel), which keeps a tile of rows in VMEM for both products and sums into one output
// block across its sequential grid. Plain f32 FMAs (explicit fmaf, in one fixed order) with
// f32 accumulation: no tensor cores and no TF32 (a reduced-precision matvec poisons the
// adaptive stepsize rules' curvature recurrences). A is stored as f32 or bf16; x, b and the
// outputs are f32.
//
// What bounds it on the card: the bytes of A (m * n * itemsize). The arithmetic is 4 flops an
// element of A, far below the card's rate, so the kernel lives by reading A once from device
// memory, with enough bytes in flight, and by keeping everything else on chip.
//
// Design (the plan, with its numbers, is ops/kernels.py::k1_plan, which the wrapper passes in):
//   * Layout. A row's columns come in vectors of 16 bytes (4 f32, 8 bf16); which thread holds
//     which element follows from (n, dtype) alone. Rows whose start is 16-byte aligned are
//     read with 16-byte loads (or copies), the others element by element, with the same
//     arithmetic, so the bits do not depend on the alignment either.
//   * Partial slots. The rows are cut into slots of rows_per_slot consecutive rows, from the
//     shape alone (about as many slots as a 132-SM card runs CTAs at once, 16 rows a slot at
//     least for the rows kernel, 8 for the ring kernel). A slot's f and gradient partial are
//     summed on chip and written once. CTAs (or clusters) take slots blockIdx, blockIdx +
//     grid, ...: a slot's bits do not depend on the grid.
//   * Narrow rows (n <= 1024), ls_rows_kernel: a warp owns a row, which it holds in registers
//     (at most 32 values a lane) between the dot and the gradient update; two rows in flight
//     a warp, eight warps a CTA, several CTAs an SM. The dot is summed by xor shuffles (no
//     barrier); x is in shared memory; each warp keeps its own gradient partial in registers
//     for the whole slot, and at the slot's end the eight are summed in warp order through
//     shared memory. Every thread has work at n = 1024.
//   * Wide rows (n > 1024), ls_ring_kernel: a CTA takes one row at a time from a ring of
//     `stages` rows in shared memory fed by bulk copies (TMA, mbarrier completion,
//     bulk_copy.cuh); both products read the staged row. Each thread holds 16 columns of x
//     and of the gradient partial in registers (so a CTA of 1024 threads covers 16384
//     columns); one block barrier a row (the warps' dots in a double-buffered slot, summed by
//     every warp in the same order); after the barrier of row q, thread 0 refills the slot
//     of row q - 1, which every thread has then read.
//     Rows wider than one CTA's 16384 columns are cut into column slices over a thread-block
//     cluster of C <= 8 CTAs (C from the shape alone); the slices' dots are summed in rank
//     order through distributed shared memory after one cluster barrier a row.
//   * The sum over slots, ls_reduce_kernel: a CTA per 32 columns, 32 warps each summing
//     every 32nd slot in order, then the warps in order. It is launched as a
//     programmatic dependent launch, so its launch overlaps the first kernel's tail; it waits
//     (griddepcontrol.wait) for the first kernel's writes before it reads them.
//   * No atomics anywhere: the same bits on every run, which the adaptive rule needs because
//     it feeds on gradient differences.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "bulk_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRowWarps = 8;  // warps of a rows-kernel CTA
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kRingCols = 16;  // columns of x and of the gradient a ring-kernel thread holds
constexpr int kMaxThreads = 1024;
constexpr int kMaxStages = 8;
constexpr int kMaxCluster = 8;
constexpr int kReduceCols = 32;
constexpr int kReduceGroups = 32;

// The launch: the inputs, the plan and the partials.
struct LsArgs {
  const void* a;  // (m, n) row-major, f32 or bf16
  const float* b;
  const float* x;
  long long m, n, rows_per_slot;
  int slots, cluster, slice_vec, stages, stride;
  float* f_part;  // (slots,): the sum of res^2 over each slot's rows
  float* g_part;  // (slots, n): the sum of A_r res_r over each slot's rows
};

template <typename T>
__host__ __device__ constexpr int lanes16() { return 16 / static_cast<int>(sizeof(T)); }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The 16 bytes at p (16-byte aligned) as floats.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 v = __bfloat1622float2(h[q]);
    out[2 * q] = v.x;
    out[2 * q + 1] = v.y;
  }
}

// Vector v of a row (V = 16 / sizeof(T) elements from column v * V) as floats, 0 past column
// `cols`: one 16-byte load (kVec: the row is 16-byte aligned and holds whole vectors), or
// element loads.
template <typename T, int kVec>
__device__ __forceinline__ void load_vec(const T* row, long long v, long long cols, float* out) {
  constexpr int V = lanes16<T>();
  const long long j = v * V;
  if constexpr (kVec) {
    load16(row + j, out);
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) out[u] = j + u < cols ? to_f32(row[j + u]) : 0.f;
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;  // the same bits in every lane: each step adds the same two values
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Rows [r0, r1) of slot s.
__device__ __forceinline__ void slot_rows(const LsArgs& p, long long s, long long* r0,
                                          long long* r1) {
  *r0 = s * p.rows_per_slot;
  const long long end = *r0 + p.rows_per_slot;
  *r1 = end < p.m ? end : p.m;
}

// Narrow rows: a warp a row, K values of it a lane (K / V vectors: lane + 32 q).
template <typename T, int kVec, int K>
__global__ void __launch_bounds__(kRowThreads, 2) ls_rows_kernel(const LsArgs p) {
  constexpr int V = lanes16<T>();
  constexpr int VPT = K / V;
  static_assert(VPT >= 1 && VPT * V == K, "K holds whole vectors");
  __shared__ __align__(16) float xs[32 * K];  // x, 0 past n
  __shared__ __align__(16) float gw[kRowWarps][32 * K];  // the warps' gradient partials
  __shared__ float fw_s[kRowWarps];
  const T* a = static_cast<const T*>(p.a);
  const long long n = p.n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int j = tid; j < 32 * K; j += kRowThreads) xs[j] = j < n ? p.x[j] : 0.f;
  launch_dependents();
  __syncthreads();

  for (long long s = blockIdx.x; s < p.slots; s += gridDim.x) {
    long long r0, r1;
    slot_rows(p, s, &r0, &r1);
    float g[K];
#pragma unroll
    for (int i = 0; i < K; ++i) g[i] = 0.f;
    float fw = 0.f;
    // rows r and r + kRowWarps together, in this order
    for (long long r = r0 + warp; r < r1; r += 2 * kRowWarps) {
      const long long rb = r + kRowWarps;
      const bool has_b = rb < r1;
      const float b_a = p.b[r];
      const float b_b = has_b ? p.b[rb] : 0.f;
      float va[K], vb[K];
#pragma unroll
      for (int q = 0; q < VPT; ++q) {
        const long long v = lane + 32 * q;
        if (v * V < n) {
          load_vec<T, kVec>(a + r * n, v, n, va + q * V);
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u) va[q * V + u] = 0.f;
        }
        if (has_b && v * V < n) {
          load_vec<T, kVec>(a + rb * n, v, n, vb + q * V);
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u) vb[q * V + u] = 0.f;
        }
      }
      float da = 0.f, db = 0.f;
#pragma unroll
      for (int q = 0; q < VPT; ++q) {
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const float xv = xs[(lane + 32 * q) * V + u];
          da = fmaf(va[q * V + u], xv, da);
          db = fmaf(vb[q * V + u], xv, db);
        }
      }
      da = warp_sum(da);
      db = warp_sum(db);
      const float res_a = da - b_a;
      fw = fmaf(res_a, res_a, fw);
#pragma unroll
      for (int i = 0; i < K; ++i) g[i] = fmaf(va[i], res_a, g[i]);
      if (has_b) {
        const float res_b = db - b_b;
        fw = fmaf(res_b, res_b, fw);
#pragma unroll
        for (int i = 0; i < K; ++i) g[i] = fmaf(vb[i], res_b, g[i]);
      }
    }
    // the slot's partial: the warps' in warp order
#pragma unroll
    for (int q = 0; q < VPT; ++q) {
      float* dst = &gw[warp][(lane + 32 * q) * V];
#pragma unroll
      for (int u = 0; u < V; u += 4) {
        *reinterpret_cast<float4*>(dst + u) =
            make_float4(g[q * V + u], g[q * V + u + 1], g[q * V + u + 2], g[q * V + u + 3]);
      }
    }
    if (lane == 0) fw_s[warp] = fw;
    __syncthreads();
    for (long long j = tid; j < n; j += kRowThreads) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kRowWarps; ++w) t += gw[w][j];
      p.g_part[s * n + j] = t;
    }
    if (tid == 0) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kRowWarps; ++w) t += fw_s[w];
      p.f_part[s] = t;
    }
    __syncthreads();  // gw and fw_s are rewritten by the next slot
  }
}

// Thread 0's cursor over the rows a ring-kernel CTA copies in: the rows of its slots in order
// (`total` of them, `issued` so far), the next one row `pr` of the slot starting at `row0`,
// into ring slot `pst`. Kept in shared memory: no other thread needs registers for it.
struct Producer {
  long long total, issued, row0, pr;
  int pst;
};

// Starts the copy of the cursor's row (`cols` elements from column c0, widened to whole
// 16-byte units) into its ring slot, and moves the cursor on.
template <typename SrcOf>
__device__ __forceinline__ void issue_next(Producer& c, const LsArgs& p, SrcOf src_of, int cols,
                                           int elem_bytes, unsigned char* ring, uint64_t* full) {
  const uintptr_t src = src_of(c.row0 + c.pr);
  const uintptr_t lo = src & ~static_cast<uintptr_t>(15);
  const uintptr_t hi = (src + static_cast<uintptr_t>(cols) * elem_bytes + 15) &
                       ~static_cast<uintptr_t>(15);
  bulk_load(ring + static_cast<long long>(c.pst) * p.stride, reinterpret_cast<const void*>(lo),
            static_cast<uint32_t>(hi - lo), &full[c.pst]);
  ++c.issued;
  c.pst = c.pst + 1 == p.stages ? 0 : c.pst + 1;
  if (++c.pr == p.rows_per_slot) {
    c.pr = 0;
    c.row0 += static_cast<long long>(gridDim.x / p.cluster) * p.rows_per_slot;
  }
}

// Wide rows: a CTA (rank `rank` of a cluster of p.cluster) takes its column slice of one row
// at a time from the ring; thread t holds vectors t + blockDim q (q < kRingCols / V) of it.
template <typename T, int kVec>
__global__ void __launch_bounds__(kMaxThreads, 1) ls_ring_kernel(const LsArgs p) {
  constexpr int V = lanes16<T>();
  constexpr int VPT = kRingCols / V;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];  // a slot's copy has landed
  __shared__ float red[2][32];  // the warps' dots, by row parity
  __shared__ float dot_s[2];    // this CTA's dot, by row parity, read by the cluster's peers
  __shared__ Producer prod;     // thread 0's alone
  const T* a = static_cast<const T*>(p.a);
  const long long n = p.n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int csize = p.cluster;
  const int rank = csize > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int cid = blockIdx.x / csize, ncl = gridDim.x / csize;
  // (n is at most kMaxCluster * 16384 here, so column counts are ints)
  const int nvec = static_cast<int>((n + V - 1) / V);
  const int v0 = rank * p.slice_vec;
  int nvs = nvec - v0;  // vectors in this CTA's slice
  if (nvs > p.slice_vec) nvs = p.slice_vec;
  if (nvs < 0) nvs = 0;
  const int c0 = v0 * V;  // the slice's first column
  int cols = static_cast<int>(n) - c0;  // its columns
  if (cols > nvs * V) cols = nvs * V;
  if (cols < 0) cols = 0;
  const int stages = p.stages;

  float xr[kRingCols], g[kRingCols];
#pragma unroll
  for (int q = 0; q < VPT; ++q) {
    const int v = tid + nthreads * q;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int j = v * V + u;
      xr[q * V + u] = v < nvs && j < cols ? p.x[c0 + j] : 0.f;
      g[q * V + u] = 0.f;
    }
  }
  auto src_of = [&](long long row) {
    return reinterpret_cast<uintptr_t>(a + row * n + c0);
  };
  if (tid == 0) {
    // the rows of this CTA's slots, in order; every slot but the last has rows_per_slot
    prod.total = 0;
    for (int s = cid; s < p.slots; s += ncl) {
      long long r0, r1;
      slot_rows(p, s, &r0, &r1);
      prod.total += r1 - r0;
    }
    prod.issued = 0;
    prod.row0 = static_cast<long long>(cid) * p.rows_per_slot;
    prod.pr = 0;
    prod.pst = 0;
    for (int st = 0; st < stages; ++st) bulk_init(&full[st]);
    bulk_init_fence();
    while (prod.issued < stages && prod.issued < prod.total) {
      issue_next(prod, p, src_of, cols, static_cast<int>(sizeof(T)), ring, full);
    }
  }
  launch_dependents();
  __syncthreads();

  float f_acc = 0.f;  // thread 0 of rank 0
  int cst = 0;          // the ring slot of the next row to read
  uint32_t cphase = 0;  // the phase of its copy (its uses so far, mod 2)
  int parity = 0;       // the row's half of red and dot_s
  for (int s = cid; s < p.slots; s += ncl) {
    long long r0, r1;
    slot_rows(p, s, &r0, &r1);
    // (m is below 2^31 here: m * n elements of A fit the card, n > 1024)
    for (int row = static_cast<int>(r0); row < static_cast<int>(r1); ++row, parity ^= 1) {
      const float b_row = p.b[row];
      const T* rs = reinterpret_cast<const T*>(ring + cst * p.stride +
                                               (kVec ? 0 : src_of(row) & 15));
      bulk_wait(&full[cst], cphase);
      float d = 0.f;
#pragma unroll
      for (int qv = 0; qv < VPT; ++qv) {
        const int v = tid + nthreads * qv;
        float av[V];
        if (v < nvs) {
          load_vec<T, kVec>(rs, v, cols, av);
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u) av[u] = 0.f;
        }
#pragma unroll
        for (int u = 0; u < V; ++u) d = fmaf(av[u], xr[qv * V + u], d);
      }
      d = warp_sum(d);
      if (lane == 0) red[parity][warp] = d;
      __syncthreads();  // also ends every read of the previous row's slot: refill it
      if (tid == 0 && prod.issued < prod.total && (row > r0 || s != cid)) {
        bulk_reuse_fence();
        issue_next(prod, p, src_of, cols, static_cast<int>(sizeof(T)), ring, full);
      }
      float dot = warp_sum(lane < nwarps ? red[parity][lane] : 0.f);
      if (csize > 1) {
        cg::cluster_group cl = cg::this_cluster();
        if (tid == 0) dot_s[parity] = dot;
        cl.sync();
        dot = 0.f;
        for (int k = 0; k < csize; ++k) dot += *cl.map_shared_rank(&dot_s[parity], k);
      }
      const float res = dot - b_row;
      if (tid == 0) f_acc = fmaf(res, res, f_acc);
#pragma unroll
      for (int qv = 0; qv < VPT; ++qv) {
        const int v = tid + nthreads * qv;
        if (v < nvs) {
          float av[V];
          load_vec<T, kVec>(rs, v, cols, av);
#pragma unroll
          for (int u = 0; u < V; ++u) g[qv * V + u] = fmaf(av[u], res, g[qv * V + u]);
        }
      }
      if (++cst == stages) {
        cst = 0;
        cphase ^= 1u;
      }
    }
    // the slot's partial, this CTA's columns of it
#pragma unroll
    for (int qv = 0; qv < VPT; ++qv) {
      const int v = tid + nthreads * qv;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int j = v * V + u;
        if (v < nvs && j < cols) p.g_part[s * n + c0 + j] = g[qv * V + u];
        g[qv * V + u] = 0.f;
      }
    }
    if (tid == 0 && rank == 0) p.f_part[s] = f_acc;
    f_acc = 0.f;
  }
  if (csize > 1) cg::this_cluster().sync();  // no CTA leaves while a peer may read dot_s
}

// grad[j] = the sum over slots of g_part[s, j]; f = 0.5 * the sum of f_part. Both in a fixed
// order: warp k sums slots k, k + 32, ... in turn, then the warps in order; f by one warp,
// lane l summing slots l, l + 32, ..., then an xor tree.
__global__ void __launch_bounds__(kReduceCols* kReduceGroups) ls_reduce_kernel(
    const float* __restrict__ f_part, const float* __restrict__ g_part, int slots, long long n,
    float* __restrict__ f_out, float* __restrict__ grad) {
  __shared__ float part[kReduceGroups][kReduceCols];
  wait_for_primary();
  const int c = threadIdx.x % kReduceCols;
  const int grp = threadIdx.x / kReduceCols;
  const long long j = static_cast<long long>(blockIdx.x) * kReduceCols + c;
  float t = 0.f;
  if (j < n) {
#pragma unroll 8
    for (int s = grp; s < slots; s += kReduceGroups) t += g_part[static_cast<long long>(s) * n + j];
  }
  part[grp][c] = t;
  __syncthreads();
  if (grp == 0 && j < n) {
    float u = 0.f;
#pragma unroll
    for (int k = 0; k < kReduceGroups; ++k) u += part[k][c];
    grad[j] = u;
  }
  if (blockIdx.x == 0 && grp == 1) {
    float u = 0.f;
    for (int s = c; s < slots; s += 32) u += f_part[s];
    u = warp_sum(u);
    if (c == 0) *f_out = 0.5f * u;
  }
}

// The kernel a plan names, or nullptr.
const void* pick(int regime, int a_is_bf16, int vec, int k) {
  if (regime == 0) {
    if (a_is_bf16) {
      if (k == 8) return vec ? (const void*)ls_rows_kernel<__nv_bfloat16, 1, 8>
                             : (const void*)ls_rows_kernel<__nv_bfloat16, 0, 8>;
      if (k == 16) return vec ? (const void*)ls_rows_kernel<__nv_bfloat16, 1, 16>
                              : (const void*)ls_rows_kernel<__nv_bfloat16, 0, 16>;
      if (k == 32) return vec ? (const void*)ls_rows_kernel<__nv_bfloat16, 1, 32>
                              : (const void*)ls_rows_kernel<__nv_bfloat16, 0, 32>;
    } else {
      if (k == 8) return vec ? (const void*)ls_rows_kernel<float, 1, 8>
                             : (const void*)ls_rows_kernel<float, 0, 8>;
      if (k == 16) return vec ? (const void*)ls_rows_kernel<float, 1, 16>
                              : (const void*)ls_rows_kernel<float, 0, 16>;
      if (k == 32) return vec ? (const void*)ls_rows_kernel<float, 1, 32>
                              : (const void*)ls_rows_kernel<float, 0, 32>;
    }
    return nullptr;
  }
  if (regime == 1 && k == kRingCols) {
    if (a_is_bf16) {
      return vec ? (const void*)ls_ring_kernel<__nv_bfloat16, 1>
                 : (const void*)ls_ring_kernel<__nv_bfloat16, 0>;
    }
    return vec ? (const void*)ls_ring_kernel<float, 1> : (const void*)ls_ring_kernel<float, 0>;
  }
  return nullptr;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current device; asks the
// runtime only the first time a kernel needs more on a device than it was allowed before.
cudaError_t allow_smem(const void* kernel, long long smem) {
  struct Entry {
    const void* kernel;
    int dev;
    long long smem;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (cache[i].kernel == kernel && cache[i].dev == dev && cache[i].smem >= smem) {
      return cudaSuccess;
    }
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && used < 64) cache[used++] = Entry{kernel, dev, smem};
  return err;
}

}  // namespace

extern "C" {

// plan: the 11 numbers of ops/kernels.py::k1_plan, in the order regime (0 rows, 1 ring), k,
// threads, grid, cluster, slice_vec, stages, stride, smem, rows_per_slot, slots. a_is_bf16: 0
// for f32 storage, 1 for bf16. vec: 1 when n is a multiple of 16 / itemsize and a is 16-byte
// aligned (16-byte loads and copies), else 0 (the same arithmetic, element loads). f_part
// holds `slots` floats, g_part slots * n. Returns the cudaError_t of the launches (0 on
// success).
int adaprox_fused_ls(const void* a, int a_is_bf16, int vec, const float* b, const float* x,
                     long long m, long long n, const long long* plan, float* f_part,
                     float* g_part, float* f_out, float* grad, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!plan || m < 1 || n < 1 || (vec != 0 && vec != 1)) return cudaErrorInvalidValue;
  const int regime = static_cast<int>(plan[0]), k = static_cast<int>(plan[1]);
  const int threads = static_cast<int>(plan[2]), grid = static_cast<int>(plan[3]);
  const int cluster = static_cast<int>(plan[4]);
  const long long rows_per_slot = plan[9], slots = plan[10];
  const int lanes = a_is_bf16 ? 8 : 4;
  const long long nvec = (n + lanes - 1) / lanes;
  if (vec && n % lanes != 0) return cudaErrorInvalidValue;
  if (rows_per_slot < 1 || slots != (m + rows_per_slot - 1) / rows_per_slot ||
      slots > 0x7fffffffLL || grid < 1 || cluster < 1 || cluster > kMaxCluster ||
      grid % cluster != 0 || grid / cluster > slots) {
    return cudaErrorInvalidValue;
  }
  const void* kernel = pick(regime, a_is_bf16, vec, k);
  if (!kernel) return cudaErrorInvalidValue;
  LsArgs args{a, b, x, m, n, rows_per_slot, static_cast<int>(slots), cluster,
              static_cast<int>(plan[5]), static_cast<int>(plan[6]), static_cast<int>(plan[7]),
              f_part, g_part};
  void* kargs[] = {&args};
  cudaError_t err;
  if (regime == 0) {
    if (threads != kRowThreads || cluster != 1 || 32LL * k < n) return cudaErrorInvalidValue;
    err = cudaLaunchKernel(kernel, dim3(grid), dim3(threads), kargs, 0, stream);
  } else {
    const long long smem = plan[8];
    if (m > 0x7fffffffLL || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
        args.stages < 2 ||
        args.stages > kMaxStages || args.slice_vec < 1 ||
        static_cast<long long>(threads) * (kRingCols / lanes) < args.slice_vec ||
        static_cast<long long>(args.slice_vec) * cluster < nvec ||
        args.stride < 16LL * args.slice_vec + 16 || args.stride % 16 != 0 ||
        smem < static_cast<long long>(args.stages) * args.stride || smem > 0x7fffffffLL) {
      return cudaErrorInvalidValue;
    }
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg{};
    cudaLaunchAttribute la[1];
    la[0].id = cudaLaunchAttributeClusterDimension;
    la[0].val.clusterDim.x = cluster;
    la[0].val.clusterDim.y = 1;
    la[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = stream;
    cfg.attrs = la;
    cfg.numAttrs = cluster > 1 ? 1 : 0;
    err = cudaLaunchKernelExC(&cfg, kernel, kargs);
  }
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  la[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3(static_cast<unsigned>((n + kReduceCols - 1) / kReduceCols));
  cfg.blockDim = dim3(kReduceCols * kReduceGroups);
  cfg.stream = stream;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  const int parts = static_cast<int>(slots);
  err = cudaLaunchKernelEx(&cfg, ls_reduce_kernel, static_cast<const float*>(f_part),
                           static_cast<const float*>(g_part), parts, n, f_out, grad);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

const char* adaprox_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
