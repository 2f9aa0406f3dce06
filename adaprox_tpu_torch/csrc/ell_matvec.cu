// K8 for Hopper: the padded-row (ELL) gather matvec, y_i = sum_k vals[i, k] * x[cols[i, k]].
//
// Replaces the Pallas TPU kernel adaprox_tpu/ops/sparse.py::ell_matvec_pallas (body
// _ell_kernel). The JAX package keeps that kernel off the TPU, whose lane gather takes
// single-vreg sources only; on the card a gather from x in L1/L2 is an ordinary load.
// Both directions of ELLOperator are this kernel: A' has its own (vals_t, rows_t), so
// nothing scatters. vals are f32 or bf16, x and y f32, cols int32; plain f32 FMAs with
// f32 accumulation (no tensor cores, no TF32).
//
// What bounds it on the card: the bytes of the entries each row holds, read once. Every
// row is padded to k, the longest row (rounded up to 128), with entries of val 0 and col
// 0; at the sparse case (8192 x 16384, 10% of the (64, 512) tiles) rows hold 0 to 4608
// entries, 1628 on average, so the padded arrays are 2.8x the held ones (302 MB against
// 107 MB for A x). The arithmetic is 2 flops an entry and x stays in L1/L2, so the kernel
// lives or dies by how few bytes of vals and cols it streams, and how well.
//
// Design:
//   * Row i reads entries [0, len_i) of vals and cols and nothing past them; len_i comes
//     from `lengths` (the operator's row extents: one past the last entry that is not
//     (val 0, col 0), rounded up to 4), or is k for every row when `lengths` is null.
//     Lengths are clamped to [0, k].
//   * Where len_i < k the skipped tail held only (val 0, col 0) entries, each of which
//     adds 0 * x[0]: the row adds that term once, fmaf(0, x[0], s) after its sum. A NaN or
//     inf x[0] thus gives NaN in exactly the rows that have padding, as jnp's
//     sum(vals * x[cols]) has it; a finite x[0] leaves the sum as it was (the skipped
//     terms were +-0).
//   * Lanes read VEC-wide (16 bytes of cols and of f32 vals, 8 of bf16), kUnroll loads
//     in flight a lane, with streaming loads so that vals and cols do not push x out of
//     the caches; x is read through the read-only path. A length that is not a multiple
//     of VEC ends with one scalar entry a lane.
//   * A persistent grid: CTA b takes rows b, b + grid, ... (rows of different block rows,
//     so every CTA gets a like share of the bytes), and deals each row's chunks of kChunk =
//     kUnroll * 32 * VEC entries (256 on the vector path) round robin over its warps,
//     continuing the deal from row to row; each warp's partial of a row goes to shared
//     memory, and after one barrier a thread a row sums the kWarps partials in warp order.
//     At the case this read A x (rows of 0 to 4608 entries) 10% faster than a warp a row,
//     whose 64 longest rows were the launch's tail, and A'y (192 to 1280) within 4% of it,
//     both near one stream pass over the same bytes (PERF.md). Deeper unrolling (4, 8) or
//     loads predicated to finish a row in one step did not read faster. The grid (as many
//     CTAs as fit on the card, more where a CTA would take over kMaxRows rows) depends
//     only on the device and m; the occupancy behind it is asked once a device.
//   * Each lane keeps VEC accumulators and sums them in a fixed order, the warp reduces
//     with an xor butterfly: no atomics and no order that depends on scheduling, so two
//     launches give the same bits, which the adaptive rules need (they feed on
//     differences of gradients).
//   * m is a multiple of 8 (the wrapper checks, as the JAX kernel does).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;       // vector loads in flight a lane
constexpr int kMaxRows = 64;     // rows a CTA takes at most
constexpr int kCtasPerSm = 8;    // CTAs an SM at most

template <int VEC>
__device__ __forceinline__ void load_vals(const float* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = __ldcs(p);
  } else {
    static_assert(VEC == 4, "f32 vals are read 1 or 4 at a time");
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
}

template <int VEC>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = __bfloat162float(p[0]);
  } else {
    static_assert(VEC == 4, "bf16 vals are read 1 or 4 at a time");
    const uint2 raw = __ldcs(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 lo = __bfloat1622float2(h[0]);
    const float2 hi = __bfloat1622float2(h[1]);
    out[0] = lo.x;
    out[1] = lo.y;
    out[2] = hi.x;
    out[3] = hi.y;
  }
}

template <int VEC>
__device__ __forceinline__ void load_cols(const int* p, int* out) {
  if constexpr (VEC == 1) {
    out[0] = __ldcs(p);
  } else {
    const int4 c = __ldcs(reinterpret_cast<const int4*>(p));
    out[0] = c.x;
    out[1] = c.y;
    out[2] = c.z;
    out[3] = c.w;
  }
}

// The entries row `row` holds: lengths[row] clamped to [0, k], or k without lengths.
__device__ __forceinline__ int64_t row_length(const int* lengths, int64_t row, int64_t k) {
  if (lengths == nullptr) return k;
  const int64_t len = lengths[row];
  return len < 0 ? 0 : (len > k ? k : len);
}

// Adds this lane's entries of [start, end) of one row to acc, start % VEC == 0: the
// vectors at start + lane * VEC + t * 32 * VEC in increasing t, kUnroll of them loaded
// before their FMAs, then the last end % VEC entries one a lane into acc[0].
template <typename T, int VEC>
__device__ __forceinline__ void add_range(const T* v_row, const int* c_row,
                                          const float* __restrict__ x, int64_t start,
                                          int64_t end, int lane, float* acc) {
  constexpr int kStep = 32 * VEC;
  const int64_t end_v = end - end % VEC;
  int64_t j = start + static_cast<int64_t>(lane) * VEC;
  for (; j + (kUnroll - 1) * kStep < end_v; j += kUnroll * kStep) {
    float v[kUnroll][VEC];
    int c[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load_vals<VEC>(v_row + j + u * kStep, v[u]);
      load_cols<VEC>(c_row + j + u * kStep, c[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = fmaf(v[u][q], __ldg(x + c[u][q]), acc[q]);
    }
  }
  for (; j < end_v; j += kStep) {
    float v[VEC];
    int c[VEC];
    load_vals<VEC>(v_row + j, v);
    load_cols<VEC>(c_row + j, c);
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = fmaf(v[q], __ldg(x + c[q]), acc[q]);
  }
  if constexpr (VEC > 1) {
    const int64_t t = end_v + lane;
    if (t < end) {
      float v;
      int c;
      load_vals<1>(v_row + t, &v);
      load_cols<1>(c_row + t, &c);
      acc[0] = fmaf(v, __ldg(x + c), acc[0]);
    }
  }
}

// The warp's sum of its lanes' accumulators, the same bits in every lane.
template <int VEC>
__device__ __forceinline__ float warp_sum(const float* acc) {
  float s = acc[0];
#pragma unroll
  for (int q = 1; q < VEC; ++q) s += acc[q];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// jnp's padding term: the skipped tail's 0 * x[0], once.
__device__ __forceinline__ float with_padding(float s, int64_t len, int64_t k,
                                              const float* __restrict__ x) {
  return len < k ? fmaf(0.f, __ldg(x), s) : s;
}

// Rows blockIdx.x + r * gridDim.x for r < rows_per_cta, each row's chunks dealt round
// robin over the CTA's warps (the deal continues from row to row).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) ell_kernel(
    const T* __restrict__ vals, const int* __restrict__ cols, const float* __restrict__ x,
    const int* __restrict__ lengths, int64_t m, int64_t k, int rows_per_cta,
    float* __restrict__ y) {
  constexpr int64_t kChunk = kUnroll * 32 * VEC;
  __shared__ float part[kMaxRows][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int64_t dealt = 0;  // chunks dealt to this CTA's warps before this row
  for (int r = 0; r < rows_per_cta; ++r) {
    const int64_t row = blockIdx.x + static_cast<int64_t>(r) * gridDim.x;
    if (row >= m) break;  // the same for the whole CTA
    const int64_t len = row_length(lengths, row, k);
    const int64_t chunks = (len + kChunk - 1) / kChunk;
    const T* v_row = vals + row * k;
    const int* c_row = cols + row * k;
    float acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
    // this warp's first chunk of the row: the c with (dealt + c) % kWarps == warp
    for (int64_t c = (warp - dealt % kWarps + kWarps) % kWarps; c < chunks; c += kWarps) {
      const int64_t start = c * kChunk;
      add_range<T, VEC>(v_row, c_row, x, start, start + kChunk < len ? start + kChunk : len,
                        lane, acc);
    }
    const float s = warp_sum<VEC>(acc);
    if (lane == 0) part[r][warp] = s;
    dealt += chunks;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows_per_cta; r += kThreads) {
    const int64_t row = blockIdx.x + static_cast<int64_t>(r) * gridDim.x;
    if (row >= m) break;
    float s = part[r][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[r][w];
    y[row] = with_padding(s, row_length(lengths, row, k), k, x);
  }
}

constexpr int kMaxDevices = 64;

// CTAs of ell_kernel<T, VEC> the card holds at once (at most kCtasPerSm an SM), asked of
// the runtime on a device's first launch and kept.
template <typename T, int VEC>
cudaError_t resident_ctas(int* ctas) {
  static std::atomic<int> known[kMaxDevices];  // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *ctas = known[dev].load(std::memory_order_relaxed);
  if (*ctas > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ell_kernel<T, VEC>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || sms < 1) return cudaErrorInvalidConfiguration;
  *ctas = (per_sm < kCtasPerSm ? per_sm : kCtasPerSm) * sms;
  known[dev].store(*ctas, std::memory_order_relaxed);
  return cudaSuccess;
}

template <typename T, int VEC>
cudaError_t launch(const void* vals, const int* cols, const float* x, const int* lengths,
                   int64_t m, int64_t k, float* y, cudaStream_t stream) {
  int ctas = 0;
  const cudaError_t err = resident_ctas<T, VEC>(&ctas);
  if (err != cudaSuccess) return err;
  // as many CTAs as fit on the card at once, more where a CTA would take > kMaxRows rows
  int64_t grid = ctas < m ? ctas : m;
  if (grid * kMaxRows < m) grid = (m + kMaxRows - 1) / kMaxRows;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int rows_per_cta = static_cast<int>((m + grid - 1) / grid);
  ell_kernel<T, VEC><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const T*>(vals), cols, x, lengths, m, k, rows_per_cta, y);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// vals (m, k) f32 (vals_is_bf16 0) or bf16 (1), cols (m, k) int32 indices into x, y (m,);
// lengths (m,) int32 (entries row i holds), or null for k every row. vec: 1, or 4 when
// k % 4 == 0 and vals and cols are 16-byte aligned. Returns the cudaError_t of the launch
// (0 on success).
int adaprox_ell_matvec(const void* vals, int vals_is_bf16, int vec, const int* cols,
                       const float* x, const int* lengths, long long m, long long k,
                       float* y, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (m < 1 || k < 1) return cudaErrorInvalidValue;
  if (vec == 4 && k % 4 != 0) return cudaErrorInvalidValue;
  if (vals_is_bf16) {
    if (vec == 4) return launch<__nv_bfloat16, 4>(vals, cols, x, lengths, m, k, y, stream);
    if (vec == 1) return launch<__nv_bfloat16, 1>(vals, cols, x, lengths, m, k, y, stream);
  } else {
    if (vec == 4) return launch<float, 4>(vals, cols, x, lengths, m, k, y, stream);
    if (vec == 1) return launch<float, 1>(vals, cols, x, lengths, m, k, y, stream);
  }
  return cudaErrorInvalidValue;
}

const char* adaprox_ell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
