// K10a, K10b and K10c for Hopper: the stream probes, which measure how fast the
// card moves bytes between device memory and the SMs. Each does `repeats`
// passes over an (m, n) array A (f32 or bf16, contiguous) inside one launch.
//
// Replaces the Pallas TPU kernels of adaprox_tpu/ops/kernels.py:
//   K10a hbm_read_reduce (body _stream_kernel): repeats * scale * sum(A), a
//        read and a reduction, the read-stream probe (bench's stream ceiling);
//   K10b hbm_copy (body _copy_kernel): out = A * scale, `repeats` times, with
//        scale cast to A's type first: the read+write probe;
//   K10c hbm_dma_read (body _dma_read_kernel): a `depth`-deep pipeline of
//        asynchronous copies of (chunk_rows, n) chunks into fast memory, whose
//        only compute is summing row 0, columns 0:128, of each chunk into a
//        128-wide token that starts at scale.
//
// What bounds them on the card: the bytes. Each pass reads A once (and K10b
// writes it once): repeats * m * n * itemsize bytes at 3.35 TB/s (twice that
// for K10b). At 16384^2 f32 (1 GiB) no pass fits the 50 MB L2, so every pass
// comes from device memory.
//
// Design (first, simple version):
//   * K10a and K10b: a persistent grid-stride loop over 16-byte vectors (4 f32
//     or 8 bf16) with 8 loads in flight a thread, a few CTAs an SM. The loads
//     are volatile streaming loads (ld.global.cs), so nvcc can neither merge
//     nor hoist the same addresses across the passes; K10b's stores likewise
//     (st.global.cs). K10a sums each pass in f32 a thread, carries the pass
//     totals in f64, reduces a CTA's threads in one fixed order into a
//     partial, and a one-warp kernel sums the partials in CTA order and
//     multiplies by scale. No atomics: two launches give the same bits.
//   * K10c: the TPU kernel's async copies become Hopper's bulk copies (TMA,
//     cp.async.bulk global -> shared, completion counted in bytes on an
//     mbarrier; the helpers in bulk_copy.cuh, which K9b's ring shares). A (chunk_rows, n) chunk (8 MiB at 128 x 16384 f32) is far
//     larger than shared memory, so each chunk is cut into pieces of a power
//     of two bytes, the largest with `depth` of them in shared memory. A
//     pass's pieces are dealt to the CTAs (one an SM) round robin, the same
//     deal every pass, so a CTA rereads only its own pieces, a whole pass
//     later. (Dealt over all passes at once, the pieces a CTA reads shift from
//     pass to pass; the CTAs drift apart over 200 passes, and a CTA a pass
//     ahead then reads from the L2 what a CTA a pass behind has just fetched:
//     on an H100 at 1 GiB the probe read up to 3380 GB/s, past the 3350 GB/s
//     of the card's data sheet.) Each CTA keeps `depth` copies in flight (at most its own
//     piece count), waits for a piece, adds the token row if the piece starts
//     a chunk, and reuses the slot for the copy `depth` pieces on. Every copy a CTA starts it also
//     waits for, so none is in flight at exit. The per-CTA tokens are summed in
//     CTA order by a one-CTA kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kThreads = 512;    // K10a, K10b
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;       // 16-byte loads in flight a thread
constexpr int kMaxPerSm = 4;     // CTAs an SM for K10a, K10b
constexpr int kDmaThreads = 128; // K10c: one thread a token column
constexpr int kToken = 128;
constexpr int kSmemBytes = 226 * 1024;  // K10c's shared memory: the ring and its barriers
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void st_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ float ld_one(const float* p) {
  float v;
  asm volatile("ld.global.cs.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float ld_one(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.cs.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return __bfloat162float(__ushort_as_bfloat16(v));
}

__device__ __forceinline__ void st_one(float* p, float v) {
  asm volatile("st.global.cs.f32 [%0], %1;" ::"l"(p), "f"(v) : "memory");
}

__device__ __forceinline__ void st_one(__nv_bfloat16* p, __nv_bfloat16 v) {
  asm volatile("st.global.cs.u16 [%0], %1;" ::"l"(p), "h"(__bfloat16_as_ushort(v)) : "memory");
}

// The sum of a vector's values, in order.
__device__ __forceinline__ float vec_sum(uint4 v, float) {
  return ((__uint_as_float(v.x) + __uint_as_float(v.y)) + __uint_as_float(v.z)) +
         __uint_as_float(v.w);
}

__device__ __forceinline__ float vec_sum(uint4 v, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    s += f.x;
    s += f.y;
  }
  return s;
}

// Each value times s, in A's type (bf16: the f32 product of two bf16 values is
// exact, so rounding it once is the bf16 product).
__device__ __forceinline__ uint4 vec_scale(uint4 v, float s) {
  return make_uint4(__float_as_uint(__uint_as_float(v.x) * s),
                    __float_as_uint(__uint_as_float(v.y) * s),
                    __float_as_uint(__uint_as_float(v.z) * s),
                    __float_as_uint(__uint_as_float(v.w) * s));
}

__device__ __forceinline__ uint4 vec_scale(uint4 v, __nv_bfloat16 s) {
  const float sf = __bfloat162float(s);
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    h[q] = __floats2bfloat162_rn(f.x * sf, f.y * sf);
  }
  return v;
}

// K10a: this CTA's partial of sum(A) over the passes.
template <typename T>
__global__ void __launch_bounds__(kThreads) read_reduce_kernel(const T* a, long long numel,
                                                               int repeats, double* part) {
  constexpr int kVec = 16 / sizeof(T);
  const uint4* av = reinterpret_cast<const uint4*>(a);
  const long long nvec = numel / kVec;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  double total = 0.0;
  for (int r = 0; r < repeats; ++r) {
    float acc = 0.f;
    long long i = tid;
    for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = ld_stream(av + i + u * stride);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc += vec_sum(v[u], T{});
    }
    for (; i < nvec; i += stride) acc += vec_sum(ld_stream(av + i), T{});
    for (long long j = nvec * kVec + tid; j < numel; j += stride) acc += ld_one(a + j);
    total += acc;
  }
  // the CTA's threads in one fixed order: a shuffle tree a warp, then warp order
  __shared__ double warp_sum[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) total += __shfl_down_sync(kFull, total, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sum[w];
    part[blockIdx.x] = s;
  }
}

// K10a's last step, one warp: scale times the partials summed in CTA order.
__global__ void read_reduce_finish(const double* part, int count, float scale, float* out) {
  double t = 0.0;
  for (int c = threadIdx.x; c < count; c += 32) t += part[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(kFull, t, off);
  if (threadIdx.x == 0) out[0] = static_cast<float>(t) * scale;
}

// K10b: out = A * s, `repeats` times.
template <typename T>
__global__ void __launch_bounds__(kThreads) copy_kernel(const T* a, T* out, long long numel,
                                                        T s, int repeats) {
  constexpr int kVec = 16 / sizeof(T);
  const uint4* av = reinterpret_cast<const uint4*>(a);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const long long nvec = numel / kVec;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (int r = 0; r < repeats; ++r) {
    long long i = tid;
    for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = ld_stream(av + i + u * stride);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) st_stream(ov + i + u * stride, vec_scale(v[u], s));
    }
    for (; i < nvec; i += stride) st_stream(ov + i, vec_scale(ld_stream(av + i), s));
    for (long long j = nvec * kVec + tid; j < numel; j += stride) {
      if constexpr (sizeof(T) == 4) {
        st_one(out + j, ld_one(a + j) * s);
      } else {
        st_one(out + j, __float2bfloat16_rn(ld_one(a + j) * __bfloat162float(s)));
      }
    }
  }
}

// K10c: the pieces of a pass (chunks * pieces), dealt to the CTAs round robin,
// the same deal in each of `repeats` passes; this CTA's token columns into
// part (grid, 128).
template <typename T>
__global__ void __launch_bounds__(kDmaThreads, 1) dma_read_kernel(
    const unsigned char* a, long long chunks, long long chunk_bytes, long long piece,
    long long pieces, int repeats, int depth, float* part) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + ((8 * depth + 127) / 128) * 128;
  const long long grid = gridDim.x;
  // this CTA's pieces of a pass are blockIdx.x + j * grid for j < per_pass; its
  // item t is piece t % per_pass of pass t / per_pass
  const long long per_pass = (chunks * pieces - blockIdx.x + grid - 1) / grid;
  const long long mine = per_pass * repeats;
  const int d = static_cast<int>(mine < depth ? mine : depth);
  auto piece_of = [&](long long t) { return blockIdx.x + (t % per_pass) * grid; };

  auto start = [&](long long t, int slot) {
    const long long k = piece_of(t);
    const long long q = k % pieces;
    const long long chunk = k / pieces;
    const long long off = q * piece;
    const uint32_t bytes =
        static_cast<uint32_t>(chunk_bytes - off < piece ? chunk_bytes - off : piece);
    bulk_load(ring + slot * piece, a + chunk * chunk_bytes + off, bytes, bars + slot);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < d; ++s) bulk_init(bars + s);
    bulk_init_fence();
    for (int s = 0; s < d; ++s) start(s, s);
  }
  __syncthreads();

  float acc = 0.f;
  for (long long t = 0; t < mine; ++t) {
    const int slot = static_cast<int>(t % d);
    const uint32_t parity = static_cast<uint32_t>((t / d) & 1);
    bulk_wait(bars + slot, parity);
    // the piece that starts a chunk holds row 0, columns 0:128
    if (piece_of(t) % pieces == 0) {
      const T* row = reinterpret_cast<const T*>(ring + slot * piece);
      if constexpr (sizeof(T) == 4) {
        acc += row[threadIdx.x];
      } else {
        acc += __bfloat162float(row[threadIdx.x]);
      }
    }
    __syncthreads();  // every thread is done with the slot
    if (threadIdx.x == 0 && t + d < mine) {
      // order this CTA's reads of the slot before the copy that overwrites it
      bulk_reuse_fence();
      start(t + d, slot);
    }
  }
  part[blockIdx.x * kToken + threadIdx.x] = acc;
}

// K10c's last step, one CTA of 128 threads: column l is scale plus the CTAs'
// column l in CTA order; thread 0 sums the columns in order.
__global__ void dma_read_finish(const float* part, int count, float scale, float* out) {
  __shared__ float col[kToken];
  float t = scale;
  for (int c = 0; c < count; ++c) t += part[c * kToken + threadIdx.x];
  col[threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int l = 0; l < kToken; ++l) s += col[l];
    out[0] = s;
  }
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// The grid of K10a and K10b: up to kMaxPerSm CTAs an SM, no more than the
// vectors need.
cudaError_t stream_grid(const void* kernel, long long numel, int vec, int* grid) {
  int sms = 0, per_sm = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long per = per_sm < kMaxPerSm ? per_sm : kMaxPerSm;
  const long long want = (numel / vec + kThreads - 1) / kThreads;
  const long long g = want < per * sms ? want : per * sms;
  *grid = static_cast<int>(g < 1 ? 1 : g);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The most CTAs any probe launches: part buffers of this many entries (K10c:
// times 128) always suffice.
int adaprox_hbm_max_grid() {
  int sms = 0;
  return sm_count(&sms) == cudaSuccess ? kMaxPerSm * sms : -1;
}

// K10a: out[0] = scale * (repeats passes of sum(a)), a (numel) contiguous,
// 16-byte aligned, f32 (is_bf16 = 0) or bf16; part: part_len f64 partials.
// Returns the cudaError_t of the launches (0 on success).
int adaprox_hbm_read_reduce(const void* a, int is_bf16, long long numel, int repeats,
                            float scale, double* part, long long part_len, float* out,
                            void* stream_ptr) {
  if (numel < 1 || repeats < 1 || reinterpret_cast<uintptr_t>(a) % 16) {
    return cudaErrorInvalidValue;
  }
  const void* kernel = is_bf16 ? reinterpret_cast<const void*>(&read_reduce_kernel<__nv_bfloat16>)
                               : reinterpret_cast<const void*>(&read_reduce_kernel<float>);
  int grid = 0;
  cudaError_t err = stream_grid(kernel, numel, is_bf16 ? 8 : 4, &grid);
  if (err != cudaSuccess) return err;
  if (grid > part_len) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_bf16) {
    read_reduce_kernel<<<grid, kThreads, 0, stream>>>(static_cast<const __nv_bfloat16*>(a),
                                                      numel, repeats, part);
  } else {
    read_reduce_kernel<<<grid, kThreads, 0, stream>>>(static_cast<const float*>(a), numel,
                                                      repeats, part);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  read_reduce_finish<<<1, 32, 0, stream>>>(part, grid, scale, out);
  return cudaGetLastError();
}

// K10b: out = a * scale (scale cast to a's type), `repeats` times; a and out
// (numel) contiguous, 16-byte aligned, f32 or bf16.
int adaprox_hbm_copy(const void* a, void* out, int is_bf16, long long numel, int repeats,
                     float scale, void* stream_ptr) {
  if (numel < 1 || repeats < 1 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return cudaErrorInvalidValue;
  }
  const void* kernel = is_bf16 ? reinterpret_cast<const void*>(&copy_kernel<__nv_bfloat16>)
                               : reinterpret_cast<const void*>(&copy_kernel<float>);
  int grid = 0;
  cudaError_t err = stream_grid(kernel, numel, is_bf16 ? 8 : 4, &grid);
  if (err != cudaSuccess) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_bf16) {
    copy_kernel<<<grid, kThreads, 0, stream>>>(static_cast<const __nv_bfloat16*>(a),
                                               static_cast<__nv_bfloat16*>(out), numel,
                                               __float2bfloat16_rn(scale), repeats);
  } else {
    copy_kernel<<<grid, kThreads, 0, stream>>>(static_cast<const float*>(a),
                                               static_cast<float*>(out), numel, scale, repeats);
  }
  return cudaGetLastError();
}

// The piece size K10c cuts a chunk into: the largest power of two with `depth`
// pieces and their barriers in shared memory, at most the chunk; 0 when even
// one token row (128 values) would not fit.
long long adaprox_hbm_dma_piece(long long chunk_bytes, int depth, int itemsize) {
  if (depth < 1 || chunk_bytes < 1) return 0;
  const long long room = (kSmemBytes - ((8LL * depth + 127) / 128) * 128) / depth;
  long long piece = 1;
  while (piece * 2 <= room) piece *= 2;
  if (piece > chunk_bytes) piece = chunk_bytes;
  return piece >= kToken * itemsize ? piece : 0;
}

// K10c: `repeats` passes over a (chunks * chunk_bytes bytes, 16-byte aligned,
// chunk_bytes a multiple of 16, rows of at least 128 values) in pieces of
// adaprox_hbm_dma_piece bytes, `depth` copies in flight a CTA (the caller has
// clamped depth to chunks * repeats); out[0] = the token's sum. part: part_len
// >= 128 * grid floats.
int adaprox_hbm_dma_read(const void* a, int is_bf16, long long chunks, long long chunk_bytes,
                         int depth, int repeats, float scale, float* part, long long part_len,
                         float* out, void* stream_ptr) {
  const int itemsize = is_bf16 ? 2 : 4;
  const long long piece = adaprox_hbm_dma_piece(chunk_bytes, depth, itemsize);
  if (piece == 0 || chunks < 1 || repeats < 1 || chunk_bytes % 16 ||
      reinterpret_cast<uintptr_t>(a) % 16) {
    return cudaErrorInvalidValue;
  }
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long pieces = (chunk_bytes + piece - 1) / piece;
  const long long per_pass = pieces * chunks;
  const int grid = static_cast<int>(per_pass < sms ? per_pass : sms);
  if (static_cast<long long>(grid) * kToken > part_len) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(((8LL * depth + 127) / 128) * 128 + depth * piece);
  const void* kernel = is_bf16 ? reinterpret_cast<const void*>(&dma_read_kernel<__nv_bfloat16>)
                               : reinterpret_cast<const void*>(&dma_read_kernel<float>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned char* bytes = static_cast<const unsigned char*>(a);
  if (is_bf16) {
    dma_read_kernel<__nv_bfloat16><<<grid, kDmaThreads, smem, stream>>>(
        bytes, chunks, chunk_bytes, piece, pieces, repeats, depth, part);
  } else {
    dma_read_kernel<float><<<grid, kDmaThreads, smem, stream>>>(
        bytes, chunks, chunk_bytes, piece, pieces, repeats, depth, part);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dma_read_finish<<<1, kToken, 0, stream>>>(part, grid, scale, out);
  return cudaGetLastError();
}

const char* adaprox_hbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
