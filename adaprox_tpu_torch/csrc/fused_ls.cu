// K1 for Hopper: f = 0.5 * ||A x - b||^2 and grad = A^T (A x - b).
//
// Replaces the Pallas TPU kernel adaprox_tpu/ops/kernels.py::fused_ls_value_grad
// (body _ls_kernel). Plain f32 FMAs with f32 accumulation: no tensor cores and
// no TF32 (a reduced-precision matvec poisons the adaptive stepsize rules'
// curvature recurrences). A is stored as f32 or bf16; x, b and the outputs are
// f32.
//
// What bounds it on the card: the bytes of A (m * n * itemsize). The arithmetic
// is 4 flops per element of A, far below the card's rate, so the kernel lives or
// dies by how often it reads A from device memory and how many bytes it keeps
// in flight.
//
// Design (first, simple version):
//   * A persistent grid, one CTA of 1024 threads per SM, walks over blocks of
//     kRows rows (CTA c takes blocks c, c + grid, ...); kRows = 8 / itemsize,
//     2 f32 rows or 4 bf16 rows, the same bytes a step. For each block:
//       pass 1: every thread takes a strided set of columns, forms its share of
//               the kRows dot products A_r x, and the CTA reduces them in a fixed
//               order into res_r = A_r x - b_r;
//       pass 2: every thread re-reads the same columns of the same kRows rows
//               and adds A_r[j] * res_r into the CTA's own row of the gradient
//               scratch g_part[c, :].
//     Pass 2 re-reads rows that pass 1 just touched. With one CTA per SM the
//     rows in flight (132 SMs * 8 * n bytes, 17 MB at n = 16384) stay in the
//     50 MB L2, so the re-read is mostly served from L2. This is not strictly
//     one pass from device memory; a ring of rows in shared memory fed by TMA
//     is later work. (Measured on an H100 at m = n = 16384: 256-thread CTAs,
//     more CTAs per SM, or more rows a step all ran slower.)
//   * The TPU kernel summed into one output block across a sequential grid.
//     Here CTAs run in no order, so each CTA writes its own f and gradient
//     partials and a second kernel sums them in a fixed order. No atomics: the
//     result is the same bits on every run, which the adaptive rule needs
//     because it feeds on gradient differences.
//   * Ragged edges are masked: any m >= 1 and n >= 1. Vector loads (16 bytes a
//     thread) are used when the wrapper has checked n and the alignment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// Rows a CTA takes per block step: 8 bytes of each column.
template <typename T>
__host__ __device__ constexpr int rows_per_step() { return 8 / static_cast<int>(sizeof(T)); }

// VEC consecutive elements starting at p, as floats.
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = p[0];
  } else {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + k);
      out[k] = v.x;
      out[k + 1] = v.y;
      out[k + 2] = v.z;
      out[k + 3] = v.w;
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float* in) {
  if constexpr (VEC == 1) {
    p[0] = in[0];
  } else {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      *reinterpret_cast<float4*>(p + k) = make_float4(in[k], in[k + 1], in[k + 2], in[k + 3]);
    }
  }
}

template <int VEC>
__device__ __forceinline__ void load_a(const float* p, float* out) {
  load_f32<VEC>(p, out);
}

template <int VEC>
__device__ __forceinline__ void load_a(const __nv_bfloat16* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = __bfloat162float(p[0]);
  } else {
    static_assert(VEC % 8 == 0, "bf16 vector loads take 8 values (16 bytes)");
#pragma unroll
    for (int k = 0; k < VEC; k += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + k);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v = __bfloat1622float2(h[q]);
        out[k + 2 * q] = v.x;
        out[k + 2 * q + 1] = v.y;
      }
    }
  }
}

// Partials: f_part[c] = 0.5 * sum of res^2 over CTA c's rows,
// g_part[c, :] = sum over CTA c's rows of A_r * res_r.
// VEC elements a thread step; n % VEC == 0 when VEC > 1.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) ls_partial_kernel(
    const T* __restrict__ a, const float* __restrict__ b, const float* __restrict__ x,
    int64_t m, int64_t n, float* __restrict__ f_part, float* __restrict__ g_part) {
  constexpr int kRows = rows_per_step<T>();
  __shared__ float warp_sums[kWarps][kRows];
  __shared__ float res_s[kRows];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t nv = n / VEC;  // vectors of VEC columns a row
  float* g_row = g_part + static_cast<int64_t>(blockIdx.x) * n;
  float f_acc = 0.f;  // used by thread 0 only
  bool first = true;
  const int64_t n_blocks = (m + kRows - 1) / kRows;

  for (int64_t blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const int64_t r0 = blk * kRows;
    const int rows = static_cast<int>(m - r0 < kRows ? m - r0 : kRows);
    const T* a_blk = a + r0 * n;

    // pass 1: this thread's share of the kRows dot products
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int64_t v = tid; v < nv; v += kThreads) {
      const int64_t j = v * VEC;
      float xv[VEC];
      load_f32<VEC>(x + j, xv);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          float av[VEC];
          load_a<VEC>(a_blk + r * n + j, av);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[r] = fmaf(av[k], xv[k], acc[r]);
        }
      }
    }
    // fixed-order reduction: xor shuffles in the warp, then warps in order
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float s = acc[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) warp_sums[warp][r] = s;
    }
    __syncthreads();
    if (tid < kRows) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += warp_sums[w][tid];
      res_s[tid] = tid < rows ? s - b[r0 + tid] : 0.f;
    }
    __syncthreads();
    float res[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) res[r] = res_s[r];
    if (tid == 0) {
      for (int r = 0; r < rows; ++r) f_acc = fmaf(res[r], res[r], f_acc);
    }

    // pass 2: the same rows again (from L2), into this CTA's gradient row
    for (int64_t v = tid; v < nv; v += kThreads) {
      const int64_t j = v * VEC;
      float g[VEC];
      if (first) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) g[k] = 0.f;
      } else {
        load_f32<VEC>(g_row + j, g);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          float av[VEC];
          load_a<VEC>(a_blk + r * n + j, av);
#pragma unroll
          for (int k = 0; k < VEC; ++k) g[k] = fmaf(av[k], res[r], g[k]);
        }
      }
      store_f32<VEC>(g_row + j, g);
    }
    first = false;
    __syncthreads();  // warp_sums and res_s are rewritten by the next block
  }
  if (tid == 0) f_part[blockIdx.x] = 0.5f * f_acc;
}

// grad[j] = sum over c of g_part[c, j]; f = sum over c of f_part[c]; both in
// the order c = 0, 1, ..., parts - 1.
__global__ void __launch_bounds__(kThreads) ls_reduce_kernel(
    const float* __restrict__ f_part, const float* __restrict__ g_part, int parts, int64_t n,
    float* __restrict__ f_out, float* __restrict__ grad) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j < n) {
    float s = 0.f;
    for (int c = 0; c < parts; ++c) s += g_part[static_cast<int64_t>(c) * n + j];
    grad[j] = s;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float s = 0.f;
    for (int c = 0; c < parts; ++c) s += f_part[c];
    *f_out = s;
  }
}

template <typename T, int VEC>
void launch_partial(const void* a, const float* b, const float* x, int64_t m, int64_t n,
                    int grid, float* f_part, float* g_part, cudaStream_t stream) {
  ls_partial_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), b, x, m, n, f_part, g_part);
}

}  // namespace

extern "C" {

// Rows a CTA takes per block step; the wrapper sizes the grid from it.
int adaprox_fused_ls_rows_per_step(int a_is_bf16) {
  return a_is_bf16 ? rows_per_step<__nv_bfloat16>() : rows_per_step<float>();
}

// a_is_bf16: 0 for f32 storage, 1 for bf16. vec: 1, or 4 (f32) / 8 (bf16) when
// n % vec == 0 and a and x are 16-byte aligned. grid >= 1 CTAs, at most one
// per block of rows. f_part holds grid floats, g_part grid * n floats.
// Returns the cudaError_t of the launches (0 on success).
int adaprox_fused_ls(const void* a, int a_is_bf16, int vec, const float* b, const float* x,
                     long long m, long long n, int grid, float* f_part, float* g_part,
                     float* f_out, float* grad, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rows = adaprox_fused_ls_rows_per_step(a_is_bf16);
  const long long n_blocks = (m + rows - 1) / rows;
  if (m < 1 || n < 1 || grid < 1 || grid > n_blocks) return cudaErrorInvalidValue;
  if (a_is_bf16) {
    if (vec == 1) {
      launch_partial<__nv_bfloat16, 1>(a, b, x, m, n, grid, f_part, g_part, stream);
    } else if (vec == 8 && n % 8 == 0) {
      launch_partial<__nv_bfloat16, 8>(a, b, x, m, n, grid, f_part, g_part, stream);
    } else {
      return cudaErrorInvalidValue;
    }
  } else {
    if (vec == 1) {
      launch_partial<float, 1>(a, b, x, m, n, grid, f_part, g_part, stream);
    } else if (vec == 4 && n % 4 == 0) {
      launch_partial<float, 4>(a, b, x, m, n, grid, f_part, g_part, stream);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned reduce_grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  ls_reduce_kernel<<<reduce_grid, kThreads, 0, stream>>>(f_part, g_part, grid, n, f_out, grad);
  return cudaGetLastError();
}

const char* adaprox_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
