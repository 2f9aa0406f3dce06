// K3 for Hopper: the mean logistic loss and its gradient in one call,
//   z = X w + w_b,
//   f = -mean((y - 1) z - softplus(-z)),
//   grad_w = X^T (sigmoid(z) - y) / m,  grad_b = mean(sigmoid(z) - y).
//
// Replaces the Pallas TPU kernel adaprox_tpu/ops/kernels.py::fused_logistic_value_grad
// (body _logistic_kernel). Plain f32 FMAs with f32 accumulation: no tensor cores
// and no TF32 (the adaptive stepsize rules feed on gradient differences). X is
// stored as f32 or bf16; y, w, w_b and the outputs are f32. softplus(-z) is
// log(1 + e^-z) written stably as max(0, -z) + log1p(exp(-|z|)), and sigmoid(z)
// as 1 / (1 + exp(-z)), both with the accurate expf/log1pf (no fast math).
//
// What bounds it on the card: the bytes of X (m * n * itemsize). The arithmetic
// is 4 flops per element of X and two transcendentals per row, far below the
// card's rate.
//
// Design (first, simple version), the one of K1 (csrc/fused_ls.cu):
//   * A persistent grid, one CTA of 1024 threads per SM, walks over blocks of
//     kRows rows (CTA c takes blocks c, c + grid, ...); kRows = 8 / itemsize.
//     For each block:
//       pass 1: every thread takes a strided set of columns and forms its share
//               of the kRows dot products X_r w; the CTA reduces them in a fixed
//               order, and thread r turns z_r = X_r w + w_b into the row's loss
//               term and d_r = sigmoid(z_r) - y_r;
//       pass 2: every thread re-reads the same columns of the same rows (mostly
//               from L2) and adds X_r[j] * d_r into the CTA's own row of the
//               gradient scratch g_part[c, :].
//   * Each CTA writes its partials of the loss sum, of sum d_r and of the
//     gradient; a second kernel sums them over the CTAs in a fixed order and
//     divides by m. No atomics: the same bits on every run.
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

// VEC consecutive f32 values starting at p.
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
__device__ __forceinline__ void load_x(const float* p, float* out) {
  load_f32<VEC>(p, out);
}

template <int VEC>
__device__ __forceinline__ void load_x(const __nv_bfloat16* p, float* out) {
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

// Partials of CTA c: loss_part[c] = sum over its rows of (y - 1) z - softplus(-z),
// d_part[c] = sum of d = sigmoid(z) - y, g_part[c, :] = sum of X_r * d_r.
// VEC elements a thread step; n % VEC == 0 when VEC > 1.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) logistic_partial_kernel(
    const T* __restrict__ xm, const float* __restrict__ y, const float* __restrict__ w,
    const float* __restrict__ wb, int64_t m, int64_t n, float* __restrict__ loss_part,
    float* __restrict__ d_part, float* __restrict__ g_part) {
  constexpr int kRows = rows_per_step<T>();
  __shared__ float warp_sums[kWarps][kRows];
  __shared__ float d_s[kRows];
  __shared__ float loss_s[kRows];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t nv = n / VEC;  // vectors of VEC columns a row
  float* g_row = g_part + static_cast<int64_t>(blockIdx.x) * n;
  const float bias = *wb;
  float loss_acc = 0.f, d_acc = 0.f;  // used by thread 0 only
  bool first = true;
  const int64_t n_blocks = (m + kRows - 1) / kRows;

  for (int64_t blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const int64_t r0 = blk * kRows;
    const int rows = static_cast<int>(m - r0 < kRows ? m - r0 : kRows);
    const T* x_blk = xm + r0 * n;

    // pass 1: this thread's share of the kRows dot products
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int64_t v = tid; v < nv; v += kThreads) {
      const int64_t j = v * VEC;
      float wv[VEC];
      load_f32<VEC>(w + j, wv);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          float xv[VEC];
          load_x<VEC>(x_blk + r * n + j, xv);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[r] = fmaf(xv[k], wv[k], acc[r]);
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
      float d = 0.f, loss = 0.f;
      if (tid < rows) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) s += warp_sums[q][tid];
        const float z = s + bias;
        const float yv = y[r0 + tid];
        const float softplus_neg = fmaxf(0.f, -z) + log1pf(expf(-fabsf(z)));
        loss = (yv - 1.f) * z - softplus_neg;
        d = 1.f / (1.f + expf(-z)) - yv;
      }
      d_s[tid] = d;
      loss_s[tid] = loss;
    }
    __syncthreads();
    float d[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) d[r] = d_s[r];
    if (tid == 0) {
      for (int r = 0; r < rows; ++r) {
        loss_acc += loss_s[r];
        d_acc += d[r];
      }
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
          float xv[VEC];
          load_x<VEC>(x_blk + r * n + j, xv);
#pragma unroll
          for (int k = 0; k < VEC; ++k) g[k] = fmaf(xv[k], d[r], g[k]);
        }
      }
      store_f32<VEC>(g_row + j, g);
    }
    first = false;
    __syncthreads();  // warp_sums, d_s and loss_s are rewritten by the next block
  }
  if (tid == 0) {
    loss_part[blockIdx.x] = loss_acc;
    d_part[blockIdx.x] = d_acc;
  }
}

// grad_w[j] = (sum over c of g_part[c, j]) / m, f = -(sum of loss_part) / m,
// grad_b = (sum of d_part) / m; every sum in the order c = 0, 1, ..., parts - 1.
__global__ void __launch_bounds__(kThreads) logistic_reduce_kernel(
    const float* __restrict__ loss_part, const float* __restrict__ d_part,
    const float* __restrict__ g_part, int parts, int64_t m, int64_t n, float* __restrict__ f_out,
    float* __restrict__ gw, float* __restrict__ gb) {
  const float rows_f = static_cast<float>(m);
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j < n) {
    float s = 0.f;
    for (int c = 0; c < parts; ++c) s += g_part[static_cast<int64_t>(c) * n + j];
    gw[j] = s / rows_f;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float sl = 0.f, sd = 0.f;
    for (int c = 0; c < parts; ++c) {
      sl += loss_part[c];
      sd += d_part[c];
    }
    *f_out = -sl / rows_f;
    *gb = sd / rows_f;
  }
}

template <typename T, int VEC>
void launch_partial(const void* xm, const float* y, const float* w, const float* wb, int64_t m,
                    int64_t n, int grid, float* loss_part, float* d_part, float* g_part,
                    cudaStream_t stream) {
  logistic_partial_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(xm), y, w, wb, m, n, loss_part, d_part, g_part);
}

}  // namespace

extern "C" {

// Rows a CTA takes per block step; the wrapper sizes the grid from it.
int adaprox_fused_logistic_rows_per_step(int x_is_bf16) {
  return x_is_bf16 ? rows_per_step<__nv_bfloat16>() : rows_per_step<float>();
}

// x_is_bf16: 0 for f32 storage of X, 1 for bf16. vec: 1, or 4 (f32) / 8 (bf16)
// when n % vec == 0 and x and w are 16-byte aligned. wb points to the f32 bias
// on the device. grid >= 1 CTAs, at most one per block of rows. loss_part and
// d_part hold grid floats, g_part grid * n floats. Outputs: f (1), gw (n), gb (1).
// Returns the cudaError_t of the launches (0 on success).
int adaprox_fused_logistic(const void* xm, int x_is_bf16, int vec, const float* y,
                           const float* w, const float* wb, long long m, long long n, int grid,
                           float* loss_part, float* d_part, float* g_part, float* f_out,
                           float* gw, float* gb, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rows = adaprox_fused_logistic_rows_per_step(x_is_bf16);
  const long long n_blocks = (m + rows - 1) / rows;
  if (m < 1 || n < 1 || grid < 1 || grid > n_blocks) return cudaErrorInvalidValue;
  if (x_is_bf16) {
    if (vec == 1) {
      launch_partial<__nv_bfloat16, 1>(xm, y, w, wb, m, n, grid, loss_part, d_part, g_part,
                                       stream);
    } else if (vec == 8 && n % 8 == 0) {
      launch_partial<__nv_bfloat16, 8>(xm, y, w, wb, m, n, grid, loss_part, d_part, g_part,
                                       stream);
    } else {
      return cudaErrorInvalidValue;
    }
  } else {
    if (vec == 1) {
      launch_partial<float, 1>(xm, y, w, wb, m, n, grid, loss_part, d_part, g_part, stream);
    } else if (vec == 4 && n % 4 == 0) {
      launch_partial<float, 4>(xm, y, w, wb, m, n, grid, loss_part, d_part, g_part, stream);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned reduce_grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  logistic_reduce_kernel<<<reduce_grid, kThreads, 0, stream>>>(loss_part, d_part, g_part, grid,
                                                                m, n, f_out, gw, gb);
  return cudaGetLastError();
}

const char* adaprox_fused_logistic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
