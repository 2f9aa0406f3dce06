// What the dual SVM's cooperative whole-solve kernel, K6d (resident_pd.cu), is built on. Q
// is the N x N Gram (dense) or, factored, Q = B B' with B (N x d) = D_y X; Q x is formed a
// warp a row, from x (dense) or from B'x (factored), which phase F forms as per-CTA partials
// and every CTA reduces into its shared memory. The launch sizes the grid from N. (K6a, K6b
// and K6c run on thread-block clusters: resident_dsvm_grid.cu.)
//
// Every function is deterministic: one fixed order of every sum, no atomics.

#pragma once

#include "resident_common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ float as_f32(T v);
template <>
__device__ __forceinline__ float as_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float as_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Threads take columns c of d: when d < kThreads, kThreads / d groups of d threads
// split a range and their sums are added in group order (one fixed order).
__device__ __forceinline__ int col_groups(long long d) {
  return d >= kThreads ? 1 : kThreads / static_cast<int>(d);
}

// F: this CTA's partials of B'x over its slice of rows, part_bx[cta * d + c]
// (consecutive columns in consecutive words: coalesced stores and loads).
template <typename T>
__device__ void phase_btx(const void* q, long long n, long long d, const float* x,
                          float* part_bx, float* s_red) {
  const T* __restrict__ b = static_cast<const T*>(q);
  const long long slice = (n + gridDim.x - 1) / gridDim.x;
  const long long r0 = blockIdx.x * slice;
  const long long r1 = r0 + slice < n ? r0 + slice : n;
  const int groups = col_groups(d);
  const int width = groups == 1 ? kThreads : static_cast<int>(d);
  const int g = threadIdx.x / width;
  if (g < groups) {
    for (long long c = threadIdx.x % width; c < d; c += width) {
      float acc = 0.f;
      for (long long r = r0 + g; r < r1; r += groups) {
        acc = fmaf(as_f32(__ldg(b + r * d + c)), x[r], acc);
      }
      if (groups == 1) {
        part_bx[blockIdx.x * d + c] = acc;
      } else {
        s_red[g * width + c] = acc;
      }
    }
  }
  if (groups > 1) {
    __syncthreads();
    if (threadIdx.x < d) {
      float s = 0.f;
      for (int k = 0; k < groups; ++k) s += s_red[k * width + threadIdx.x];
      part_bx[blockIdx.x * d + threadIdx.x] = s;
    }
  }
}

// B'x into s_btx (d floats of shared memory): every CTA reduces all the grid's
// partials, every thread at work, in one fixed order, so every CTA holds the
// same bits. Thread (g, c) sums the CTAs g, g + groups, ... of column c; then
// the group sums are added in group order.
__device__ void reduce_btx(long long d, const float* part_bx, float* s_btx, float* s_red) {
  const int groups = col_groups(d);
  const int width = groups == 1 ? kThreads : static_cast<int>(d);
  const int g = threadIdx.x / width;
  if (g < groups) {
    for (long long c = threadIdx.x % width; c < d; c += width) {
      float acc = 0.f;
#pragma unroll 4
      for (int k = g; k < static_cast<int>(gridDim.x); k += groups) acc += part_bx[k * d + c];
      if (groups == 1) {
        s_btx[c] = acc;
      } else {
        s_red[g * width + c] = acc;
      }
    }
  }
  if (groups > 1) {
    __syncthreads();
    if (threadIdx.x < d) {
      float s = 0.f;
      for (int k = 0; k < groups; ++k) s += s_red[k * width + threadIdx.x];
      s_btx[threadIdx.x] = s;
    }
  }
  __syncthreads();
}

// (Q x)_i in lane 0: dense, Q_i . x (Q symmetric); factored, B_i . (B'x) with B'x
// in shared memory (reduce_btx).
template <typename T, int V>
__device__ __forceinline__ float row_dot(const void* q, long long i, long long n, long long d,
                                         bool factored, const float* x, const float* s_btx,
                                         int lane) {
  const T* __restrict__ qt = static_cast<const T*>(q);
  return factored ? warp_dot<T, V>(qt + i * d, s_btx, d, lane)
                  : warp_dot<T, V>(qt + i * n, x, n, lane);
}

// pick_<kernel>: the instantiation for (storage, row vector width), or null for a
// combination that does not exist.
#define ADAPROX_PICK_DSVM(KERNEL)                                                         \
  const void* pick_##KERNEL(int q_is_bf16, int vec) {                                    \
    if (q_is_bf16) {                                                                      \
      if (vec == 1) return reinterpret_cast<const void*>(&KERNEL<__nv_bfloat16, 1>);      \
      if (vec == 8) return reinterpret_cast<const void*>(&KERNEL<__nv_bfloat16, 8>);      \
    } else {                                                                              \
      if (vec == 1) return reinterpret_cast<const void*>(&KERNEL<float, 1>);              \
      if (vec == 4) return reinterpret_cast<const void*>(&KERNEL<float, 4>);              \
    }                                                                                     \
    return nullptr;                                                                       \
  }

// Launch kernel cooperatively over a grid sized from n: enough warps for the rows,
// at most one CTA per SM; the factored B'x lives in d floats of dynamic shared
// memory; part holds `parts` partials a CTA, plus d when factored. Returns the
// cudaError_t (cudaErrorNotSupported: no cooperative launch here).
cudaError_t launch_dsvm(const void* kernel, void** args, long long n, long long d, bool factored,
                        int parts, long long part_len, void* stream_ptr) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t smem = factored ? static_cast<size_t>(d) * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long want = (n + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(want < sms ? want : sms);
  if ((parts + (factored ? d : 0)) * grid > part_len) return cudaErrorInvalidValue;
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
