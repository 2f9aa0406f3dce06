// What the whole-solve kernels of the f = 0 composite family share (the square-root
// lasso and the least absolute deviation: min lam ||x||_1 + h(A x) with h =
// Translate(inner, -bv), inner = NormL2 or NormL1): K7d's Condat-Vu (resident_cv.cu)
// and K7a/K7b's Malitsky-Pock and AdaPDM+ cores (resident_f0_cores.cuh, which keeps its
// own problem struct: it needs two slots of y and A x). A (m x n) and A' (n x m) are both
// kept, row-major, so both products read rows: A x a warp a row of A (n short: one
// 16-byte load a lane at the drivers' n = 128), A'y a CTA a row of A' (n rows of m
// values each: a warp a row would leave all but n warps of the grid idle and walk m
// values in 32-lane steps).
//
// Every function is deterministic: one fixed order of every sum, no atomics.

#pragma once

#include "resident_common.cuh"

namespace {

// h's inner norm (the entries' h_kind): NormL2 (the square-root lasso) or NormL1
// (the least absolute deviation).
enum HKind { kHL2 = 0, kHL1 = 1 };

// The problem and the scratch of a launch. Every vector is f32.
struct F0Problem {
  const void* a;    // (m, n) row-major, f32 or bf16
  const void* at;   // (n, m) row-major: the same values transposed
  const float* bv;  // (m,)
  float* xs;        // (2, n): x by parity (the other slot takes the next x)
  float* v;         // (n,): the pre-prox point
  float* at_y;      // (n,)
  float* y;         // (m,): the dual iterate
  float* ax;        // (m,): A x of the last P1 (the previous one until P1 overwrites it)
  float* w;         // (m,): the dual pre-prox point between P1 and the l2 dual phase
  float* part;      // (parts, grid): per-CTA partial sums
  long long m, n;
  int h_kind;
  float lam;
  int hist_len;     // maxit rounded up to 128 (the JAX kernels' _hist_len)
};

// jnp.sign(v) * jnp.maximum(jnp.abs(v) - thr, 0): soft-thresholding.
__device__ __forceinline__ float soft(float v, float thr) {
  return sign_of(v) * nan_max(fabsf(v) - thr, 0.f);
}

// The sum of v over a warp, in lane 0: a shuffle tree, one fixed order.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// sum_k row[k] * vec[k] over len values by the whole CTA, the result in thread 0:
// threads take V consecutive values a step (len % V == 0 when V > 1), then a
// shuffle tree a warp and the warps' sums in warp order (s_red: kWarps floats). Every
// thread must call it; it ends with a block barrier, so s_red is free again.
template <typename T, int V>
__device__ __forceinline__ float block_dot(const T* __restrict__ row, const float* vec,
                                           long long len, float* s_red) {
  float acc = 0.f;
  const long long steps = len / V;
  for (long long k = threadIdx.x; k < steps; k += kThreads) {
    float av[V], xv[V];
    load_a<V>(row + k * V, av);
    load_f32<V>(vec + k * V, xv);
#pragma unroll
    for (int q = 0; q < V; ++q) acc = fmaf(av[q], xv[q], acc);
  }
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = acc;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kWarps; ++k) total += s_red[k];
  }
  __syncthreads();
  return total;
}

// h's dual prox at one coordinate (_f0_ops.prox_hconj), Moreau's identity through
// Translate: z = w / sigma - bv, y = w - sigma (p + bv) with p the inner norm's prox
// at z with threshold 1 / sigma: elementwise soft for NormL1, z times the block scale
// (from ||z|| over all m coordinates: l2_scale) for NormL2.
__device__ __forceinline__ float dual_z(float w, float sigma, float b) { return w / sigma - b; }
__device__ __forceinline__ float dual_y(float w, float sigma, float b, float p) {
  return w - sigma * (p + b);
}
// NormL2's block scale: max(0, 1 - (1 / sigma) / ||z||) where ||z|| > 0, else 0.
__device__ __forceinline__ float l2_scale(float z2, float sigma) {
  const float nz = sqrtf(z2);
  return nz > 0.f ? nan_max(0.f, 1.f - (1.f / sigma) / nz) : 0.f;
}

// pick_<kernel>: the instantiation for (storage, vector width of both layouts' rows),
// or null for a combination that does not exist.
#define ADAPROX_PICK_F0(KERNEL)                                                           \
  const void* pick_##KERNEL(int a_is_bf16, int vec) {                                    \
    if (a_is_bf16) {                                                                      \
      if (vec == 1) return reinterpret_cast<const void*>(&KERNEL<__nv_bfloat16, 1>);      \
      if (vec == 8) return reinterpret_cast<const void*>(&KERNEL<__nv_bfloat16, 8>);      \
    } else {                                                                              \
      if (vec == 1) return reinterpret_cast<const void*>(&KERNEL<float, 1>);              \
      if (vec == 4) return reinterpret_cast<const void*>(&KERNEL<float, 4>);              \
    }                                                                                     \
    return nullptr;                                                                       \
  }

// Launch kernel cooperatively over a grid sized from the longer of A's two row
// counts: enough warps for max(m, n) rows, at most one CTA per SM; part holds
// `parts` partials a CTA. Returns the cudaError_t (cudaErrorNotSupported: no
// cooperative launch here).
cudaError_t launch_f0(const void* kernel, void** args, long long m, long long n, int parts,
                      long long part_len, void* stream_ptr) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long rows = m > n ? m : n;
  const long long want = (rows + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(want < sms ? want : sms);
  if (static_cast<long long>(parts) * grid > part_len) return cudaErrorInvalidValue;
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
