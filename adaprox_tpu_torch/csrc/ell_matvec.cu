// K8 for Hopper: the padded-row (ELL) gather matvec, y_i = sum_k vals[i, k] * x[cols[i, k]].
//
// Replaces the Pallas TPU kernel adaprox_tpu/ops/sparse.py::ell_matvec_pallas (body
// _ell_kernel). The JAX package keeps that kernel off the TPU, whose lane gather takes
// single-vreg sources only; on the card a gather from x in L1/L2 is an ordinary load.
// Both directions of ELLOperator are this kernel: A' has its own (vals_t, rows_t), so
// nothing scatters. vals are f32 or bf16, x and y f32, cols int32; plain f32 FMAs with
// f32 accumulation (no tensor cores, no TF32).
//
// What bounds it on the card: the bytes of vals and cols, m * k * (itemsize + 4), read
// once. The arithmetic is 2 flops an entry, and x (at most a few hundred KB at the
// slice's sizes) stays in L1/L2, so the kernel lives or dies by how well it streams
// vals and cols from device memory.
//
// Design (first, simple version):
//   * A warp a row. The lanes stride over k in VEC-wide loads (16 bytes of cols, 16
//     bytes of f32 vals or 8 of bf16 vals), with streaming loads so that vals and cols
//     do not push x out of the caches; x is read through the read-only path.
//   * Each lane keeps VEC accumulators (one a vector slot) and sums them in a fixed
//     order, then the warp reduces with an xor butterfly. No atomics and no order that
//     depends on scheduling: two launches give the same bits, which the adaptive rules
//     need (they feed on differences of gradients).
//   * Padding entries (val 0, col 0) are not skipped: they add 0 * x[0], which is NaN
//     where x[0] is not finite, as jnp's sum(vals * x[cols]) has it.
//   * m is a multiple of 8 (the wrapper checks, as the JAX kernel does); a block of
//     kThreads threads takes kWarps rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// y[row] for the warp's row; k % VEC == 0 and the rows VEC-aligned when VEC > 1.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) ell_kernel(
    const T* __restrict__ vals, const int* __restrict__ cols, const float* __restrict__ x,
    int64_t m, int64_t k, float* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= m) return;  // the whole warp leaves together
  const T* v_row = vals + row * k;
  const int* c_row = cols + row * k;
  float acc[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
#pragma unroll 4
  for (int64_t j = static_cast<int64_t>(lane) * VEC; j < k; j += 32 * VEC) {
    float v[VEC];
    int c[VEC];
    load_vals<VEC>(v_row + j, v);
    load_cols<VEC>(c_row + j, c);
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = fmaf(v[q], __ldg(x + c[q]), acc[q]);
  }
  float s = acc[0];
#pragma unroll
  for (int q = 1; q < VEC; ++q) s += acc[q];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) y[row] = s;
}

template <typename T, int VEC>
void launch(const void* vals, const int* cols, const float* x, int64_t m, int64_t k, float* y,
            cudaStream_t stream) {
  const int64_t blocks = (m + kWarps - 1) / kWarps;
  ell_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(vals), cols, x, m, k, y);
}

}  // namespace

extern "C" {

// vals (m, k) f32 (vals_is_bf16 0) or bf16 (1), cols (m, k) int32 indices into x, y (m,).
// vec: 1, or 4 when k % 4 == 0 and vals and cols are 16-byte aligned. Returns the
// cudaError_t of the launch (0 on success).
int adaprox_ell_matvec(const void* vals, int vals_is_bf16, int vec, const int* cols,
                       const float* x, long long m, long long k, float* y, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (m < 1 || k < 1 || (m + kWarps - 1) / kWarps > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (vec == 4 && k % 4 != 0) return cudaErrorInvalidValue;
  if (vals_is_bf16) {
    if (vec == 4) {
      launch<__nv_bfloat16, 4>(vals, cols, x, m, k, y, stream);
    } else if (vec == 1) {
      launch<__nv_bfloat16, 1>(vals, cols, x, m, k, y, stream);
    } else {
      return cudaErrorInvalidValue;
    }
  } else {
    if (vec == 4) {
      launch<float, 4>(vals, cols, x, m, k, y, stream);
    } else if (vec == 1) {
      launch<float, 1>(vals, cols, x, m, k, y, stream);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* adaprox_ell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
