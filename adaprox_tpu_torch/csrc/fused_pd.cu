// K5 for Hopper: the fused primal update of the primal-dual iteration, one pass
// over A' (the transposed coupling matrix, n rows of m):
//
//     aty  = A' y                          (n,)
//     v    = x - gamma (grad + aty)        (n,)
//     xn   = prox_{gamma g}(v)             (n,)  g separable: l1, box, zero, elastic
//     axn  = A xn = sum_i A'_i xn_i        (m,)  the next iteration's A x
//
// Replaces the Pallas TPU kernel adaprox_tpu/ops/pd_kernels.py::fused_pd_primal_update
// (body _kernel). Plain f32 FMAs with f32 accumulation: no tensor cores and no TF32.
// A' is stored as f32 or bf16; y, x, grad, gamma and the outputs are f32. gamma is
// read through a pointer (the adaptive rule's 0-d output on the card), so the
// caller never reads it back to the host; p1 and p2 are fixed for a solve and come
// by value. Built with -fmad=false: v and the prox round after each operation, as
// the plain version's tensor ops do (the dot products use explicit fmaf).
//
// What bounds it on the card: the bytes of A' (n * m * itemsize). The arithmetic is
// 4 flops per element of A'.
//
// Design (first, simple version), K1's shape of work over the rows of A':
//   * A persistent grid, one CTA of 1024 threads per SM, walks over blocks of kRows
//     rows of A' (CTA c takes blocks c, c + grid, ...); kRows = 8 / itemsize, 2 f32
//     rows or 4 bf16 rows, the same bytes a step. For each block:
//       pass 1: every thread takes a strided set of columns and forms its share of
//               the kRows dot products A'_r y; the CTA reduces them in a fixed order
//               (xor shuffles in a warp, then the warps in order). Thread r then
//               forms v_r and xn_r = prox(v_r) and writes aty_r, v_r, xn_r;
//       pass 2: every thread re-reads the same columns of the same kRows rows (from
//               L2) and adds A'_r[j] * xn_r into the CTA's own row of the (grid, m)
//               partial of A xn.
//   * The TPU kernel summed A xn into one output block across its sequential grid.
//     Here CTAs run in no order, so a second kernel sums the partials in the order
//     c = 0, 1, ..., grid - 1. No atomics: every run gives the same bits, which the
//     adaptive rules need.
//   * m may be ragged (masked); n need not divide into blocks (the last block is
//     short). Vector loads (16 bytes a thread) are used when the wrapper has
//     checked m and the alignment.
//   * The prox keeps jnp's NaN semantics: sign(NaN) = NaN, sign(+-0) = 0, and
//     maximum / clip propagate NaN (CUDA's fmaxf, fminf and copysignf do not).
//
// The drivers' A' is thin (16 rows), so a block of rows a CTA leaves at most 8 CTAs
// busy there: latency-bound. A split over m is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// the prox menu, in the wrapper's order
constexpr int kL1 = 0;
constexpr int kBox = 1;
constexpr int kZero = 2;
constexpr int kElastic = 3;

// Rows of A' a CTA takes per block step: 8 bytes of each column.
template <typename T>
__host__ __device__ constexpr int rows_per_step() { return 8 / static_cast<int>(sizeof(T)); }

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

// jnp.sign: NaN for NaN, 0 for +-0
__device__ __forceinline__ float sign_of(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : (v == 0.f ? 0.f : v));
}

// jnp.maximum(d, lo) and jnp.minimum(d, hi): NaN in d propagates
__device__ __forceinline__ float max_nan(float d, float lo) { return (d != d || d > lo) ? d : lo; }
__device__ __forceinline__ float min_nan(float d, float hi) { return (d != d || d < hi) ? d : hi; }

// pd_kernels._PROX: x_new = prox_{gamma g}(v) with the menu's (p1, p2)
template <int PROX>
__device__ __forceinline__ float prox(float v, float gamma, float p1, float p2) {
  if constexpr (PROX == kZero) {
    return v;
  } else if constexpr (PROX == kBox) {
    return min_nan(max_nan(v, p1), p2);
  } else {
    const float thr = p1 * gamma;
    const float soft = sign_of(v) * max_nan(fabsf(v) - thr, 0.f);
    if constexpr (PROX == kL1) {
      return soft;
    } else {
      return soft / (1.f + gamma * p2);
    }
  }
}

// Partials: aty, v, xn for CTA c's rows, and part[c, :] = sum over CTA c's rows of
// A'_r * xn_r. VEC elements a thread step; m % VEC == 0 when VEC > 1.
template <typename T, int VEC, int PROX>
__global__ void __launch_bounds__(kThreads) pd_partial_kernel(
    const T* __restrict__ at, const float* __restrict__ y, const float* __restrict__ x,
    const float* __restrict__ grad, const float* __restrict__ gamma_ptr, float p1, float p2,
    int64_t n, int64_t m, float* __restrict__ part, float* __restrict__ aty_out,
    float* __restrict__ v_out, float* __restrict__ xn_out) {
  constexpr int kRows = rows_per_step<T>();
  __shared__ float warp_sums[kWarps][kRows];
  __shared__ float xn_s[kRows];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float gamma = *gamma_ptr;
  const int64_t mv = m / VEC;  // vectors of VEC columns a row
  float* p_row = part + static_cast<int64_t>(blockIdx.x) * m;
  bool first = true;
  const int64_t n_blocks = (n + kRows - 1) / kRows;

  for (int64_t blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const int64_t r0 = blk * kRows;
    const int rows = static_cast<int>(n - r0 < kRows ? n - r0 : kRows);
    const T* at_blk = at + r0 * m;

    // pass 1: this thread's share of the kRows dot products A'_r y
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int64_t c = tid; c < mv; c += kThreads) {
      const int64_t j = c * VEC;
      float yv[VEC];
      load_f32<VEC>(y + j, yv);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          float av[VEC];
          load_a<VEC>(at_blk + r * m + j, av);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[r] = fmaf(av[k], yv[k], acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float s = acc[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) warp_sums[warp][r] = s;
    }
    __syncthreads();
    if (tid < kRows) {
      float xn = 0.f;
      if (tid < rows) {
        float aty = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) aty += warp_sums[w][tid];
        const int64_t i = r0 + tid;
        const float v = x[i] - gamma * (grad[i] + aty);
        xn = prox<PROX>(v, gamma, p1, p2);
        aty_out[i] = aty;
        v_out[i] = v;
        xn_out[i] = xn;
      }
      xn_s[tid] = xn;
    }
    __syncthreads();
    float xn[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) xn[r] = xn_s[r];

    // pass 2: the same rows again (from L2), into this CTA's row of the partial
    for (int64_t c = tid; c < mv; c += kThreads) {
      const int64_t j = c * VEC;
      float p[VEC];
      if (first) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) p[k] = 0.f;
      } else {
        load_f32<VEC>(p_row + j, p);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          float av[VEC];
          load_a<VEC>(at_blk + r * m + j, av);
#pragma unroll
          for (int k = 0; k < VEC; ++k) p[k] = fmaf(av[k], xn[r], p[k]);
        }
      }
      store_f32<VEC>(p_row + j, p);
    }
    first = false;
    __syncthreads();  // warp_sums and xn_s are rewritten by the next block
  }
}

// axn[j] = sum over c of part[c, j], in the order c = 0, 1, ..., parts - 1.
__global__ void __launch_bounds__(kThreads) pd_reduce_kernel(
    const float* __restrict__ part, int parts, int64_t m, float* __restrict__ axn) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j < m) {
    float s = 0.f;
    for (int c = 0; c < parts; ++c) s += part[static_cast<int64_t>(c) * m + j];
    axn[j] = s;
  }
}

struct Args {
  const void* at;
  const float* y;
  const float* x;
  const float* grad;
  const float* gamma;
  float p1;
  float p2;
  int64_t n;
  int64_t m;
  int grid;
  float* part;
  float* aty;
  float* v;
  float* xn;
};

template <typename T, int VEC, int PROX>
void launch_partial(const Args& a, cudaStream_t stream) {
  pd_partial_kernel<T, VEC, PROX><<<a.grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.at), a.y, a.x, a.grad, a.gamma, a.p1, a.p2, a.n, a.m, a.part,
      a.aty, a.v, a.xn);
}

template <typename T, int VEC>
int launch_prox(const Args& a, int prox_kind, cudaStream_t stream) {
  switch (prox_kind) {
    case kL1: launch_partial<T, VEC, kL1>(a, stream); return 0;
    case kBox: launch_partial<T, VEC, kBox>(a, stream); return 0;
    case kZero: launch_partial<T, VEC, kZero>(a, stream); return 0;
    case kElastic: launch_partial<T, VEC, kElastic>(a, stream); return 0;
    default: return 1;
  }
}

}  // namespace

extern "C" {

// Rows of A' a CTA takes per block step; the wrapper sizes the grid from it.
int adaprox_fused_pd_rows_per_step(int at_is_bf16) {
  return at_is_bf16 ? rows_per_step<__nv_bfloat16>() : rows_per_step<float>();
}

// at (n, m), f32 (at_is_bf16 0) or bf16 (1). vec: 1, or 4 (f32) / 8 (bf16) when
// m % vec == 0 and at, y are 16-byte aligned. prox_kind: 0 l1, 1 box, 2 zero,
// 3 elastic. gamma points to one f32 on the card. grid >= 1 CTAs, at most one per
// block of rows; part holds grid * m floats. Returns the cudaError_t of the
// launches (0 on success).
int adaprox_fused_pd(const void* at, int at_is_bf16, int vec, int prox_kind, const float* y,
                     const float* x, const float* grad, const float* gamma, float p1, float p2,
                     long long n, long long m, int grid, float* part, float* aty, float* v,
                     float* xn, float* axn, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rows = adaprox_fused_pd_rows_per_step(at_is_bf16);
  const long long n_blocks = (n + rows - 1) / rows;
  if (n < 1 || m < 1 || grid < 1 || grid > n_blocks) return cudaErrorInvalidValue;
  const Args a{at, y, x, grad, gamma, p1, p2, n, m, grid, part, aty, v, xn};
  int bad = 0;
  if (at_is_bf16) {
    if (vec == 1) {
      bad = launch_prox<__nv_bfloat16, 1>(a, prox_kind, stream);
    } else if (vec == 8 && m % 8 == 0) {
      bad = launch_prox<__nv_bfloat16, 8>(a, prox_kind, stream);
    } else {
      bad = 1;
    }
  } else {
    if (vec == 1) {
      bad = launch_prox<float, 1>(a, prox_kind, stream);
    } else if (vec == 4 && m % 4 == 0) {
      bad = launch_prox<float, 4>(a, prox_kind, stream);
    } else {
      bad = 1;
    }
  }
  if (bad) return cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned reduce_grid = static_cast<unsigned>((m + kThreads - 1) / kThreads);
  pd_reduce_kernel<<<reduce_grid, kThreads, 0, stream>>>(part, grid, m, axn);
  return cudaGetLastError();
}

const char* adaprox_fused_pd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
