// K9a and K9b for Hopper: the block-sparse (BCSR) matvec y = A x over the stored (bm, bn)
// tiles of A: vals (nnzb, bm, bn) block-row-major, cols (nnzb,) the tiles' block columns,
// rowptr (nbr + 1,) the block rows' extents (K9a) or rows (nnzb,) the tiles' block rows
// (K9b); x (nbc * bn,), y (nbr * bm,).
//
// Replaces the Pallas TPU kernels adaprox_tpu/ops/bcsr.py::bcsr_matvec (K9a, body
// _kernel: a (block row, step) grid whose scalar-prefetched index maps pick each tile)
// and bcsr_matvec_slab (K9b, body _slab_kernel: a sequential grid over contiguous slabs
// of tiles accumulating into one resident y). vals are f32 or bf16, x and y f32; plain
// f32 FMAs with f32 accumulation (no tensor cores, no TF32).
//
// What bounds them on the card: the bytes of the stored tiles, nnzb * bm * bn * itemsize,
// read once. The arithmetic is 2 flops an element, and x's blocks stay in L1/L2. So both
// live or die by how well they stream vals from device memory.
//
// Design (first, simple versions). One device routine, tile_row_dot, forms the dot of one
// row of one tile with its x block: a warp, lane l taking the VEC-vectors l, l + 32, ...,
// VEC accumulators summed in a fixed order, then an xor butterfly over the lanes.
//   * K9a: a warp an output row. The CTA of (block row i, group of kWarps rows) loops
//     over exactly rowptr[i] .. rowptr[i + 1] - 1, in that order, adding each tile's
//     row dot to the row's sum (the TPU kernel re-read a clamped last tile on masked
//     steps; here nothing is read twice). An empty block row writes zeros.
//   * K9b: blocks run in no order on the card, so nothing is carried between them. Pass
//     1: a CTA a contiguous slab of `slab` tiles writes each tile's (bm,) row dots into
//     a partial; pass 2: a CTA a block row sums its tiles' partials in tile order. The
//     tiles of a block row are contiguous because rows is block-row-major (binary
//     search for the run). The JAX wrapper pads the tile count to a slab multiple with
//     zero tiles at block row 0, column block 0; here those tiles are not stored but
//     computed as 0 * x[0 : bn] and added to block row 0 after its own tiles, as the TPU
//     kernel adds them: NaN where that x block is not finite, else +0.
//   * Both sum each row as 0 + d_0 + d_1 + ... in tile order from the same routine, so
//     K9b equals K9a bit for bit on finite input. No atomics anywhere: two launches give
//     the same bits, which the adaptive rules need.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // K9a: a CTA of kWarps rows
constexpr int kWarps = kThreads / 32;
constexpr int kSlabThreads = 1024;  // K9b pass 1: a CTA a slab
constexpr int kSlabWarps = kSlabThreads / 32;
constexpr int kReduceThreads = 128;  // K9b pass 2: a CTA a block row

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
__device__ __forceinline__ void load_x(const float* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = __ldg(p);
  } else {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
}

// The dot of the tile row `row` (bn values) with the x block `xb`, by one warp; every
// lane returns the same bits. `zero`: a padding tile, whose values are 0 (not read).
// bn % VEC == 0 and row, xb VEC-aligned when VEC > 1.
template <typename T, int VEC>
__device__ __forceinline__ float tile_row_dot(const T* row, const float* xb, int bn, int lane,
                                              bool zero) {
  float acc[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
#pragma unroll 4
  for (int j = lane * VEC; j < bn; j += 32 * VEC) {
    float v[VEC], xv[VEC];
    if (zero) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) v[q] = 0.f;
    } else {
      load_vals<VEC>(row + j, v);
    }
    load_x<VEC>(xb + j, xv);
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = fmaf(v[q], xv[q], acc[q]);
  }
  float s = acc[0];
#pragma unroll
  for (int q = 1; q < VEC; ++q) s += acc[q];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// K9a: the CTA (block row blockIdx.x, rows blockIdx.y * kWarps ...) over its tiles.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) bcsr_rows_kernel(
    const T* __restrict__ vals, const int* __restrict__ cols, const int* __restrict__ rowptr,
    const float* __restrict__ x, int bm, int bn, float* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (r >= bm) return;  // the whole warp leaves together
  const int64_t i = blockIdx.x;
  const int f_end = rowptr[i + 1];
  float acc = 0.f;
  for (int f = rowptr[i]; f < f_end; ++f) {
    const T* row = vals + (static_cast<int64_t>(f) * bm + r) * bn;
    acc += tile_row_dot<T, VEC>(row, x + static_cast<int64_t>(cols[f]) * bn, bn, lane, false);
  }
  if (lane == 0) y[i * bm + r] = acc;
}

// K9b pass 1: the CTA of slab blockIdx.x writes part[f * bm + r], the dot of row r of
// tile f, for the slab's tiles f; f >= nnzb is a zero padding tile at column block 0.
template <typename T, int VEC>
__global__ void __launch_bounds__(kSlabThreads) bcsr_slab_partial_kernel(
    const T* __restrict__ vals, const int* __restrict__ cols, int64_t nnzb, int slab,
    const float* __restrict__ x, int bm, int bn, float* __restrict__ part) {
  const int lane = threadIdx.x & 31;
  const int64_t f0 = static_cast<int64_t>(blockIdx.x) * slab;
  for (int t = threadIdx.x >> 5; t < slab * bm; t += kSlabWarps) {
    const int64_t f = f0 + t / bm;
    const int r = t % bm;
    const bool pad = f >= nnzb;
    const T* row = pad ? vals : vals + (f * bm + r) * bn;
    const float* xb = x + (pad ? 0 : static_cast<int64_t>(cols[f]) * bn);
    const float d = tile_row_dot<T, VEC>(row, xb, bn, lane, pad);
    if (lane == 0) part[f * bm + r] = d;
  }
}

// The first index in rows[0 .. n) that is >= v (rows nondecreasing).
__device__ __forceinline__ int64_t lower_bound(const int* rows, int64_t n, int v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (rows[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// K9b pass 2: y[i * bm + r] = 0 + part of each of block row i's tiles in tile order; block
// row 0 then adds the padding tiles' (nnzb .. total - 1).
__global__ void __launch_bounds__(kReduceThreads) bcsr_slab_reduce_kernel(
    const float* __restrict__ part, const int* __restrict__ rows, int64_t nnzb, int64_t total,
    int bm, float* __restrict__ y) {
  const int i = blockIdx.x;
  const int64_t lo = lower_bound(rows, nnzb, i);
  const int64_t hi = lower_bound(rows, nnzb, i + 1);
  for (int r = threadIdx.x; r < bm; r += kReduceThreads) {
    float acc = 0.f;
    for (int64_t f = lo; f < hi; ++f) acc += part[f * bm + r];
    if (i == 0) {
      for (int64_t f = nnzb; f < total; ++f) acc += part[f * bm + r];
    }
    y[static_cast<int64_t>(i) * bm + r] = acc;
  }
}

bool shape_ok(long long nbr, int bm, int bn, int vec) {
  return nbr >= 1 && nbr <= 0x7fffffffLL && bm >= 1 && bn >= 1 &&
         (bm + kWarps - 1) / kWarps <= 65535 && (vec == 1 || (vec == 4 && bn % 4 == 0));
}

template <typename T, int VEC>
void launch_rows(const void* vals, const int* cols, const int* rowptr, const float* x,
                 long long nbr, int bm, int bn, float* y, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(nbr), static_cast<unsigned>((bm + kWarps - 1) / kWarps));
  bcsr_rows_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(vals), cols,
                                                           rowptr, x, bm, bn, y);
}

template <typename T, int VEC>
void launch_slab(const void* vals, const int* cols, long long nnzb, int slab, long long total,
                 const float* x, int bm, int bn, float* part, cudaStream_t stream) {
  bcsr_slab_partial_kernel<T, VEC><<<static_cast<unsigned>(total / slab), kSlabThreads, 0,
                                     stream>>>(static_cast<const T*>(vals), cols, nnzb, slab, x,
                                               bm, bn, part);
}

}  // namespace

extern "C" {

// K9a. vals (nnzb, bm, bn) f32 (vals_is_bf16 0) or bf16 (1), cols (nnzb,), rowptr
// (nbr + 1,) int32, x (nbc * bn,), y (nbr * bm,). vec: 1, or 4 when bn % 4 == 0 and vals
// and x are 16-byte aligned. Returns the cudaError_t of the launch (0 on success).
int adaprox_bcsr_matvec(const void* vals, int vals_is_bf16, int vec, const int* cols,
                        const int* rowptr, const float* x, long long nbr, int bm, int bn,
                        float* y, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(nbr, bm, bn, vec)) return cudaErrorInvalidValue;
  if (vals_is_bf16) {
    if (vec == 4) {
      launch_rows<__nv_bfloat16, 4>(vals, cols, rowptr, x, nbr, bm, bn, y, stream);
    } else {
      launch_rows<__nv_bfloat16, 1>(vals, cols, rowptr, x, nbr, bm, bn, y, stream);
    }
  } else {
    if (vec == 4) {
      launch_rows<float, 4>(vals, cols, rowptr, x, nbr, bm, bn, y, stream);
    } else {
      launch_rows<float, 1>(vals, cols, rowptr, x, nbr, bm, bn, y, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// K9b. vals (nnzb, bm, bn) and cols (nnzb,) as K9a's; rows (nnzb,) int32, nondecreasing;
// total = nnzb rounded up to a multiple of slab (the padded tile count); part holds
// total * bm floats; y (nbr * bm,). Returns the cudaError_t of the launches.
int adaprox_bcsr_matvec_slab(const void* vals, int vals_is_bf16, int vec, const int* cols,
                             const int* rows, long long nnzb, int slab, const float* x,
                             long long nbr, int bm, int bn, float* part, float* y,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(nbr, bm, bn, vec) || nnzb < 1 || slab < 1) return cudaErrorInvalidValue;
  const long long total = (nnzb + slab - 1) / slab * slab;
  if (total / slab > 0x7fffffffLL || static_cast<long long>(slab) * bm > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  if (vals_is_bf16) {
    if (vec == 4) {
      launch_slab<__nv_bfloat16, 4>(vals, cols, nnzb, slab, total, x, bm, bn, part, stream);
    } else {
      launch_slab<__nv_bfloat16, 1>(vals, cols, nnzb, slab, total, x, bm, bn, part, stream);
    }
  } else {
    if (vec == 4) {
      launch_slab<float, 4>(vals, cols, nnzb, slab, total, x, bm, bn, part, stream);
    } else {
      launch_slab<float, 1>(vals, cols, nnzb, slab, total, x, bm, bn, part, stream);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bcsr_slab_reduce_kernel<<<static_cast<unsigned>(nbr), kReduceThreads, 0, stream>>>(
      part, rows, nnzb, total, bm, y);
  return static_cast<int>(cudaGetLastError());
}

const char* adaprox_bcsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
