// K9a and K9b for Hopper: the block-sparse (BCSR) matvecs over the stored (bm, bn) tiles
// of A, both directions from the same tiles: vals (nnzb, bm, bn) block-row-major, cols
// (nnzb,) the tiles' block columns, rowptr (nbr + 1,) the block rows' extents (K9a) or
// rows (nnzb,) the tiles' block rows (K9b); for A'y also the column index of the tile
// pattern, colptr (nbc + 1,) and col_tiles (nnzb,): each block column's tile ids in
// increasing order. y = A x: x (nbc * bn,), y (nbr * bm,); x = A'y the other way round.
//
// Replaces the Pallas TPU kernels adaprox_tpu/ops/bcsr.py::bcsr_matvec (K9a, body
// _kernel: a (block row, step) grid whose scalar-prefetched index maps pick each tile)
// and bcsr_matvec_slab (K9b, body _slab_kernel: a sequential grid over contiguous slabs
// of tiles accumulating into one resident y). The JAX package takes A'y through a second
// BCSR structure of A' at A's tile shape, because Mosaic's (8, 128) tiling wants its
// operand row-major; at the sparse case (8192 x 16384, 10% of the (64, 512) tiles) that
// structure stores 2288 tiles, 300 MB, against A's 407, 53 MB. On the card A'y over A's
// own tile is a coalesced read too, so here both directions read A's 53 MB. (Called on
// A''s structure, the A x kernels still compute the JAX formulation of A'y.) vals are
// f32 or bf16, the vectors f32; plain f32 FMAs with f32 accumulation (no tensor cores,
// no TF32: a matvec does 2 flops a stored value, 0.5 a byte in f32, far below the 295
// operations a byte at which the card's tensor cores would become the limit).
//
// What bounds them on the card: the bytes of the stored tiles, read once, at 3.35 TB/s;
// the vectors' blocks stay in L1/L2. So each lives or dies by the bytes it keeps in
// flight: an SM needs some 24-32 KB outstanding to draw its 1/132 of the card's rate.
//
// Design. No atomics anywhere, every sum in one fixed order: two launches give the same
// bits, which the adaptive rules need, and K9b equals K9a bit for bit on finite input
// because both take the same device routine and the same order.
//   * A x, tile_row_dot: the dot of one row of one tile with its x block by a warp,
//     lane l taking the VEC-vectors l, l + 32, ..., VEC accumulators summed in a fixed
//     order, then an xor butterfly over the lanes. A row sums its tiles' dots as
//     0 + d_0 + d_1 + ... in tile order.
//   * A'y, tile_col_partial: one tile's partial for VEC output columns j, by one
//     thread: p_f[j] = sum over r of vals[f, r, j] * y[rows[f] * bm + r], an fmaf chain
//     in r order from 0. Neighbouring threads own neighbouring columns, so each tile row
//     is a coalesced read; with the loop unrolled 8 times a thread keeps 8 16-byte loads
//     in flight. A column sums its tiles' partials as 0 + p_f0 + p_f1 + ... in col_tiles
//     order.
//   * K9a, A x (bcsr_rows_kernel): a warp an output row; the CTA of (block row i, kWarps
//     rows) loops over exactly rowptr[i] .. rowptr[i + 1] - 1.
//   * K9a, A'y (bcsr_cols_kernel, one pass): the CTA of (block column c, a slice of
//     kLanes * VEC columns) takes the column's tiles kColGroups at a time, a group of
//     kLanes threads a tile, writes their partials to shared memory and adds them in
//     col_tiles order. 64-column slices give 256 CTAs at the sparse case, so a long
//     block column (20 tiles there, 12.7 on average) is spread over 8 SMs, and 32 tiles
//     at a time take it in one round (16 at a time, in two rounds, ran longer).
//   * K9b: blocks run in no order on the card, so nothing is carried between them. Pass
//     1 writes each tile's partials, pass 2 sums them in tile order:
//     - A x, pass 1 (bcsr_ring_kernel): vals read as one (nnzb * bm, bn) row matrix, cut
//       into bands of rows of about 16 KB (a whole number of 16-byte units), dealt
//       round robin to three persistent CTAs an SM; each CTA keeps kRingDepth bands in
//       flight as bulk copies into a shared-memory ring (bulk_copy.cuh, as K10c), and
//       its warps take each band's row dots from shared memory into part (nnzb * bm).
//       The JAX kernel's slab is its padding rule, not a unit of work here. (Two CTAs
//       an SM, 8 KB bands, or an L1 prefetch of the x blocks before the wait all ran
//       slower on an H100.)
//     - A x, pass 2 (bcsr_slab_reduce_kernel): a CTA a block row sums its tiles'
//       partials in tile order (binary search for the run in the block-row-major rows).
//       The JAX wrapper pads the tile count to a slab multiple with zero tiles at block
//       row 0, column block 0; those are not stored but computed as 0 * x[0 : bn] and
//       added to block row 0 after its own tiles, as the TPU kernel adds them: NaN where
//       that x block is not finite, else +0.
//     - A'y, pass 1 (bcsr_col_partial_kernel): tile-parallel, a group of kLanes threads
//       a (tile, column slice), the tile's column partials into part (nnzb * bn).
//     - A'y, pass 2 (bcsr_col_reduce_kernel): a CTA a block column sums its tiles'
//       partials in col_tiles order.
// A non-finite y[r] reaches every output column of each block column that has a tile
// in r's block row (its partial is NaN or inf there), and no other; over A''s structure
// the JAX kernels reach another set, and JAX's K9b also its padding tiles' x[0 : bm].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kThreads = 256;  // K9a A x: a CTA of kWarps rows
constexpr int kWarps = kThreads / 32;
constexpr int kRingThreads = 256;  // K9b A x pass 1: a warp a row of a band
constexpr int kRingWarps = kRingThreads / 32;
constexpr int kRingPerSm = 3;           // persistent CTAs an SM
constexpr int kRingDepth = 4;           // bands in flight a CTA
constexpr int kBandBytes = 16 * 1024;   // the band's target size
constexpr int kRingSmem = 70 * 1024;    // the most a CTA's ring may take (three an SM)
constexpr int kBarBytes = 128;          // the ring's barriers, before the slots
constexpr int kLanes = 16;              // K9a A'y: threads a tile, VEC columns each
constexpr int kColGroups = 32;          // K9a A'y: tiles at once in a CTA
constexpr int kColThreads = kLanes * kColGroups;
constexpr int kPartLanes = 16;          // K9b A'y pass 1: threads a tile
constexpr int kPartGroups = 8;          // K9b A'y pass 1: tiles a CTA
constexpr int kPartThreads = kPartLanes * kPartGroups;
constexpr int kReduceThreads = 128;     // K9b pass 2: a CTA a block row or column

// VEC values of vals at p as floats: streaming loads (ld.global.cs) from device memory,
// plain loads from shared memory (kSmem).
template <int VEC, bool kSmem>
__device__ __forceinline__ void load_vals(const float* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = kSmem ? *p : __ldcs(p);
  } else {
    static_assert(VEC == 4, "f32 vals are read 1 or 4 at a time");
    const float4 v = kSmem ? *reinterpret_cast<const float4*>(p)
                           : __ldcs(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
}

template <int VEC, bool kSmem>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = __bfloat162float(p[0]);
  } else {
    static_assert(VEC == 4, "bf16 vals are read 1 or 4 at a time");
    const uint2 raw = kSmem ? *reinterpret_cast<const uint2*>(p)
                            : __ldcs(reinterpret_cast<const uint2*>(p));
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

// The dot of the tile row `row` (bn values, in device memory or, kSmem, shared memory)
// with the x block `xb`, by one warp; every lane returns the same bits. bn % VEC == 0 and
// row, xb VEC-aligned when VEC > 1.
template <typename T, int VEC, bool kSmem>
__device__ __forceinline__ float tile_row_dot(const T* row, const float* xb, int bn,
                                              int lane) {
  float acc[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
#pragma unroll 4
  for (int j = lane * VEC; j < bn; j += 32 * VEC) {
    float v[VEC], xv[VEC];
    load_vals<VEC, kSmem>(row + j, v);
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

// The partials of tile `tile` (bm rows of bn values in device memory) for the VEC output
// columns j .. j + VEC - 1 of A'y: p[q] = sum over r of tile[r, j + q] * yb[r], an fmaf
// chain in r order from 0. j + VEC <= bn, and j VEC-aligned when VEC > 1.
template <typename T, int VEC>
__device__ __forceinline__ void tile_col_partial(const T* tile, const float* yb, int bm,
                                                 int bn, int j, float* p) {
#pragma unroll
  for (int q = 0; q < VEC; ++q) p[q] = 0.f;
#pragma unroll 8
  for (int r = 0; r < bm; ++r) {
    float v[VEC];
    load_vals<VEC, false>(tile + static_cast<int64_t>(r) * bn + j, v);
    const float yr = __ldg(yb + r);
#pragma unroll
    for (int q = 0; q < VEC; ++q) p[q] = fmaf(v[q], yr, p[q]);
  }
}

// K9a, A x: the CTA (block row blockIdx.x, rows blockIdx.y * kWarps ...) over its tiles.
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
    acc += tile_row_dot<T, VEC, false>(row, x + static_cast<int64_t>(cols[f]) * bn, bn, lane);
  }
  if (lane == 0) y[i * bm + r] = acc;
}

// K9a, A'y: the CTA (block column blockIdx.x, columns of slice blockIdx.y) over the
// column's tiles, kColGroups at a time; group g's partials go to sp[g], then the
// threads of group 0 add them in col_tiles order.
template <typename T, int VEC>
__global__ void __launch_bounds__(kColThreads) bcsr_cols_kernel(
    const T* __restrict__ vals, const int* __restrict__ rows, const int* __restrict__ colptr,
    const int* __restrict__ col_tiles, const float* __restrict__ y, int bm, int bn,
    float* __restrict__ x) {
  __shared__ float sp[kColGroups][kLanes * VEC];
  const int g = threadIdx.x / kLanes;
  const int l = threadIdx.x % kLanes;
  const int64_t c = blockIdx.x;
  const int j = (blockIdx.y * kLanes + l) * VEC;
  const bool live = j < bn;
  const int col_begin = colptr[c];
  const int col_end = colptr[c + 1];
  float acc[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
  for (int k0 = col_begin; k0 < col_end; k0 += kColGroups) {
    const int k = k0 + g;
    if (live && k < col_end) {
      const int64_t f = col_tiles[k];
      float p[VEC];
      tile_col_partial<T, VEC>(vals + f * bm * bn, y + static_cast<int64_t>(rows[f]) * bm, bm,
                               bn, j, p);
#pragma unroll
      for (int q = 0; q < VEC; ++q) sp[g][l * VEC + q] = p[q];
    }
    __syncthreads();
    if (live && g == 0) {
      const int count = col_end - k0 < kColGroups ? col_end - k0 : kColGroups;
      for (int h = 0; h < count; ++h) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q] += sp[h][l * VEC + q];
      }
    }
    __syncthreads();
  }
  if (live && g == 0) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) x[c * bn + j + q] = acc[q];
  }
}

// K9b A x, pass 1: this CTA's bands blockIdx.x + t * gridDim.x (t < its count) of the
// (nrows = nnzb * bm, bn) row matrix, `band` rows each (the last may be shorter), through
// a ring of `depth` slots; part[R] = the dot of row R with the x block of its tile.
template <typename T, int VEC>
__global__ void __launch_bounds__(kRingThreads) bcsr_ring_kernel(
    const T* __restrict__ vals, const int* __restrict__ cols, int64_t nrows, int bm, int bn,
    int band, int64_t bands, int depth, const float* __restrict__ x, float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kBarBytes;
  const int64_t row_bytes = static_cast<int64_t>(bn) * sizeof(T);
  const int64_t slot_bytes = band * row_bytes;
  const int64_t grid = gridDim.x;
  const int64_t mine = (bands - blockIdx.x + grid - 1) / grid;
  const int d = static_cast<int>(mine < depth ? mine : depth);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(vals);

  auto first_row = [&](int64_t t) { return (blockIdx.x + t * grid) * band; };
  auto rows_of = [&](int64_t r0) {
    return static_cast<int>(nrows - r0 < band ? nrows - r0 : band);
  };
  auto start = [&](int64_t t, int slot) {
    const int64_t r0 = first_row(t);
    bulk_load(ring + slot * slot_bytes, src + r0 * row_bytes,
              static_cast<uint32_t>(rows_of(r0) * row_bytes), bars + slot);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < d; ++s) bulk_init(bars + s);
    bulk_init_fence();
    for (int s = 0; s < d; ++s) start(s, s);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int64_t t = 0; t < mine; ++t) {
    const int slot = static_cast<int>(t % d);
    const int64_t r0 = first_row(t);
    const int nr = rows_of(r0);
    bulk_wait(bars + slot, static_cast<uint32_t>((t / d) & 1));
    const T* s = reinterpret_cast<const T*>(ring + slot * slot_bytes);
    for (int r = threadIdx.x >> 5; r < nr; r += kRingWarps) {
      const int64_t row = r0 + r;
      const float* xb = x + static_cast<int64_t>(cols[row / bm]) * bn;
      const float dot = tile_row_dot<T, VEC, true>(s + static_cast<int64_t>(r) * bn, xb, bn,
                                                   lane);
      if (lane == 0) part[row] = dot;
    }
    __syncthreads();  // every warp is done with the slot
    if (threadIdx.x == 0 && t + d < mine) {
      bulk_reuse_fence();  // this CTA's reads of the slot before the copy that refills it
      start(t + d, slot);
    }
  }
}

// The first index in rows[0 .. n) that is >= v (rows nondecreasing), by one warp: each
// round the lanes probe 32 evenly spaced entries and a ballot narrows the range 32-fold,
// so a search waits on about log32(n) loads instead of log2(n). Every lane returns it.
__device__ __forceinline__ int64_t warp_lower_bound(const int* rows, int64_t n, int v,
                                                    int lane) {
  int64_t lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + lane * step;
    const unsigned less = __ballot_sync(0xffffffffu, p < hi && rows[p] < v);
    const int k = __popc(less);  // the probes before the answer
    if (k == 0) return lo;
    const int64_t top = lo + k * step;
    lo += (k - 1) * step + 1;
    hi = top < hi ? top : hi;
  }
  const int64_t p = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, p < hi && rows[p] < v));
}

// K9b A x, pass 2: y[i * bm + r] = 0 + part of each of block row i's tiles in tile order;
// block row 0 then adds the `pad` zero padding tiles' dot 0 * x[0 : bn] (+0, or NaN where
// that block is not finite). Warps 0 and 1 find the run's two ends at once.
__global__ void __launch_bounds__(kReduceThreads) bcsr_slab_reduce_kernel(
    const float* __restrict__ part, const int* __restrict__ rows, int64_t nnzb, int64_t pad,
    const float* __restrict__ x, int bm, int bn, float* __restrict__ y) {
  __shared__ int64_t run[2];
  const int i = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t end = warp_lower_bound(rows, nnzb, i + warp, threadIdx.x & 31);
    if ((threadIdx.x & 31) == 0) run[warp] = end;
  }
  // the padding tiles' dot: +0 when x[0 : bn] is finite, NaN otherwise (0 * inf is NaN)
  float zero_dot = 0.f;
  if (i == 0 && pad > 0) {
    for (int j = threadIdx.x; j < bn; j += kReduceThreads) zero_dot = fmaf(0.f, x[j], zero_dot);
  }
  const bool nan_pad = __syncthreads_or(zero_dot != zero_dot);
  const float pad_dot = nan_pad ? __int_as_float(0x7fffffff) : 0.f;
  const int64_t lo = run[0], hi = run[1];
  for (int r = threadIdx.x; r < bm; r += kReduceThreads) {
    float acc = 0.f;
#pragma unroll 4
    for (int64_t f = lo; f < hi; ++f) acc += part[f * bm + r];
    if (i == 0) {
      for (int64_t k = 0; k < pad; ++k) acc += pad_dot;
    }
    y[static_cast<int64_t>(i) * bm + r] = acc;
  }
}

// K9b A'y, pass 1: part[f * bn + j] = tile f's partial for column j, a group of kLanes
// threads a (tile blockIdx.x * kPartGroups + g, slice blockIdx.y).
template <typename T, int VEC>
__global__ void __launch_bounds__(kPartThreads) bcsr_col_partial_kernel(
    const T* __restrict__ vals, const int* __restrict__ rows, int64_t nnzb,
    const float* __restrict__ y, int bm, int bn, float* __restrict__ part) {
  const int64_t f = static_cast<int64_t>(blockIdx.x) * kPartGroups + threadIdx.x / kPartLanes;
  const int j = (blockIdx.y * kPartLanes + threadIdx.x % kPartLanes) * VEC;
  if (f >= nnzb || j >= bn) return;
  float p[VEC];
  tile_col_partial<T, VEC>(vals + f * bm * bn, y + static_cast<int64_t>(rows[f]) * bm, bm, bn,
                           j, p);
#pragma unroll
  for (int q = 0; q < VEC; ++q) part[f * bn + j + q] = p[q];
}

// K9b A'y, pass 2: x[c * bn + j] = 0 + part of each of block column c's tiles in
// col_tiles order; the CTA (block column blockIdx.x, columns blockIdx.y * kReduceThreads
// ...), a thread a column.
__global__ void __launch_bounds__(kReduceThreads) bcsr_col_reduce_kernel(
    const float* __restrict__ part, const int* __restrict__ colptr,
    const int* __restrict__ col_tiles, int bn, float* __restrict__ x) {
  const int64_t c = blockIdx.x;
  const int j = blockIdx.y * kReduceThreads + threadIdx.x;
  if (j >= bn) return;
  const int k_end = colptr[c + 1];
  float acc = 0.f;
#pragma unroll 4
  for (int k = colptr[c]; k < k_end; ++k) {
    acc += part[static_cast<int64_t>(col_tiles[k]) * bn + j];
  }
  x[c * bn + j] = acc;
}

bool shape_ok(long long blocks, int bm, int bn, int vec) {
  return blocks >= 1 && blocks <= 0x7fffffffLL && bm >= 1 && bn >= 1 &&
         (bm + kWarps - 1) / kWarps <= 65535 && (vec == 1 || (vec == 4 && bn % 4 == 0));
}

// The column slices of A'y: `lanes` threads of VEC columns each.
unsigned slices(int bn, int vec, int lanes = kLanes) {
  return static_cast<unsigned>((bn + lanes * vec - 1) / (lanes * vec));
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

int gcd_ll(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return static_cast<int>(a);
}

template <typename T, int VEC>
void launch_rows(const void* vals, const int* cols, const int* rowptr, const float* x,
                 long long nbr, int bm, int bn, float* y, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(nbr), static_cast<unsigned>((bm + kWarps - 1) / kWarps));
  bcsr_rows_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(vals), cols,
                                                           rowptr, x, bm, bn, y);
}

template <typename T, int VEC>
void launch_cols(const void* vals, const int* rows, const int* colptr, const int* col_tiles,
                 const float* y, long long nbc, int bm, int bn, float* x, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(nbc), slices(bn, VEC));
  bcsr_cols_kernel<T, VEC><<<grid, kColThreads, 0, stream>>>(
      static_cast<const T*>(vals), rows, colptr, col_tiles, y, bm, bn, x);
}

template <typename T, int VEC>
cudaError_t launch_ring(const void* vals, const int* cols, long long nnzb, const float* x,
                        int bm, int bn, float* part, cudaStream_t stream) {
  const long long row_bytes = static_cast<long long>(bn) * sizeof(T);
  const long long nrows = nnzb * bm;
  // a band is a whole number of 16-byte units: a multiple of `unit` rows
  const long long unit = 16 / gcd_ll(row_bytes, 16);
  long long band = kBandBytes / row_bytes / unit * unit;
  if (band < unit) band = unit;
  if (band > nrows) band = nrows;
  const long long slot_bytes = band * row_bytes;
  long long depth = (kRingSmem - kBarBytes) / slot_bytes;
  if (depth > kRingDepth) depth = kRingDepth;
  if (depth < 1 || (nrows * row_bytes) % 16 || reinterpret_cast<uintptr_t>(vals) % 16 ||
      band > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const long long bands = (nrows + band - 1) / band;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long want = static_cast<long long>(kRingPerSm) * sms;
  const int grid = static_cast<int>(bands < want ? bands : want);
  const int smem = static_cast<int>(kBarBytes + depth * slot_bytes);
  const void* kernel = reinterpret_cast<const void*>(&bcsr_ring_kernel<T, VEC>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  bcsr_ring_kernel<T, VEC><<<grid, kRingThreads, smem, stream>>>(
      static_cast<const T*>(vals), cols, nrows, bm, bn, static_cast<int>(band), bands,
      static_cast<int>(depth), x, part);
  return cudaGetLastError();
}

template <typename T, int VEC>
void launch_col_partial(const void* vals, const int* rows, long long nnzb, const float* y,
                        int bm, int bn, float* part, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((nnzb + kPartGroups - 1) / kPartGroups),
                  slices(bn, VEC, kPartLanes));
  bcsr_col_partial_kernel<T, VEC><<<grid, kPartThreads, 0, stream>>>(
      static_cast<const T*>(vals), rows, nnzb, y, bm, bn, part);
}

// Calls LAUNCH<T, VEC>(args...) for the storage type and vector width.
#define ADAPROX_DISPATCH(LAUNCH, ...)                      \
  (vals_is_bf16 ? (vec == 4 ? LAUNCH<__nv_bfloat16, 4>(__VA_ARGS__) \
                            : LAUNCH<__nv_bfloat16, 1>(__VA_ARGS__)) \
                : (vec == 4 ? LAUNCH<float, 4>(__VA_ARGS__) : LAUNCH<float, 1>(__VA_ARGS__)))

}  // namespace

extern "C" {

// K9a, A x. vals (nnzb, bm, bn) f32 (vals_is_bf16 0) or bf16 (1), cols (nnzb,), rowptr
// (nbr + 1,) int32, x (nbc * bn,), y (nbr * bm,). vec: 1, or 4 when bn % 4 == 0 and vals
// and x are 16-byte aligned. Returns the cudaError_t of the launch (0 on success).
int adaprox_bcsr_matvec(const void* vals, int vals_is_bf16, int vec, const int* cols,
                        const int* rowptr, const float* x, long long nbr, int bm, int bn,
                        float* y, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(nbr, bm, bn, vec)) return cudaErrorInvalidValue;
  ADAPROX_DISPATCH(launch_rows, vals, cols, rowptr, x, nbr, bm, bn, y, stream);
  return static_cast<int>(cudaGetLastError());
}

// K9b, A x. vals (nnzb, bm, bn) and cols (nnzb,) as K9a's, vals 16-byte aligned and
// nnzb * bm * bn * itemsize a multiple of 16 (the bulk copies); rows (nnzb,) int32,
// nondecreasing; slab the JAX wrapper's padding multiple; part holds nnzb * bm floats;
// y (nbr * bm,). Returns the cudaError_t of the launches.
int adaprox_bcsr_matvec_slab(const void* vals, int vals_is_bf16, int vec, const int* cols,
                             const int* rows, long long nnzb, int slab, const float* x,
                             long long nbr, int bm, int bn, float* part, float* y,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(nbr, bm, bn, vec) || nnzb < 1 || slab < 1) return cudaErrorInvalidValue;
  const long long pad = (slab - nnzb % slab) % slab;
  cudaError_t err = ADAPROX_DISPATCH(launch_ring, vals, cols, nnzb, x, bm, bn, part, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  bcsr_slab_reduce_kernel<<<static_cast<unsigned>(nbr), kReduceThreads, 0, stream>>>(
      part, rows, nnzb, pad, x, bm, bn, y);
  return static_cast<int>(cudaGetLastError());
}

// K9a, A'y over A's tiles. vals (nnzb, bm, bn) f32 or bf16, rows (nnzb,), colptr
// (nbc + 1,), col_tiles (nnzb,) int32, y (nbr * bm,), x (nbc * bn,). vec: 1, or 4 when
// bn % 4 == 0 and vals is 16-byte aligned. Returns the cudaError_t of the launch.
int adaprox_bcsr_rmatvec(const void* vals, int vals_is_bf16, int vec, const int* rows,
                         const int* colptr, const int* col_tiles, const float* y,
                         long long nbc, int bm, int bn, float* x, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(nbc, bm, bn, vec) || slices(bn, vec) > 65535) return cudaErrorInvalidValue;
  ADAPROX_DISPATCH(launch_cols, vals, rows, colptr, col_tiles, y, nbc, bm, bn, x, stream);
  return static_cast<int>(cudaGetLastError());
}

// K9b, A'y over A's tiles: the arrays as K9a's A'y, nnzb the stored tiles; part holds
// nnzb * bn floats. Returns the cudaError_t of the launches.
int adaprox_bcsr_rmatvec_slab(const void* vals, int vals_is_bf16, int vec, const int* rows,
                              const int* colptr, const int* col_tiles, long long nnzb,
                              const float* y, long long nbc, int bm, int bn, float* part,
                              float* x, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(nbc, bm, bn, vec) || slices(bn, vec, kPartLanes) > 65535 || nnzb < 1 ||
      (nnzb + kPartGroups - 1) / kPartGroups > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  ADAPROX_DISPATCH(launch_col_partial, vals, rows, nnzb, y, bm, bn, part, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(nbc),
                  static_cast<unsigned>((bn + kReduceThreads - 1) / kReduceThreads));
  bcsr_col_reduce_kernel<<<grid, kReduceThreads, 0, stream>>>(part, colptr, col_tiles, bn, x);
  return static_cast<int>(cudaGetLastError());
}

const char* adaprox_bcsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
