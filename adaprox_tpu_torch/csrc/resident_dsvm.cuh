// What the dual SVM's cooperative whole-solve kernel, K6d (resident_pd.cu), is built on: its
// plan (the grid, the rows of Q or B a CTA holds in shared memory and where its vectors live),
// the row dot over rows held in shared memory or read from device memory, the B'x reduce and
// the launch. Q is the N x N Gram (dense) or, factored, Q = B B' with B (N x d) = D_y X. (K6a,
// K6b and K6c run on thread-block clusters: resident_dsvm_grid.cu.)
//
// Every function is deterministic: one fixed order of every sum, no atomics.

#pragma once

#include "resident_common.cuh"

namespace {

// Per-CTA partial sums of a row pass: part[k * grid + cta]. kAx is labels'x of the iterate the
// pass writes; kPrimal2, kFqx and kFlin (||primal||^2, x.Qx and ones.x) are of the iterate it
// reads. Factored, the pass's d partials of B'x follow, at part + kPdParts * grid, as
// [cta * d + c].
enum PdPart { kAx = 0, kPrimal2, kFqx, kFlin, kPdParts };

constexpr long long kCtaSmem = 232448;  // the most shared memory a CTA may take (227 KB)
constexpr long long kStaticSmem = 1024;  // the kernel's static shared memory, rounded up
// the threads that reduce B'x (factored) or stage x (dense) while warps 0..kPdParts-1 sum the
// scalar partials
constexpr int kRedThreads = kThreads - 32 * kPdParts;
constexpr long long kSlotFloats = 3;  // a held row's v, label and (factored) x

__host__ __device__ constexpr long long round16(long long bytes) { return (bytes + 15) / 16 * 16; }

// K6d's layout for a shape (ops/resident_pd.py::k6d_plan computes the same numbers): the grid,
// the rows a warp and a CTA own (warp w of CTA c owns rows c * 16 + w, + 16 * grid, ...), the
// route (0: each CTA holds its rows of Q or B in shared memory, loaded once; 1: the rows are
// read from device memory, through the L2, every pass), whether x (dense) is staged in shared
// memory and whether the warps' partials of B'x (factored) live there, the dynamic shared
// memory and its regions' byte offsets, and the floats of `part` the launch needs.
struct PdPlan {
  long long route, grid, rows_per_warp, rows_per_cta, smem, x_shared, acc_shared, part_len;
  long long off_slots, off_vec, off_red, off_acc;
};
constexpr int kPdPlanOut = 8;  // the plan's numbers the C entry reports, in PdPlan's order

// Fills *out; false when the shape is refused (B'x does not fit a CTA's shared memory).
inline bool pd_plan(long long n, long long d, bool factored, int itemsize, int sms, PdPlan* out) {
  if (n < 1 || (factored && d < 1) || (itemsize != 2 && itemsize != 4) || sms < 1) return false;
  PdPlan p{};
  const long long len = factored ? d : n;  // a row of Q or B
  const long long want = (n + kWarps - 1) / kWarps;
  p.grid = want < sms ? want : sms;
  p.rows_per_warp = (n + p.grid * kWarps - 1) / (p.grid * kWarps);
  p.rows_per_cta = kWarps * p.rows_per_warp;
  const long long budget = kCtaSmem - kStaticSmem;
  const long long rows = round16(p.rows_per_cta * len * itemsize);
  const long long slots = round16(p.rows_per_cta * kSlotFloats * 4);
  const long long vec = round16(4 * len);  // x (dense) or B'x (factored)
  const long long red = factored ? 16LL * kRedThreads : 0;
  const long long acc = factored ? 4LL * kWarps * d : 0;
  if (rows + slots + vec + red + acc <= budget) {
    p.route = 0;
    p.x_shared = p.acc_shared = 1;
    p.off_slots = rows;
    p.off_vec = rows + slots;
  } else {
    p.route = 1;
    if (factored && vec + red > budget) return false;
    p.x_shared = vec <= budget;
    p.acc_shared = factored && vec + red + acc <= budget;
    p.off_slots = p.off_vec = 0;
  }
  p.off_red = p.off_vec + (p.x_shared ? vec : 0);
  p.off_acc = p.off_red + red;
  p.smem = p.off_acc + (p.acc_shared ? acc : 0);
  if (!factored) p.acc_shared = 0;
  // two parities of the partials, and the warps' partials of B'x when they are not on chip
  p.part_len = 2 * (kPdParts + (factored ? d : 0)) * p.grid +
               (factored && !p.acc_shared ? p.grid * kWarps * d : 0);
  *out = p;
  return true;
}

// VEC consecutive values of a row held in shared memory, as floats (load_a's conversions).
template <int VEC>
__device__ __forceinline__ void load_held(const float* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = p[0];
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
}

template <int VEC>
__device__ __forceinline__ void load_held(const __nv_bfloat16* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = __bfloat162float(p[0]);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 v = __bfloat1622float2(h[q]);
      out[2 * q] = v.x;
      out[2 * q + 1] = v.y;
    }
  }
}

// VEC values of a row of Q or B: from shared memory (kHeld) or device memory (load_a).
template <typename T, int VEC, bool kHeld>
__device__ __forceinline__ void load_row(const T* p, float* out) {
  if constexpr (kHeld) {
    load_held<VEC>(p, out);
  } else {
    load_a<VEC>(p, out);
  }
}

// warp_dot (resident_common.cuh) over a row held in shared memory or read from device memory:
// the same lanes, the same fmaf chain and the same shuffle tree, so the same bits. The result
// is in lane 0. kZero: the dot with a vector of zeros, vec not read (the warm-up's Q x0: +-0,
// or NaN where the row holds a value that is not finite).
template <typename T, int VEC, bool kHeld, bool kZero = false>
__device__ __forceinline__ float row_dot(const T* row, const float* vec, long long len,
                                         int lane) {
  float acc = 0.f;
  const long long steps = len / VEC;
#pragma unroll 4
  for (long long k = lane; k < steps; k += 32) {
    float av[VEC], xv[VEC] = {};
    load_row<T, VEC, kHeld>(row + k * VEC, av);
    if constexpr (!kZero) load_f32<VEC>(vec + k * VEC, xv);
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc = fmaf(av[q], xv[q], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(kFull, acc, off);
  return acc;
}

// Copy a row of Q or B (len values) into shared memory, each lane the VEC-value pieces it
// reads in row_dot.
template <typename T, int VEC>
__device__ __forceinline__ void copy_row(T* dst, const T* __restrict__ src, long long len,
                                         int lane) {
  const long long steps = len / VEC;
  for (long long k = lane; k < steps; k += 32) {
    if constexpr (VEC == 1) {
      dst[k] = __ldg(src + k);
    } else {
      reinterpret_cast<uint4*>(dst)[k] = __ldg(reinterpret_cast<const uint4*>(src) + k);
    }
  }
}

// acc[c] += z * row[c] over a row of B, each lane the columns it reads in row_dot (factored:
// this warp's partial of B'x_new; the same lane owns the same columns in every pass).
template <typename T, int VEC, bool kHeld>
__device__ __forceinline__ void add_row(float* acc, const T* row, float z, long long len,
                                        int lane) {
  const long long steps = len / VEC;
  for (long long k = lane; k < steps; k += 32) {
    float av[VEC];
    load_row<T, VEC, kHeld>(row + k * VEC, av);
    if constexpr (VEC == 1) {
      acc[k] = fmaf(av[0], z, acc[k]);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; q += 4) {
        float4* a4 = reinterpret_cast<float4*>(acc + k * VEC + q);
        float4 s = *a4;
        s.x = fmaf(av[q], z, s.x);
        s.y = fmaf(av[q + 1], z, s.y);
        s.z = fmaf(av[q + 2], z, s.z);
        s.w = fmaf(av[q + 3], z, s.w);
        *a4 = s;
      }
    }
  }
}

// Zero this warp's partial of B'x (the columns add_row's lanes own).
template <int VEC>
__device__ __forceinline__ void zero_acc(float* acc, long long len, int lane) {
  const long long steps = len / VEC;
  for (long long k = lane; k < steps; k += 32) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[k * VEC + q] = 0.f;
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The first stage of B'x's reduce, by the kRedThreads threads t of warps kPdParts..: the grid's
// partials part_bx[cta * d + c] read in units of U floats (4 when d % 4 == 0), thread (g, u)
// summing the CTAs g, g + groups, ... of unit u in order into s_btx (one group) or s_red; then,
// after a block barrier, finish_btx adds the groups in group order. Every CTA runs the same
// code on the same partials: the same bits everywhere.
template <int U>
__device__ __forceinline__ void reduce_btx(long long d, const float* part_bx, float* s_btx,
                                           float4* s_red, int t) {
  const long long units = d / U;
  const int groups = units >= kRedThreads ? 1 : kRedThreads / static_cast<int>(units);
  const int width = groups == 1 ? kRedThreads : static_cast<int>(units);
  const int g = t / width;
  if (g >= groups) return;
  const int grid = static_cast<int>(gridDim.x);
  for (long long u = t % width; u < units; u += width) {
    if constexpr (U == 4) {
      const float4* src = reinterpret_cast<const float4*>(part_bx) + u;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int k = g; k < grid; k += groups) acc = add4(acc, __ldcg(src + k * units));
      if (groups == 1) {
        reinterpret_cast<float4*>(s_btx)[u] = acc;
      } else {
        s_red[g * width + u] = acc;
      }
    } else {
      float acc = 0.f;
#pragma unroll 8
      for (int k = g; k < grid; k += groups) acc += __ldcg(part_bx + k * d + u);
      if (groups == 1) {
        s_btx[u] = acc;
      } else {
        reinterpret_cast<float*>(s_red)[g * width + u] = acc;
      }
    }
  }
}

template <int U>
__device__ __forceinline__ void finish_btx(long long d, float* s_btx, const float4* s_red,
                                           int t, int nt) {
  const long long units = d / U;
  const int groups = units >= kRedThreads ? 1 : kRedThreads / static_cast<int>(units);
  if (groups == 1) return;  // reduce_btx wrote s_btx
  for (long long u = t; u < units; u += nt) {
    if constexpr (U == 4) {
      float4 s = s_red[u];
      for (int k = 1; k < groups; ++k) s = add4(s, s_red[k * units + u]);
      reinterpret_cast<float4*>(s_btx)[u] = s;
    } else {
      const float* r = reinterpret_cast<const float*>(s_red);
      float s = r[u];
      for (int k = 1; k < groups; ++k) s += r[k * units + u];
      s_btx[u] = s;
    }
  }
}

// pick_<kernel>: the instantiation for (storage, row vector width, route), or null for a
// combination that does not exist.
#define ADAPROX_PICK_DSVM(KERNEL)                                                             \
  const void* pick_##KERNEL(int q_is_bf16, int vec, bool held) {                             \
    if (q_is_bf16) {                                                                          \
      if (vec == 1) return held ? reinterpret_cast<const void*>(&KERNEL<__nv_bfloat16, 1, true>) \
                                : reinterpret_cast<const void*>(&KERNEL<__nv_bfloat16, 1, false>); \
      if (vec == 8) return held ? reinterpret_cast<const void*>(&KERNEL<__nv_bfloat16, 8, true>) \
                                : reinterpret_cast<const void*>(&KERNEL<__nv_bfloat16, 8, false>); \
    } else {                                                                                  \
      if (vec == 1) return held ? reinterpret_cast<const void*>(&KERNEL<float, 1, true>)      \
                                : reinterpret_cast<const void*>(&KERNEL<float, 1, false>);    \
      if (vec == 4) return held ? reinterpret_cast<const void*>(&KERNEL<float, 4, true>)      \
                                : reinterpret_cast<const void*>(&KERNEL<float, 4, false>);    \
    }                                                                                         \
    return nullptr;                                                                           \
  }

// Launch kernel cooperatively with `plan` (pd_plan's, for this card's SM count): its grid and
// dynamic shared memory; part must hold plan.part_len floats. Returns the cudaError_t
// (cudaErrorNotSupported: no cooperative launch here).
cudaError_t launch_pd(const void* kernel, void** args, const PdPlan& plan, long long part_len,
                      void* stream_ptr) {
  int dev = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const size_t smem = static_cast<size_t>(plan.smem);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (plan.part_len > part_len) return cudaErrorInvalidValue;
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(plan.grid)),
                                    dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
