// What the whole-solve kernels share: K2/K2c (resident_pg.cu) and K4/K4b
// (resident_bt.cu). The problem and its scratch, the prox menu, IEEE min/max,
// the vector loads of A, the warp dot product and the lockstep groups' dot
// (K2c, K4b), the per-CTA partial sums, the forward phase P1 of the three
// objectives, the gradient loop and the cooperative launch over the grid both
// pairs size the same way.
//
// Every function is deterministic: one fixed order of every sum, no atomics, so
// two launches on the same inputs give the same bits, and every CTA that sums
// the same partials gets the same bits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum Obj { kLs = 0, kLogreg = 1, kCubic = 2 };
enum Prox { kL1 = 0, kBox = 1, kElastic = 2, kZero = 3 };
// The partial slots P1 writes (phase_res): kP1F holds ||res||^2 ("ls"), the raw
// logistic sum ("logreg") or ||x||^2 of P1's point ("cubic"); kP1Obj, for
// "cubic" only, the sum of x_r (H x)_r + 2 q_r x_r; kP1Breg, when the caller
// passes the residual at the previous point ("ls" only), ||res - res_prev||^2.
enum P1Part { kP1F = 0, kP1Obj = 1, kP1Breg = 2 };

// The problem and the scratch, shared by every solve of a launch. The scratch's
// use is the kernel's own (see each .cu).
struct Problem {
  const void* a;    // (m, n) row-major, f32 or bf16
  const void* at;   // (n, m) row-major: the same values transposed ("logreg": / m_true)
  const float* b;   // (m,): the right-hand side, the labels ("logreg") or q ("cubic")
  const float* x0;  // (n,)
  float* xs;        // (2, n)
  float* gs;        // (2, n)
  float* v;         // (n,)
  float* res;       // (m,) for K2, (2, m) for K4
  float* part;      // (parts, grid)
  long long m, n;
  int hist_len;     // the length of a history row: the launch's maxit
  float p1, p2;
  float obj_pad, obj_div;  // "logreg": pad_rows * log 2 and m_true
  float cube_c;            // "cubic": c
  int obj, prox, record;
};

__device__ __forceinline__ float f32_nan() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }

// jnp.minimum / jnp.maximum: NaN in, NaN out (fminf/fmaxf would drop it).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? f32_nan() : (a < b ? a : b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? f32_nan() : (a > b ? a : b);
}
// jnp.sign: -1, +1, or the signed zero / NaN itself.
__device__ __forceinline__ float sign_of(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : v);
}

__device__ __forceinline__ float prox(int kind, float v, float gamma, float p1, float p2) {
  switch (kind) {
    case kL1:
      return sign_of(v) * nan_max(fabsf(v) - gamma * p1, 0.f);
    case kBox:
      return nan_min(nan_max(v, p1), p2);
    case kElastic:
      return sign_of(v) * nan_max(fabsf(v) - gamma * p1, 0.f) / (1.f + gamma * p2);
    default:
      return v;
  }
}

// g(x) of the record row from sum |x| and sum x^2 (indicators are 0 at feasible points).
__device__ __forceinline__ float gval_of(const Problem& p, float abs_x, float x2) {
  if (p.prox == kL1) return p.p1 * abs_x;
  if (p.prox == kElastic) return p.p1 * abs_x + 0.5f * p.p2 * x2;
  return 0.f;
}

// f from P1's sums kP1F and kP1Obj: 0.5 ||res||^2, -(raw + pad_rows log 2) / m_true,
// or S / 2 + ||x||^3 c / 6 (the cubic model, algebraically the JAX kernel's
// (<x, grad> + <q, x>) / 2 - ||x||^3 c / 12).
__device__ __forceinline__ float objective_of(const Problem& p, float s_f, float s_obj) {
  if (p.obj == kLogreg) return -(s_f + p.obj_pad) / p.obj_div;
  if (p.obj == kCubic) {
    const float nx = sqrtf(s_f);
    return 0.5f * s_obj + nx * nx * nx * p.cube_c / 6.f;
  }
  return 0.5f * s_f;
}

// VEC consecutive f32 values at p (written during the launch: plain loads).
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

// VEC consecutive values of A or A^T (read-only for the whole launch), as floats.
template <int VEC>
__device__ __forceinline__ void load_a(const float* __restrict__ p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = __ldg(p);
  } else {
    static_assert(VEC == 4, "f32 vector loads take 4 values (16 bytes)");
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
}

template <int VEC>
__device__ __forceinline__ void load_a(const __nv_bfloat16* __restrict__ p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = __bfloat162float(__ldg(p));
  } else {
    static_assert(VEC == 8, "bf16 vector loads take 8 values (16 bytes)");
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 v = __bfloat1622float2(h[q]);
      out[2 * q] = v.x;
      out[2 * q + 1] = v.y;
    }
  }
}

// sum_k row[k] * vec[k] over len values, the result in lane 0. Lanes take VEC
// consecutive values a step (len % VEC == 0 when VEC > 1), then a shuffle tree
// into lane 0: one fixed order.
template <typename T, int VEC>
__device__ __forceinline__ float warp_dot(const T* __restrict__ row, const float* vec,
                                          long long len, int lane) {
  float acc = 0.f;
  const long long steps = len / VEC;
#pragma unroll 4
  for (long long k = lane; k < steps; k += 32) {
    float av[VEC], xv[VEC];
    load_a<VEC>(row + k * VEC, av);
    load_f32<VEC>(vec + k * VEC, xv);
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc = fmaf(av[q], xv[q], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(kFull, acc, off);
  return acc;
}

// The rows a lockstep group runs at once (K2c, K4b): each pass over a row of A (or A^T)
// dots it with the vector of every row of the group still running.
constexpr int kGroup = 8;

// VEC values of a row of A or A^T as one load gives them: a 16-byte vector (4
// f32 or 8 bf16) kept packed, or one value; value q as load_a gives it, bit for
// bit (a bf16's bits are the top half of its f32's).
template <typename T, int VEC>
struct Packed {
  uint4 v;
  __device__ __forceinline__ void load(const T* __restrict__ p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  // a plain load: the row may sit in shared memory (K4b's held rows)
  __device__ __forceinline__ void load_plain(const T* p) {
    v = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ float at(int q) const {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    if constexpr (VEC == 4) return __uint_as_float(w[q]);
    return __uint_as_float(q & 1 ? w[q >> 1] & 0xffff0000u : w[q >> 1] << 16);
  }
};
template <typename T>
struct Packed<T, 1> {
  T v;
  __device__ __forceinline__ void load(const T* __restrict__ p) { v = __ldg(p); }
  __device__ __forceinline__ void load_plain(const T* p) { v = *p; }
  __device__ __forceinline__ float at(int) const {
    if constexpr (sizeof(T) == 2) return __bfloat162float(v);
    return v;
  }
};

// Vectors of A in flight a lane (the loads that warp_dot's unrolling gives K2):
// 4, or 2 of bf16, whose 8 floats a vector take twice the registers.
template <int VEC>
constexpr int kGroupAhead = VEC == 8 ? 2 : 4;

// warp_dot for every row of `mask`: acc[g] = sum_k row[k] vec[g][k] in lane 0, in
// warp_dot's order (the same lanes, the same fmaf chain, the same shuffle tree),
// so row g's dot has warp_dot's bits. The rows go two at a time, each pair one
// pass over `row` (after the first, from the L1) with kGroupAhead packed vectors
// of it in flight. Eight rows a pass needed eight pointers and their loads in
// flight at once, and ptxas spilled. kPlain: `row` read with plain loads (K4b: from
// shared memory or device memory), not through the read-only path.
template <typename T, int VEC, bool kPlain = false>
__device__ __forceinline__ void group_dot(const T* __restrict__ row, const float* const* vec,
                                          unsigned mask, long long len, int lane,
                                          float (&acc)[kGroup]) {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16, "a lane loads 16 bytes or one value");
  constexpr int kAhead = kGroupAhead<VEC>;
  const long long steps = len / VEC;
  for (unsigned left = mask; left;) {
    const int g0 = __ffs(left) - 1;
    left &= left - 1;
    const int g1 = left ? __ffs(left) - 1 : -1;
    if (left) left &= left - 1;
    const float* x0 = vec[g0];
    const float* x1 = vec[g1 < 0 ? g0 : g1];
    float s0 = 0.f, s1 = 0.f;
    long long k = lane;
#pragma unroll 1
    for (; k + 32 * (kAhead - 1) < steps; k += 32 * kAhead) {
      Packed<T, VEC> a[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if constexpr (kPlain) {
          a[u].load_plain(row + (k + 32 * u) * VEC);
        } else {
          a[u].load(row + (k + 32 * u) * VEC);
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        float xv[VEC];
        load_f32<VEC>(x0 + (k + 32 * u) * VEC, xv);
#pragma unroll
        for (int q = 0; q < VEC; ++q) s0 = fmaf(a[u].at(q), xv[q], s0);
      }
      if (g1 >= 0) {
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          float xv[VEC];
          load_f32<VEC>(x1 + (k + 32 * u) * VEC, xv);
#pragma unroll
          for (int q = 0; q < VEC; ++q) s1 = fmaf(a[u].at(q), xv[q], s1);
        }
      }
    }
#pragma unroll 1
    for (; k < steps; k += 32) {
      Packed<T, VEC> a;
      if constexpr (kPlain) {
        a.load_plain(row + k * VEC);
      } else {
        a.load(row + k * VEC);
      }
      float xv[VEC];
      load_f32<VEC>(x0 + k * VEC, xv);
#pragma unroll
      for (int q = 0; q < VEC; ++q) s0 = fmaf(a.at(q), xv[q], s0);
      if (g1 >= 0) {
        load_f32<VEC>(x1 + k * VEC, xv);
#pragma unroll
        for (int q = 0; q < VEC; ++q) s1 = fmaf(a.at(q), xv[q], s1);
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (g == g0) acc[g] = s0;
      if (g == g1) acc[g] = s1;
    }
  }
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    if (mask & (1u << g)) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[g] += __shfl_down_sync(kFull, acc[g], off);
    }
  }
}

// Lane g's row of a warp's dots: acc[g] from lane 0, so that lane g goes on
// with row g while the other lanes take the other rows.
__device__ __forceinline__ float lane_row(const float (&acc)[kGroup], int lane) {
  float mine = 0.f;
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const float v = __shfl_sync(kFull, acc[g], 0);
    if (lane == g) mine = v;
  }
  return mine;
}

// part[k * grid + cta] = the sum over this CTA's warps, in warp order, of
// warp_part[k] for k in [k0, k1).
__device__ __forceinline__ void write_partials(float (*warp_part)[kWarps], float* part, int k0,
                                               int k1) {
  __syncthreads();
  const int k = k0 + static_cast<int>(threadIdx.x);
  if (k < k1) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_part[k][w];
    part[k * gridDim.x + blockIdx.x] = s;
  }
}

// The sum over CTAs of partial k, by one warp: lanes over CTAs, then a shuffle
// tree, one fixed order, so every warp of every CTA gets the same bits; the
// total lands in lane 0.
__device__ __forceinline__ float sum_part(const float* part, int k, int lane) {
  float t = 0.f;
  for (int c = lane; c < static_cast<int>(gridDim.x); c += 32) t += part[k * gridDim.x + c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(kFull, t, off);
  return t;
}

// P1 at x, rows over the warps of the grid: res = A x - b and the partial of
// ||res||^2; for "logreg" res = sigmoid(A x) - b and the partial of
// (b - 1) A x - softplus(-A x); for "cubic" res = H x and the partials of
// ||x||^2 and x (H x) + 2 q x. With kBreg and a res_prev ("ls" only) also the
// partial of ||res - res_prev||^2; without kBreg (K2) that code is not compiled.
// The objectives branch outside the row loops (uniform over the grid). Writes
// slots kP1F.. of part; every thread of the CTA calls it.
template <typename T, int VA, bool kBreg>
__device__ __forceinline__ void phase_res(const Problem& p, const float* x, float* res,
                                          const float* res_prev,
                                          float (*warp_part)[kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gwarp = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  const long long m = p.m, n = p.n;
  const T* __restrict__ a = static_cast<const T*>(p.a);
  if (p.obj == kCubic) {
    float nx2 = 0.f, obj = 0.f;
    for (long long r = gwarp; r < m; r += nwarps) {
      const float d = warp_dot<T, VA>(a + r * n, x, n, lane);
      if (lane == 0) {
        const float xr = x[r];
        res[r] = d;
        nx2 += xr * xr;
        obj += xr * d + 2.f * (p.b[r] * xr);
      }
    }
    if (lane == 0) {
      warp_part[kP1F][warp] = nx2;
      warp_part[kP1Obj][warp] = obj;
    }
    write_partials(warp_part, p.part, kP1F, kP1Obj + 1);
    return;
  }
  float f = 0.f, breg = 0.f;
  for (long long r = gwarp; r < m; r += nwarps) {
    const float d = warp_dot<T, VA>(a + r * n, x, n, lane);
    if (lane == 0) {
      if (p.obj == kLogreg) {
        const float br = p.b[r];
        res[r] = 1.f / (1.f + expf(-d)) - br;
        // softplus(-z) = logaddexp(0, -z), written stably
        const float softplus_neg = nan_max(-d, 0.f) + log1pf(expf(-fabsf(d)));
        f += (br - 1.f) * d - softplus_neg;
      } else {
        const float rr = d - p.b[r];
        res[r] = rr;
        f += rr * rr;
        if (kBreg && res_prev) {
          const float dr = rr - res_prev[r];
          breg += dr * dr;
        }
      }
    }
  }
  if (lane == 0) {
    warp_part[kP1F][warp] = f;
    if (kBreg && res_prev) warp_part[kP1Breg][warp] = breg;
  }
  write_partials(warp_part, p.part, kP1F, kBreg && res_prev ? kP1Breg + 1 : kP1F + 1);
}

// The gradient loop over this CTA's coordinates j: body(j, grad_j) in lane 0,
// grad at the point x of the last P1 (whose residual is res): (A^T res)_j, one
// warp a row of A^T; for "cubic" (H x)_j + q_j + (||x|| c / 2) x_j from res = H x,
// elementwise, with ||x|| from P1's kP1F partials (every warp sums them in one
// order: the same bits everywhere; no phase between P1 and this loop may
// overwrite that slot).
template <typename T, int VT, typename Body>
__device__ __forceinline__ void for_each_grad(const Problem& p, const float* x, const float* res,
                                              Body&& body) {
  const int lane = threadIdx.x & 31;
  const long long gwarp = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  const long long m = p.m, n = p.n;
  if (p.obj == kCubic) {
    const float coef = sqrtf(sum_part(p.part, kP1F, lane)) * p.cube_c / 2.f;
    for (long long j = gwarp; j < n; j += nwarps) {
      if (lane == 0) body(j, (res[j] + p.b[j]) + coef * x[j]);
    }
  } else {
    const T* __restrict__ at = static_cast<const T*>(p.at);
    for (long long j = gwarp; j < n; j += nwarps) {
      const float g = warp_dot<T, VT>(at + j * m, res, m, lane);
      if (lane == 0) body(j, g);
    }
  }
}

// pick_<kernel>: the instantiation for (storage, A-row vector width, A^T-row
// vector width), or null for a combination that does not exist.
#define ADAPROX_PICK(KERNEL)                                                               \
  const void* pick_##KERNEL(int a_is_bf16, int va, int vt) {                             \
    if (a_is_bf16) {                                                                       \
      if (va == 1 && vt == 1) return reinterpret_cast<const void*>(&KERNEL<__nv_bfloat16, 1, 1>); \
      if (va == 1 && vt == 8) return reinterpret_cast<const void*>(&KERNEL<__nv_bfloat16, 1, 8>); \
      if (va == 8 && vt == 1) return reinterpret_cast<const void*>(&KERNEL<__nv_bfloat16, 8, 1>); \
      if (va == 8 && vt == 8) return reinterpret_cast<const void*>(&KERNEL<__nv_bfloat16, 8, 8>); \
    } else {                                                                               \
      if (va == 1 && vt == 1) return reinterpret_cast<const void*>(&KERNEL<float, 1, 1>);  \
      if (va == 1 && vt == 4) return reinterpret_cast<const void*>(&KERNEL<float, 1, 4>);  \
      if (va == 4 && vt == 1) return reinterpret_cast<const void*>(&KERNEL<float, 4, 1>);  \
      if (va == 4 && vt == 4) return reinterpret_cast<const void*>(&KERNEL<float, 4, 4>);  \
    }                                                                                      \
    return nullptr;                                                                        \
  }

// Launch kernel cooperatively over the grid every whole-solve kernel uses for
// this shape: one CTA per SM, fewer when there are fewer rows than warps to
// spread them over; part holds `parts` partials a CTA. Returns the cudaError_t
// (cudaErrorNotSupported: no cooperative launch here).
cudaError_t launch(const void* kernel, Problem& prob, void* second, int parts, long long part_len,
                   void* stream_ptr) {
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
  const long long rows = prob.m > prob.n ? prob.m : prob.n;
  const long long want = (rows + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(want < sms ? want : sms);
  if (static_cast<long long>(parts) * grid > part_len) return cudaErrorInvalidValue;
  void* args[] = {&prob, second};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool problem_ok(int obj_kind, long long m, long long n, int maxit, int prox_kind) {
  return (obj_kind == kLs || obj_kind == kLogreg || (obj_kind == kCubic && m == n)) &&
         m >= 1 && n >= 1 && maxit >= 0 && prox_kind >= kL1 && prox_kind <= kZero;
}

}  // namespace
