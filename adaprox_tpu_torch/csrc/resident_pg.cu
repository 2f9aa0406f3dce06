// K2 for Hopper: a whole proximal-gradient solve of 0.5 ||A x - b||^2 + g(x) in
// one cooperative kernel launch.
//
// Replaces the Pallas TPU kernel adaprox_tpu/ops/resident.py::resident_adapgm
// (bodies _kernel / _kernel_rec, core _solve_core) for obj_kind "ls" without
// momentum: step-size rules fixed / Malitsky-Mishchenko / AdaPGM, prox l1 / box /
// elastic / zero, optional per-iteration records. A is stored as f32 or bf16;
// every iterate, reduction and scalar is f32.
//
// What bounds it on the card. The data-sheet bound is the arithmetic: A is read
// from device memory once (16.8 MB at 4096x1024 f32, 5 us at 3.35 TB/s), while
// each iteration does 4 m n flops (0.25 us at 4096x1024 on 67 TFLOP/s of f32
// outside the tensor cores). In practice two things hold it back: each
// iteration streams A and its transpose from L2 (2 m n itemsize bytes, 33.5 MB
// at 4096x1024 f32), and it waits at three grid-wide barriers.
//
// Design (first, simple version):
//   * On the TPU, A sat in one core's VMEM. Here A and A^T (both layouts, as in
//     the TPU kernel, so both matvecs are the same warp-per-row dot product)
//     stay in global memory; at the reference size both fit the 50 MB L2, so
//     after the first iteration every pass reads L2. The vectors live in global
//     memory too, so any shape runs, including ones whose x or residual would
//     not fit a CTA's shared memory.
//   * One persistent cooperative launch, at most one CTA per SM. An iteration is
//     three phases with a grid sync after each:
//       P1  res = A x - b, rows over the warps of the grid; each CTA writes its
//           partial of ||res||^2;
//       P2  grad = A^T res, rows of A^T (columns j) over the warps; for its j the
//           CTA writes partials of ||primal||^2, ||dg||^2, <dg, dx>, ||dx||^2,
//           sum |x| and sum x^2;
//       P3  every CTA sums all partials in the same fixed order and computes the
//           rule's step, the stop test and (CTA 0) the record row; then each CTA
//           writes v and x_new = prox(v) for its share of j.
//     The warm-up of _solve_core is one P1/P2 before the loop.
//   * Every CTA computes the scalars itself from the same partials in the same
//     order, so all CTAs reach bit-identical stop decisions: no CTA leaves the
//     loop while another waits at a barrier. No atomics anywhere: two launches on
//     the same inputs give the same bits.
//   * IEEE semantics are part of the algorithm: AdaPGM divides by sqrt(0) on
//     purpose and min() drops the inf; 0/0 is guarded to 0; MM guards
//     isfinite(g0). So no fast math, no flush to zero, IEEE division and
//     square root, NaN-propagating min/max like jnp.minimum/maximum. The build
//     also passes -fmad=false, so each elementwise expression rounds after every
//     operation as the plain PyTorch version does; the dot products use explicit
//     fmaf.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum Prox { kL1 = 0, kBox = 1, kElastic = 2, kZero = 3 };
enum Rule { kFixed = 0, kMM = 1, kAdaPGM = 2 };
// Per-CTA partial sums: part[k * grid + cta].
enum Part { kRes2 = 0, kPrimal2, kDg2, kDgDx, kDx2, kAbsX, kX2, kParts };

struct Params {
  const void* a;   // (m, n) row-major, f32 or bf16
  const void* at;  // (n, m) row-major: the same values transposed
  const float* b;  // (m,)
  float* xs;       // (2, n): x and x_prev by parity; row 1 holds x0 on entry
  float* gs;       // (2, n): grad and grad_prev by parity
  float* v;        // (n,)
  float* res;      // (m,)
  float* part;     // (kParts, grid)
  float* x_out;    // (n,)
  float* stats;    // (4,): numit, norm_res, gamma, converged
  float* hist;     // (3, maxit): gamma, norm_res, objective rows; null unless record
  long long m, n;
  int maxit;
  float gamma0, tol, p1, p2;
  int prox, rule, record;
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

// One step-size update, resident.py::_rule_adapgm / _rule_mm / _rule_fixed, on
// the carry (gamma, g1, g0).
__device__ void rule_update(int rule, float ndg2, float dgdx, float ndx2, float& gamma,
                            float& g1, float& g0) {
  if (rule == kAdaPGM) {
    float dd = g1 * (g1 * ndg2 - dgdx) / ndx2;
    if (isnan(dd)) dd = 0.f;
    const float denom = nan_max(dd + sqrtf(dd * dd), 0.f);
    const float step = nan_min(g1 * sqrtf(1.f + g1 / g0), g1 / sqrtf(2.f * denom));
    g0 = g1;
    g1 = step;
    gamma = step;
  } else if (rule == kMM) {
    const float lip = sqrtf(ndg2) / sqrtf(ndx2);
    const float growth = isfinite(g0) ? sqrtf(1.f + g0) * g1 : f32_inf();
    const float step = isnan(lip) ? growth : nan_min(growth, 1.f / (2.f * lip));
    g0 = step / g1;
    g1 = step;
    gamma = step;
  } else {
    gamma = g1;
  }
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

template <typename T, int VA, int VT>
__global__ void __launch_bounds__(kThreads, 1) resident_pg_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float warp_part[kParts][kWarps];
  __shared__ float s_gamma;
  __shared__ int s_go, s_conv, s_numit;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gwarp = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * kThreads;
  const long long m = p.m, n = p.n;
  const T* __restrict__ a = static_cast<const T*>(p.a);
  const T* __restrict__ at = static_cast<const T*>(p.at);

  // P1: res = A x - b; this CTA's partial of ||res||^2.
  auto phase_res = [&](const float* x) {
    float f = 0.f;
    for (long long r = gwarp; r < m; r += nwarps) {
      const float s = warp_dot<T, VA>(a + r * n, x, n, lane);
      if (lane == 0) {
        const float rr = s - p.b[r];
        p.res[r] = rr;
        f += rr * rr;
      }
    }
    if (lane == 0) warp_part[kRes2][warp] = f;
    write_partials(warp_part, p.part, kRes2, kRes2 + 1);
  };

  // The carry of _solve_core. Thread 0 of every CTA holds (it, g1, g0, norm_res)
  // and computes the same values; every thread holds gamma.
  float gamma = p.gamma0, g1 = p.gamma0;
  float g0 = p.rule == kMM ? f32_inf() : p.gamma0;
  float norm_res = f32_inf();
  int it = 0;
  int par = 0;  // x = xs[par], x_prev = xs[1 - par], grad_prev = gs[1 - par]

  // warm-up (_solve_core :224-226): grad0 at x0, v = x0 - gamma0 grad0,
  // x = prox(v); x_prev = x0 stays in xs[1], grad_prev = grad0 goes to gs[1]
  phase_res(p.xs + n);
  grid.sync();
  for (long long j = gwarp; j < n; j += nwarps) {
    const float g = warp_dot<T, VT>(at + j * m, p.res, m, lane);
    if (lane == 0) {
      p.gs[n + j] = g;
      const float vj = p.xs[n + j] - p.gamma0 * g;
      p.v[j] = vj;
      p.xs[j] = prox(p.prox, vj, p.gamma0, p.p1, p.p2);
    }
  }
  grid.sync();

  bool go = 0 < p.maxit && norm_res > p.tol;
  bool conv = norm_res <= p.tol;
  if (!go) {
    for (long long j = gtid; j < n; j += nthreads) p.x_out[j] = p.xs[j];
  }
  while (go) {
    const float* x = p.xs + par * n;
    const float* x_prev = p.xs + (1 - par) * n;
    float* grad = p.gs + par * n;
    const float* grad_prev = p.gs + (1 - par) * n;

    // P1
    phase_res(x);
    grid.sync();

    // P2: grad = A^T res, and the partials over this CTA's columns
    float acc[kParts] = {};
    for (long long j = gwarp; j < n; j += nwarps) {
      const float g = warp_dot<T, VT>(at + j * m, p.res, m, lane);
      if (lane == 0) {
        grad[j] = g;
        const float xj = x[j];
        const float primal = (p.v[j] - xj) / gamma + g;
        const float dg = g - grad_prev[j];
        const float dx = xj - x_prev[j];
        acc[kPrimal2] += primal * primal;
        acc[kDg2] += dg * dg;
        acc[kDgDx] += dg * dx;
        acc[kDx2] += dx * dx;
        acc[kAbsX] += fabsf(xj);
        acc[kX2] += xj * xj;
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = kPrimal2; k < kParts; ++k) warp_part[k][warp] = acc[k];
    }
    write_partials(warp_part, p.part, kPrimal2, kParts);
    grid.sync();

    // P3: every CTA sums every partial in the same order (lanes over CTAs, then
    // a shuffle tree), and thread 0 steps the carry
    if (warp == 0) {
      float sum[kParts];
#pragma unroll
      for (int k = 0; k < kParts; ++k) {
        float s = 0.f;
        for (int c = lane; c < static_cast<int>(gridDim.x); c += 32) s += p.part[k * gridDim.x + c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
        sum[k] = s;
      }
      if (lane == 0) {
        norm_res = sqrtf(sum[kPrimal2]);
        rule_update(p.rule, sum[kDg2], sum[kDgDx], sum[kDx2], gamma, g1, g0);
        if (p.record && blockIdx.x == 0) {
          // objective at the current x, gamma the step just updated (:297-306)
          float gval = 0.f;
          if (p.prox == kL1) {
            gval = p.p1 * sum[kAbsX];
          } else if (p.prox == kElastic) {
            gval = p.p1 * sum[kAbsX] + 0.5f * p.p2 * sum[kX2];
          }
          p.hist[it] = gamma;
          p.hist[p.maxit + it] = norm_res;
          p.hist[2LL * p.maxit + it] = 0.5f * sum[kRes2] + gval;
        }
        ++it;
        s_gamma = gamma;
        s_go = it < p.maxit && norm_res > p.tol;  // a NaN residual stops
        s_conv = norm_res <= p.tol;
      }
    }
    __syncthreads();
    gamma = s_gamma;
    go = s_go != 0;
    conv = s_conv != 0;
    float* x_new = p.xs + (1 - par) * n;
    for (long long j = gtid; j < n; j += nthreads) {
      const float xj = x[j];
      const float vj = xj - gamma * grad[j];
      p.v[j] = vj;
      const float xn = prox(p.prox, vj, gamma, p.p1, p.p2);
      x_new[j] = xn;
      // converged: the iterate at the check, not the extra prox step (:360-363)
      if (!go) p.x_out[j] = conv ? xj : xn;
    }
    if (go) grid.sync();
    par ^= 1;
  }

  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) {
      p.stats[0] = static_cast<float>(it);
      p.stats[1] = norm_res;
      p.stats[2] = gamma;
      p.stats[3] = conv ? 1.f : 0.f;
    }
    if (p.record) {
      // records are zero past numit; thread 0's it is the numit of every CTA
      if (threadIdx.x == 0) s_numit = it;
      __syncthreads();
      for (int i = s_numit + threadIdx.x; i < p.maxit; i += kThreads) {
        p.hist[i] = 0.f;
        p.hist[p.maxit + i] = 0.f;
        p.hist[2LL * p.maxit + i] = 0.f;
      }
    }
  }
}

// The instantiation for (storage, A-row vector width, A^T-row vector width),
// or null for a combination that does not exist.
const void* select_kernel(int a_is_bf16, int va, int vt) {
  if (a_is_bf16) {
    if (va == 1 && vt == 1) return reinterpret_cast<const void*>(&resident_pg_kernel<__nv_bfloat16, 1, 1>);
    if (va == 1 && vt == 8) return reinterpret_cast<const void*>(&resident_pg_kernel<__nv_bfloat16, 1, 8>);
    if (va == 8 && vt == 1) return reinterpret_cast<const void*>(&resident_pg_kernel<__nv_bfloat16, 8, 1>);
    if (va == 8 && vt == 8) return reinterpret_cast<const void*>(&resident_pg_kernel<__nv_bfloat16, 8, 8>);
  } else {
    if (va == 1 && vt == 1) return reinterpret_cast<const void*>(&resident_pg_kernel<float, 1, 1>);
    if (va == 1 && vt == 4) return reinterpret_cast<const void*>(&resident_pg_kernel<float, 1, 4>);
    if (va == 4 && vt == 1) return reinterpret_cast<const void*>(&resident_pg_kernel<float, 4, 1>);
    if (va == 4 && vt == 4) return reinterpret_cast<const void*>(&resident_pg_kernel<float, 4, 4>);
  }
  return nullptr;
}

// The most CTAs the current device runs at once for this instantiation, at most
// one per SM; 0 with an error code when it cannot launch cooperatively.
cudaError_t max_grid(const void* kernel, int* out) {
  *out = 0;
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
  *out = sms;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Partials per CTA: part needs kParts floats for each CTA of the grid.
int adaprox_resident_pg_parts() { return kParts; }

// One whole solve. a (m, n) and at (n, m) in f32 (a_is_bf16 = 0) or bf16;
// va / vt: 1, or 4 (f32) / 8 (bf16) when n / m is a multiple of it and the rows
// are 16-byte aligned. xs (2, n) with x0 in row 1, gs (2, n), v (n), res (m),
// part (part_len >= kParts * SMs), x_out (n), stats (4) and, when record, hist
// (3, maxit; null when maxit is 0): f32 device buffers the caller owns. prox:
// 0 l1, 1 box, 2 elastic, 3 zero; rule: 0 fixed, 1 mm, 2 adapgm. The grid is one
// CTA per SM, fewer when there are fewer rows than warps to spread them over.
// Returns the cudaError_t of the launch (0 on success; cudaErrorNotSupported:
// no cooperative launch on this device).
int adaprox_resident_pg(const void* a, const void* at, int a_is_bf16, int va, int vt,
                        const float* b, float* xs, float* gs, float* v, float* res,
                        float* part, long long part_len, float* x_out, float* stats,
                        float* hist, long long m, long long n, int maxit, float gamma0,
                        float tol, float p1, float p2, int prox_kind, int rule_kind,
                        int record, void* stream_ptr) {
  const void* kernel = select_kernel(a_is_bf16, va, vt);
  if (kernel == nullptr || m < 1 || n < 1 || maxit < 0 || prox_kind < kL1 ||
      prox_kind > kZero || rule_kind < kFixed || rule_kind > kAdaPGM ||
      (record && maxit > 0 && !hist)) {
    return cudaErrorInvalidValue;
  }
  int most = 0;
  const cudaError_t err = max_grid(kernel, &most);
  if (err != cudaSuccess) return err;
  const long long rows = m > n ? m : n;
  const long long want = (rows + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(want < most ? want : most);
  if (static_cast<long long>(kParts) * grid > part_len) return cudaErrorInvalidValue;
  Params params{a,  at,   b,      xs, gs,     v,   res, part, x_out, stats, hist,
                m,  n,    maxit,  gamma0, tol, p1,  p2,  prox_kind, rule_kind, record};
  void* args[] = {&params};
  const cudaError_t launch = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream_ptr));
  if (launch != cudaSuccess) return launch;
  return cudaGetLastError();
}

const char* adaprox_resident_pg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
