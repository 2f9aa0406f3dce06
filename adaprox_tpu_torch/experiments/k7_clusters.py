"""Measures the layout choices of K7a and K7b (``csrc/resident_f0_grid.cu``) on one card: the
largest cluster the launcher may pick (``kMaxCluster`` in ``csrc/resident_f0_cores.cuh``: 8 as
built, against 16) and what a cluster barrier costs. Prints the card's name and power limit,
then one line of JSON.

    python -m adaprox_tpu_torch.experiments.k7_clusters [--reps 2]

Each build runs the whole set ``--reps`` times, in turns (8, 16, 16, 8 at 2); every number
is the best of its turns. For each largest cluster size ("8", "16"), by CUDA events, one call
each:
  sweeps_ms   the f = 0 drivers' 12 ``--resident`` sweeps: square_root_lasso (h l2) and
              least_absolute_deviation (h l1) on housing_scale, abalone and cpusmall_scale
              (``square_root_lasso.resident_inputs``, lam 10), MP and AdaPDM+, the 15
              couplings, tol 1e-5, maxit 5000, record
  grids_ms    the 4 ``--resident-grid`` grids (the three stand-ins at their common 8192x128)
  it_us       the one-cell iteration (t 1, tol -1, 1000 iterations, record) at 512x128,
              4224x128 and 8192x128 f32 and 8192x128 bf16, h l1, MP and AdaPDM+
  layout      each shape's cluster size, the clusters that run at once for 15 cells, the
              rows a CTA holds of those it owns
and barrier_cycles: the clock64 cycles of one ``cg::this_cluster().sync()`` and one
``__syncthreads()``, from a kernel that runs 10000 of each on one cluster of 1, 2, 4, 8 or
16 CTAs of 512 threads (CTA 0's count).

The 16 build is a copy of ``csrc/`` with kMaxCluster 16 and the non-portable cluster size
allowed, built under ``adaprox_tpu_torch/_build/``; where it picks another C its bits differ
from the 8 build's (each build's sweeps, grids and single launches agree among themselves).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess

import torch

from ..convert import sqrt_lasso_from_numpy
from ..ops import kernels, resident_f0
from . import square_root_lasso

BARRIER_SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

// mode 0: cluster barriers, 1: block barriers; CTA 0's clock64 cycles over iters of them
__global__ void barriers(int iters, int mode, long long* out) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if (mode == 0) {
      cl.sync();
    } else {
      __syncthreads();
    }
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = t1 - t0;
}

// out: a host pointer; the kernel writes a device copy
extern "C" int adaprox_k7_barriers(int cluster, int mode, int iters, long long* out) {
  long long* dev_out = nullptr;
  cudaError_t err = cudaMalloc(&dev_out, sizeof(long long));
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    cudaFuncSetAttribute(barriers, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = cluster;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(512);
  cfg.attrs = la;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, barriers, iters, mode, dev_out);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpy(out, dev_out, sizeof(long long), cudaMemcpyDeviceToHost);
  cudaFree(dev_out);
  return err;
}
"""
BARRIER_ITERS = 10000
# the 16 build: the largest cluster raised and the non-portable size allowed before the
# occupancy is asked
CMAX16_EDITS = {
    "resident_f0_cores.cuh": [("constexpr int kMaxCluster = 8;",
                               "constexpr int kMaxCluster = 16;")],
    "resident_f0_grid.cu": [("  int clusters = 0;\n  err = cudaOccupancyMaxActiveClusters(",
                             "  int clusters = 0;\n  cudaFuncSetAttribute(kernel, "
                             "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
                             "  err = cudaOccupancyMaxActiveClusters(")]}
SHAPES = {"512x128": "housing_scale", "4224x128": "abalone", "8192x128": "cpusmall_scale"}
SWEEPS = {"mp": resident_f0.resident_mpls_sweep, "adapdmp": resident_f0.resident_adapdmp_sweep}
GRIDS = {"mp": resident_f0.resident_mpls_grid, "adapdmp": resident_f0.resident_adapdmp_grid}


def cmax16_source():
    """The grid source of the 16 build: a copy of csrc/ with CMAX16_EDITS."""
    src = kernels._PKG / "csrc"
    dst = kernels.BUILD_DIR / "k7_cmax16" / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for name, edits in CMAX16_EDITS.items():
        text = (dst / name).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"k7_clusters: {name} no longer holds {old!r}")
            text = text.replace(old, new)
        (dst / name).write_text(text)
    return dst / "resident_f0_grid.cu"


def ms_of(fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def inputs(name, dev, dtype=torch.float32):
    x, y, _ = square_root_lasso.load(name)
    _, _, h, a_op, norm_a = sqrt_lasso_from_numpy(x, y, 10.0, "l2", device=dev,
                                                  dtype=torch.float32)
    a, bv = square_root_lasso.resident_inputs(a_op.a, -h.b)
    return a.to(dtype), bv, norm_a


def one_build(dev):
    """The sweeps, grids, iterations and layouts of the build resident_f0.GRID_SOURCE names."""
    ts = square_root_lasso.T_VALUES
    out = {"sweeps_ms": {}, "grids_ms": {}, "it_us": {}, "layout": {}}
    for shape, name in SHAPES.items():
        a, bv, norm_a = inputs(name, dev)
        SWEEPS["mp"](a, bv, 10.0, ts, 1.0, 1e-5, 1)  # the plan of this shape, asked once
        for h_kind in ("l2", "l1"):
            for core, sweep in SWEEPS.items():
                p2 = 1.0 if core == "mp" else norm_a
                ms, _ = ms_of(lambda: sweep(a, bv, 10.0, ts, p2, 1e-5, 5000, record=True,
                                            h_kind=h_kind))
                out["sweeps_ms"][f"{name} {h_kind} {core}"] = ms
        for dtype in ((torch.float32, torch.bfloat16) if shape == "8192x128"
                      else (torch.float32,)):
            a_t = a.to(dtype)
            key = f"{shape} {str(dtype).removeprefix('torch.')}"
            plan = resident_f0.f0_grid_plan(a_t, "mp", len(ts))
            out["layout"][key] = [plan["cluster"], plan["clusters"], plan["rows_held"],
                                  plan["rows_per_cta"]]
            for core, sweep in SWEEPS.items():
                p2 = 1.0 if core == "mp" else norm_a
                sweep(a_t, bv, 10.0, [1.0], p2, -1.0, 10, record=True, h_kind="l1")
                ms, _ = ms_of(lambda: sweep(a_t, bv, 10.0, [1.0], p2, -1.0, 1000, record=True,
                                            h_kind="l1"))
                out["it_us"][f"{key} l1 {core}"] = ms
    _, a, bv, norms, _ = square_root_lasso.grid_inputs(list(SHAPES.values())[::-1], device=dev,
                                                       dtype=torch.float32)
    for h_kind in ("l2", "l1"):
        for core, grid in GRIDS.items():
            p2s = [1.0] * 3 if core == "mp" else norms
            ms, _ = ms_of(lambda: grid(a, bv, [10.0] * 3, ts, p2s, 1e-5, 5000, record=True,
                                       h_kind=h_kind))
            out["grids_ms"][f"{h_kind} {core}"] = ms
    return out


def best(a, b):
    """The smaller of each timing of two runs of one build (the layouts are the same)."""
    if a is None:
        return b
    return {k: ({kk: min(v, b[k][kk]) for kk, v in a[k].items()} if k != "layout" else a[k])
            for k in a}


def barrier_cycles():
    path = kernels.BUILD_DIR / "k7_barriers.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(BARRIER_SOURCE)
    lib = ctypes.CDLL(str(kernels.build_library(path)))
    lib.adaprox_k7_barriers.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_longlong)]
    out = {}
    for cluster in (1, 2, 4, 8, 16):
        for mode, what in ((0, "cluster"), (1, "block")):
            cycles = ctypes.c_longlong(0)
            err = lib.adaprox_k7_barriers(cluster, mode, BARRIER_ITERS, ctypes.byref(cycles))
            if err:
                raise RuntimeError(f"k7_clusters: the barrier kernel failed (CUDA error {err})")
            out[f"{what} C {cluster}"] = cycles.value / BARRIER_ITERS
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k7_clusters measures on a CUDA device and none is available")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sources = {"8": resident_f0.GRID_SOURCE, "16": cmax16_source()}
    order = ["8", "16", "16", "8"] * ((args.reps + 1) // 2)
    runs = {"8": None, "16": None}
    try:
        for build in order[:2 * args.reps]:
            resident_f0.GRID_SOURCE = sources[build]
            resident_f0._grid_library()  # built (or found built) before anything is timed
            runs[build] = best(runs[build], one_build(dev))
    finally:
        resident_f0.GRID_SOURCE = sources["8"]
    result = {"device": torch.cuda.get_device_name(0), "cluster_max": runs,
              "barrier_cycles": barrier_cycles()}
    for build, run in runs.items():
        result[f"sweeps_ms_total_{build}"] = sum(run["sweeps_ms"].values())
        result[f"grids_ms_total_{build}"] = sum(run["grids_ms"].values())
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
