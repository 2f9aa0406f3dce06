"""Measures the dual-SVM sweep kernels on one card: K6b and K6c (the AdaPDM and Malitsky-Pock
cores of ``csrc/resident_dsvm_grid.cu``) with the largest cluster the launcher may pick
(``kMaxCluster`` in ``csrc/resident_dsvm_cores.cuh``: 8 as built, against 16), and K6d
(``csrc/resident_pd.cu``) of this tree against another checkout's. Prints the card's name and
power limit, then one line of JSON.

    python -m adaprox_tpu_torch.experiments.k6_clusters [--reps 2] [--k6d-against DIR]

Each build runs the whole set ``--reps`` times, in turns (8, 16, 16, 8 at 2); every time is the
best of its turns, by CUDA events, one call each, on the dual_svm driver's inputs
(``dual_svm.resident_inputs`` of heart_scale, svmguide3 and mushrooms, f32):
  sweeps_ms   the driver's 12 K6b and 12 K6c ``--resident`` sweeps (the 12 couplings, tol 1e-5,
              maxit 10000, record; K6c with the exact Bregman form) at C 0.1 and 1
  it_us       the one-row iteration (t 0.5, tol -1, 1000 iterations, record), K6b and K6c (per
              iteration, at its trials), f32 and bf16 storage
  layout      each shape's cluster size, the clusters that run at once for 12 rows, the rows a
              CTA holds of those it owns
The 16 build is a copy of ``csrc/`` with kMaxCluster 16 and the non-portable cluster size
allowed, built under ``adaprox_tpu_torch/_build/``; where it picks another C its bits differ
from the 8 build's.

With ``--k6d-against DIR`` (the root of another checkout of this repository, e.g. the parent
commit unpacked with ``git archive``) it also runs K6d from DIR's ``csrc/resident_pd.cu`` and
from this tree's, in turns (other, this, this, other at 2), on the driver's six (dataset, C)
inputs (tol 1e-5, maxit 10000, record): ``k6d_same_bits`` says, dense and factored apart,
whether every output of the two builds is equal bit for bit (``k6d_factored_vs_other``: the
factored calls' numits and largest relative differences of the histories and of x),
``k6d_ms`` gives each build's best time a case, ``k6d_it_us`` its iteration at the three
shapes (C 0.1, tol -1, 1000 iterations, no record). ``--k6d-only`` stops there:

    python -m adaprox_tpu_torch.experiments.k6_clusters --k6d-against DIR --k6d-only
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..ops import kernels, resident_mp, resident_pd
from . import dual_svm

CMAX16_EDITS = {
    "resident_dsvm_cores.cuh": [("constexpr int kMaxCluster = 8;",
                                 "constexpr int kMaxCluster = 16;")],
    "resident_dsvm_grid.cu": [("    err = cudaOccupancyMaxActiveClusters(",
                               "    cudaFuncSetAttribute(kernel, "
                               "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
                               "    err = cudaOccupancyMaxActiveClusters(")]}
DATASETS = ("heart_scale", "svmguide3", "mushrooms")
SWEEPS = {"K6b": lambda q, lab, big_c, ts, na, tol, maxit, **kw:
          resident_pd.resident_adapdm_dsvm_sweep(q, lab, big_c, ts, na, tol, maxit, **kw),
          "K6c": lambda q, lab, big_c, ts, na, tol, maxit, **kw:
          resident_mp.resident_mp_dsvm_sweep(q, lab, big_c, ts, 1.0 / na, tol, maxit,
                                             exact_bregman=True, **kw)}


def cmax16_source():
    """The grid source of the 16 build: a copy of csrc/ with CMAX16_EDITS."""
    src = kernels._PKG / "csrc"
    dst = kernels.BUILD_DIR / "k6_cmax16" / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for name, edits in CMAX16_EDITS.items():
        text = (dst / name).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"k6_clusters: {name} no longer holds {old!r}")
            text = text.replace(old, new)
        (dst / name).write_text(text)
    return dst / "resident_dsvm_grid.cu"


def ms_of(fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def inputs(name, dev):
    x, y, _ = dual_svm.load(name)
    q, lab, factored = dual_svm.resident_inputs(y[:, None] * x, y, torch.float32, dev)
    return q, lab, factored, len(y), float(np.linalg.norm(y))


def one_build(dev):
    """The sweeps, iterations and layouts of the build resident_pd.GRID_SOURCE names."""
    ts = dual_svm.T_VALUES
    out = {"sweeps_ms": {}, "it_us": {}, "layout": {}}
    for name in DATASETS:
        q, lab, factored, n, na = inputs(name, dev)
        for kernel, sweep in SWEEPS.items():
            sweep(q, lab, 0.1, ts, na, 1e-5, 1, n_true=n, factored=factored)  # built, planned
            for big_c in (0.1, 1.0):
                ms, _ = ms_of(lambda: sweep(q, lab, big_c, ts, na, 1e-5, 10000, n_true=n,
                                            factored=factored, record=True))
                out["sweeps_ms"][f"{name} C {big_c:g} {kernel}"] = ms
        for dtype in (torch.float32, torch.bfloat16):
            q_t = q.to(dtype)
            key = f"{name} {str(dtype).removeprefix('torch.')}"
            plan = resident_pd.dsvm_grid_plan(q_t, "adapdm", len(ts), factored=factored)
            out["layout"][key] = [plan["cluster"], plan["clusters"], plan["rows_held"],
                                  plan["rows_per_cta"]]
            for kernel, sweep in SWEEPS.items():
                sweep(q_t, lab, 0.1, [0.5], na, -1.0, 10, n_true=n, factored=factored)
                ms, res = ms_of(lambda: sweep(q_t, lab, 0.1, [0.5], na, -1.0, 1000, n_true=n,
                                              factored=factored, record=True))
                if int(res[1][0]) != 1000:
                    raise RuntimeError(f"k6_clusters: {key} {kernel} ran {int(res[1][0])} of "
                                       "1000 iterations")
                out["it_us"][f"{key} {kernel}"] = ms
                if kernel == "K6c":
                    out["it_us"][f"{key} K6c trials"] = float(res[5][3].float().mean())
    return out


def best(a, b):
    """The smaller of each timing of two runs of one build (the layouts are the same)."""
    if a is None:
        return b
    return {k: ({kk: min(v, b[k][kk]) if "trials" not in kk else v for kk, v in a[k].items()}
                if k != "layout" else a[k]) for k in a}


def k6d_cv(lib, q, lab, big_c, gamma, sigma, tol, maxit, n, factored, record):
    """One K6d launch from ``lib`` (``resident_pd._launch``): x, stats and, with ``record``,
    the histories cut to maxit, as one list of tensors."""
    x, stats, hist = resident_pd._launch("K6d", q, lab, n, big_c, factored, maxit, record, gamma,
                                         sigma, tol, lib=lib)
    return [x[0], stats[0]] + ([hist[0, :, :maxit]] if record else [])


def k6d_ab(other_root, dev, reps):
    """K6d from other_root's csrc/resident_pd.cu and from this tree's, in turns: the driver's six
    calls (ms, and whether each build's outputs equal the other's bit for bit, dense and
    factored apart; factored, the largest relative difference of the histories and of x), and
    the tol -1, 1000-iteration solve at the three shapes (us an iteration)."""
    other = Path(other_root).resolve() / "adaprox_tpu_torch" / "csrc" / "resident_pd.cu"
    libs = {"other": kernels.load_library(other, resident_pd.NVCC_FLAGS,
                                          resident_pd.CV_SIGNATURES),
            "this": resident_pd._library()}
    cases, iters = [], []
    for name in DATASETS:
        q, lab, factored, n, na = inputs(name, dev)
        x, y, _ = dual_svm.load(name)
        gamma, sigma = dual_svm.cv_steps(float(np.linalg.norm((y[:, None] * x).T
                                                              @ (y[:, None] * x))), na)
        for big_c in (0.1, 1.0):
            cases.append((f"{name} C {big_c:g}", factored,
                          (q, lab, big_c, gamma, sigma, 1e-5, 10000, n, factored, True)))
        shape = f"{'B' if factored else 'Q'} {q.shape[0]}x{q.shape[1]}"
        iters.append((shape, (q, lab, 0.1, gamma, sigma, -1.0, 1000, n, factored, False)))
    ms = {"other": {}, "this": {}}
    it_us = {"other": {}, "this": {}}
    outs = {"other": {}, "this": {}}
    order = ["other", "this", "this", "other"] * ((reps + 1) // 2)
    for build in order[:2 * reps]:
        lib = libs[build]
        for key, _, args in cases:
            t, flat = ms_of(lambda: k6d_cv(lib, *args))
            ms[build][key] = min(t, ms[build].get(key, t))
            if key in outs[build] and not all(torch.equal(u, w)
                                              for u, w in zip(flat, outs[build][key])):
                raise RuntimeError(f"k6_clusters: K6d {key} differs between two calls")
            outs[build][key] = flat
        for shape, args in iters:
            t, flat = ms_of(lambda: k6d_cv(lib, *args))
            if int(flat[1][0]) != 1000:
                raise RuntimeError(f"k6_clusters: K6d {shape} ran {int(flat[1][0])} of 1000")
            it_us[build][shape] = min(t, it_us[build].get(shape, t))
    same = {"dense": True, "factored": True}
    factored_rel = {}
    for key, factored, _ in cases:
        a, b = outs["this"][key], outs["other"][key]
        kind = "factored" if factored else "dense"
        same[kind] = same[kind] and all(torch.equal(u, w) for u, w in zip(a, b))
        if factored:
            hist_rel = float(((a[2] - b[2]).abs().amax(-1) / b[2].abs().amax(-1)).max())
            x_rel = float((a[0] - b[0]).abs().max() / b[0].abs().max())
            factored_rel[key] = {"numit": [int(a[1][0]), int(b[1][0])], "hist_rel": hist_rel,
                                 "x_rel": x_rel}
    return {"k6d_same_bits": same, "k6d_factored_vs_other": factored_rel, "k6d_ms": ms,
            "k6d_ms_total": {b: sum(v.values()) for b, v in ms.items()},
            "k6d_it_us": it_us}  # ms for 1000 iterations: us an iteration


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=2)
    parser.add_argument("--k6d-against", default=None,
                        help="the root of another checkout whose K6d is run beside this tree's")
    parser.add_argument("--k6d-only", action="store_true",
                        help="with --k6d-against: run only the K6d comparison")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k6_clusters measures on a CUDA device and none is available")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    result = {"device": torch.cuda.get_device_name(0)}
    if args.k6d_against:
        result.update(k6d_ab(args.k6d_against, dev, args.reps))
        if args.k6d_only:
            print(json.dumps(result), flush=True)
            return
    sources = {"8": resident_pd.GRID_SOURCE, "16": cmax16_source()}
    order = ["8", "16", "16", "8"] * ((args.reps + 1) // 2)
    runs = {"8": None, "16": None}
    try:
        for build in order[:2 * args.reps]:
            resident_pd.GRID_SOURCE = sources[build]
            resident_pd._grid_library()  # built (or found built) before anything is timed
            runs[build] = best(runs[build], one_build(dev))
    finally:
        resident_pd.GRID_SOURCE = sources["8"]
    result["cluster_max"] = runs
    for build, run in runs.items():
        for kernel in SWEEPS:
            result[f"{kernel}_sweeps_ms_total_{build}"] = sum(
                v for k, v in run["sweeps_ms"].items() if k.endswith(kernel))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
