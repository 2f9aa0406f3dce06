"""Measures K1, the fused least-squares oracle (``csrc/fused_ls.cu``), of this tree against
another checkout's, on one card. Prints the card's name and power limit, then one line of JSON.

    python -m adaprox_tpu_torch.experiments.k1_design --against DIR [--reps 2]

DIR is the root of another checkout of this repository (e.g. the parent commit unpacked with
``git archive``). Each tree's ``csrc/fused_ls.cu`` is built (nvcc, under this tree's
``adaprox_tpu_torch/_build/``) and bound with its own entry: the earlier two-pass kernel's
(``adaprox_fused_ls`` with a grid, beside ``adaprox_fused_ls_rows_per_step``) or this tree's
(``adaprox_fused_ls`` with ``k1_plan``'s numbers), beside a third, "serial" (below). The builds
run in turns (other, this, serial, serial, this, other at 2 reps); each time is the best of a
build's turns:

  k1_ms       K1 at 16384^2 f32 and bf16, 4000x1024 f32 (the lasso driver's padded A) and
              1000x300 f32: CUDA events with the host's time hidden
              (``utils.profiling.flushed_ms``), warm (back to back) and cold (a 256 MiB buffer
              written and read between calls), and eager (20 calls back to back, the host's
              time included), ms a call
  max_abs_err each build's largest |grad - plain grad| (f and grad also within 1e-5 of the
              plain version's, relative, or the run fails)
  headline    AdaPGM, 200 iterations at 16384^2 f32, ``LeastSquares(fused=True)``: iterations/s
              (best of 5 solves; beside it ``fused=False``'s, two torch.mv an oracle call), the
              card's busy ms an iteration and its idle share (the union
              of the kernels' spans in a ``torch.profiler`` trace of 50 more iterations), each
              tree in its own subprocess with the tree as its working directory (so each
              imports its own package), in turns (other, this, this, other) x reps
  serial      a third build of this tree, its sum over slots launched after the first kernel
              instead of as a programmatic dependent launch (SERIAL_EDITS): k1_ms and
              max_abs_err beside the other two
  this_kernels_us  this tree's K1 at each shape by kernel (``torch.profiler``'s device time, µs a
              call): the first kernel (rows or ring) and the sum over slots
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import kernels
from ..utils.profiling import flushed_ms

SHAPES = (("16384x16384 f32", 16384, 16384, torch.float32),
          ("16384x16384 bf16", 16384, 16384, torch.bfloat16),
          ("4000x1024 f32", 4000, 1024, torch.float32),
          ("1000x300 f32", 1000, 300, torch.float32))
RTOL = 1e-5  # chip_smoke.py's KERNEL_RTOL
HEADLINE_CODE = """
import json, math, torch
import adaprox_tpu_torch as apt
from adaprox_tpu_torch.utils.profiling import timed
dev = torch.device("cuda")
gen = torch.Generator(device=dev)
gen.manual_seed(0)
N = 16384
a = torch.randn(N, N, generator=gen, device=dev) / math.sqrt(N)
b = torch.randn(N, generator=gen, device=dev)
x0 = torch.zeros(N, device=dev)
def solve(f, maxit=200):
    return apt.adaptive_proxgrad(x0, f=f, g=apt.L1Norm(0.01), rule=apt.AdaPGMRule(gamma=1e-3),
                                 tol=0.0, maxit=maxit)
two = apt.LeastSquares(a, b, fused=False)
f = apt.LeastSquares(a, b, fused=True)
secs_two, _ = timed(lambda: solve(two), reps=5)
secs, res = timed(lambda: solve(f), reps=5)
assert res.numit == 200 and math.isfinite(float(res.norm_res))
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    solve(f, 50)
    torch.cuda.synchronize()
spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
               if str(e.device_type).endswith("CUDA") and e.time_range.end > e.time_range.start)
busy, reach = 0.0, float("-inf")  # the union of the kernels' spans on the card, us
for start, end in spans:
    if end > reach:
        busy += end - max(start, reach)
        reach = end
window = spans[-1][1] - spans[0][0] if spans else float("nan")
print(json.dumps({"iters_per_s": 200 / secs, "two_matmul_iters_per_s": 200 / secs_two,
                  "norm_res": float(res.norm_res),
                  "device_busy_ms_per_iter": busy / 1e3 / 50,
                  "idle_share": 1.0 - busy / window if spans else float("nan")}))
"""

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def grid_launch(source):
    """The earlier two-pass K1 at ``source``: a persistent grid of one CTA an SM over blocks of
    rows, its partials summed by a second kernel."""
    lib = kernels.load_library(source, kernels.NVCC_FLAGS, {
        "adaprox_fused_ls": ([_P, _I, _I, _P, _P, _LL, _LL, _I, _P, _P, _P, _P, _P], _I),
        "adaprox_fused_ls_rows_per_step": ([_I], _I)})

    def launch(a, b, x):
        m, n = a.shape
        bf16 = a.dtype == torch.bfloat16
        vec = 8 if bf16 else 4
        if n % vec or a.data_ptr() % 16 or x.data_ptr() % 16:
            vec = 1
        grid = kernels._grid(m, lib.adaprox_fused_ls_rows_per_step(int(bf16)), a.device)
        f32 = dict(dtype=torch.float32, device=a.device)
        f_part, g_part = torch.empty(grid, **f32), torch.empty((grid, n), **f32)
        f, grad = torch.empty((), **f32), torch.empty(n, **f32)
        err = lib.adaprox_fused_ls(a.data_ptr(), int(bf16), vec, b.data_ptr(), x.data_ptr(), m,
                                   n, grid, f_part.data_ptr(), g_part.data_ptr(), f.data_ptr(),
                                   grad.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K1 (grid) launch failed: CUDA error {err}")
        return f, grad

    return launch


# The "serial" build: this tree's csrc/ with the sum over slots launched as a plain kernel after
# the first, not as a programmatic dependent launch (griddepcontrol is then a no-op).
SERIAL_EDITS = [("  cfg.numAttrs = 1;\n  const int parts",
                 "  cfg.numAttrs = 0;\n  const int parts")]


def serial_launch():
    """This tree's K1 built from a copy of csrc/ with SERIAL_EDITS, under _build/."""
    dst = kernels.BUILD_DIR / "k1_serial" / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(kernels.SOURCE.parent, dst)
    text = (dst / kernels.SOURCE.name).read_text()
    for old, new in SERIAL_EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"k1_design: {kernels.SOURCE.name} no longer holds {old!r}")
        text = text.replace(old, new)
    (dst / kernels.SOURCE.name).write_text(text)
    lib = kernels._library(dst / kernels.SOURCE.name)

    def launch(a, b, x):
        plan = kernels.k1_plan(*a.shape, a.element_size(), kernels._sm_count(a.device.index))
        return kernels._k1_launch(a, b, x, plan, lib=lib)

    return launch


def launcher(root):
    """The K1 launch of the checkout at ``root``, bound by the entry its source has."""
    source = Path(root).resolve() / "adaprox_tpu_torch" / "csrc" / "fused_ls.cu"
    if source == kernels.SOURCE.resolve():
        return kernels.fused_ls_value_grad
    if "adaprox_fused_ls_rows_per_step" in source.read_text():
        return grid_launch(source)
    raise RuntimeError(f"k1_design: {source} has neither K1 entry this script binds")


def inputs(m, n, dtype, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a = torch.randn(m, n, generator=gen, device=dev) / math.sqrt(n)
    b = torch.randn(m, generator=gen, device=dev)
    x = torch.randn(n, generator=gen, device=dev)
    return a.to(dtype), b, x


def eager_ms(fn, a, b, x, calls=20):
    """ms a call of ``calls`` back-to-back calls by CUDA events, the host's time included (the
    engine's case where the host does not run ahead)."""
    fn(a, b, x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn(a, b, x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def breakdown(fn, calls=20):
    """Device µs a call of each kernel ``fn`` launches (``torch.profiler``, CUPTI), by name;
    empty where the profiler sees no device time."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0))
        name = re.search(r"ls_\w+_kernel", ev.key)
        if dev_us > 0 and name:
            out[name.group(0)] = out.get(name.group(0), 0.0) + dev_us / calls
    return out


def headline(root):
    """AdaPGM's iterations/s at 16384^2 f32 fused, in a subprocess importing ``root``'s package."""
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", HEADLINE_CODE], cwd=root, env=env,
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"k1_design: the headline in {root} failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", required=True,
                        help="the root of another checkout whose K1 is run beside this tree's")
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k1_design measures on a CUDA device and none is available")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    roots = {"other": Path(args.against).resolve(), "this": kernels._PKG.parent}
    launches = {build: launcher(root) for build, root in roots.items()}
    launches["serial"] = serial_launch()
    builds = list(launches)
    order = ((builds + builds[::-1]) * args.reps)[:len(builds) * args.reps]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ms = {build: {} for build in builds}
    errs = {build: {} for build in builds}
    plans, kernels_us = {}, {}
    for name, m, n, dtype in SHAPES:
        a, b, x = inputs(m, n, dtype, dev)
        f_p, g_p = kernels.ls_value_grad_plain(a, b, x)
        plans[name] = kernels.k1_plan(m, n, a.element_size(), sms)
        for build in order:
            fn = launches[build]
            f, g = fn(a, b, x)
            torch.cuda.synchronize()
            err_f = abs(float(f - f_p)) / abs(float(f_p))
            err_g = float((g - g_p).abs().max())
            if not (err_f <= RTOL and err_g <= RTOL * float(g_p.abs().max())):
                raise RuntimeError(f"k1_design: {build} K1 at {name} disagrees with plain "
                                   f"(f {err_f:.2e}, grad {err_g:.2e})")
            errs[build][name] = err_g
            now = {"warm": flushed_ms(lambda: fn(a, b, x), flush_bytes=0),
                   "cold": flushed_ms(lambda: fn(a, b, x)), "eager": eager_ms(fn, a, b, x)}
            old = ms[build].get(name, now)
            ms[build][name] = {k: min(v, old[k]) for k, v in now.items()}
        kernels_us[name] = breakdown(lambda: kernels.fused_ls_value_grad(a, b, x))
        del a, b, x, f_p, g_p
        torch.cuda.empty_cache()
    heads = {build: [] for build in roots}
    for build in ((["other", "this", "this", "other"]) * args.reps):
        heads[build].append(headline(roots[build]))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi, "k1_ms": ms,
                      "max_abs_err": errs, "headline": heads, "plans": plans,
                      "this_kernels_us": kernels_us,
                      "against": str(roots["other"])}), flush=True)


if __name__ == "__main__":
    main()
