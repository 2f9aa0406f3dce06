"""Measures K2c, the rule sweep (``csrc/resident_pg.cu``), of this tree against another
checkout's, on one card. Prints the card's name and power limit, then one line of JSON.

    python -m adaprox_tpu_torch.experiments.k2c_lockstep --against DIR [--reps 2]

DIR is the root of another checkout of this repository (e.g. the parent commit unpacked with
``git archive``). Each tree's ``csrc/resident_pg.cu`` is built (nvcc, under this tree's
``adaprox_tpu_torch/_build/``) and bound with its own K2c entry: the rows-in-turn kernel's
(``adaprox_resident_pg_sweep`` over one row's scratch) or this tree's lockstep one
(``ops.resident.k2c_plan``'s scratch: K2's once for each row of a group); K2 and K2b are bound
alike in both. The builds run in turns (other, this, this, other at 2 reps); each time is the best
of a build's turns, each turn the best of 3 calls after a warm-up (CUDA events,
``utils.profiling.timed``; the wrapper's host work included, as the drivers call it):

  sweeps      each driver's K2c call on the driver's own inputs: ``ms`` by build, ``numit`` (each
              row's), ``rows_are_k2`` (this tree's every row equals this tree's K2 launch with
              its arguments, bit for bit: x, numit, norm_res, converged and the histories) and
              ``same_bits`` (both trees' sweeps give the same bits). The
              calls: lasso (random_lasso(4000, 1000, 10) padded to 4000x1024 f32, the four menu
              rows, tol 1e-7, maxit 2000), nesterov_worst_case (the c = 0 cubic model at 128^2,
              four rows, tol 1e-6, maxit 10000), sparse_logreg on a5a, mushrooms and phishing
              ([X 1] padded, five rows, tol 1e-7, maxit 2000, histories 20000) and
              cubic_sparse_logreg on the same (H padded to 128, three rows, tol 1e-7, maxit 100,
              histories 1000); each dataset its synthetic stand-in where the file is absent
  iter_us     a sweep's lockstep iteration: R rows, tol -1, 1000 iterations, zero prox, the
              sweep's ms / 1000, by build: "fixed" rows (the fixed rule at steps 1, 0.95, ...
              of 1/||A||^2: 3 grid syncs an iteration) at R = 1, 4, 8 and "momentum 4" (two
              fixed rows, two momentum rows: 4 syncs), at 4096x1024 f32 (the resident
              reference size's A) and 8x2176 (the sync floor: one CTA an SM, each warp a dot
              of 8); "fixed 4" and "momentum 4" at 128^2 (the cubic model of a random PSD H,
              c = 1). The adaptive rules are left out: at tol -1 they run into a NaN on these
              problems (at 8x2176 MM and AdaPGM stopped at 271 and 231 iterations). Beside
              them ``k2_it_us``: K2's one-row iteration (fixed rule, no records) at each shape
  k2, k2b     K2's solve at the resident reference size (random_lasso(4000, 1000, 10) padded to
              4096x1024, AdaPGM, lam 1, tol 1e-4) and K2b's bench batch (16 lambdas
              geomspace(0.05, 5) over that one A, tol 0, maxit 300): ``ms`` by build, the ratio
              this / other, and whether both builds give the same bits
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..models.synthetic import random_lasso
from ..ops import kernels, resident
from ..utils.profiling import timed
from .common import pad_tiles

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# obj_kind .. part_len, the leading arguments of every entry of csrc/resident_pg.cu
_PROBLEM = [_I, _F, _F, _F, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _LL]
DATASETS = ("a5a", "mushrooms", "phishing")
ITERS = 1000
BATCH_LAMS = np.geomspace(0.05, 5.0, 16)


def _rows_in_turn_library(source):
    """The rows-in-turn build at ``source``: K2, K2b, and its K2c entry over one row's
    scratch."""
    return kernels.load_library(source, resident.NVCC_FLAGS, {
        "adaprox_resident_pg_parts": ([], _I),
        "adaprox_resident_pg": (_PROBLEM + [_P, _P, _P, _LL, _LL, _I, _F, _F, _F, _F, _I, _I, _I,
                                            _I, _P], _I),
        "adaprox_resident_pg_sweep": (_PROBLEM + [_P, _P, _I, _P, _P, _P, _LL, _LL, _I, _F, _F,
                                                  _I, _P], _I),
        "adaprox_resident_pg_batch": (_PROBLEM + [_LL, _LL, _P, _I, _P, _P, _LL, _LL, _I, _I,
                                                  _I, _I, _P], _I),
        "adaprox_resident_pg_error_string": ([_I], ctypes.c_char_p)})


def _rows_in_turn_sweep(lib):
    def sweep(a, b, x0, rows, maxit, prox_kind, p1, p2, obj_kind, m_true, cube_c):
        dev = a.device
        m, n = a.shape
        with torch.cuda.device(dev):
            args, keep = resident._problem(lib.adaprox_resident_pg_parts(), a, b, x0, obj_kind,
                                           m_true, cube_c, "K2c")
            rows_f, rows_i, x_out, stats, hist = resident._sweep_buffers(rows, maxit, n, dev)
            err = lib.adaprox_resident_pg_sweep(
                *args, rows_f.data_ptr(), rows_i.data_ptr(), rows.shape[0], x_out.data_ptr(),
                stats.data_ptr(), hist.data_ptr() if maxit else None, m, n, maxit, float(p1),
                float(p2), resident._PROX_IDX[prox_kind],
                torch.cuda.current_stream(dev).cuda_stream)
        resident._raise_on(lib, err, "K2c (rows in turn) launch")
        return resident._sweep_result(x_out, stats, hist)

    return sweep


def launchers(root):
    """(sweep, k2, k2b) of the checkout at ``root``, each taking the arguments of
    ``resident._launch_sweep``, ``resident._launch`` and ``resident._launch_batch``."""
    source = Path(root).resolve() / "adaprox_tpu_torch" / "csrc" / "resident_pg.cu"
    if "adaprox_resident_pg_group" in source.read_text():
        lib = resident._library(source)

        def sweep(*args, **kw):
            return resident._launch_sweep(*args, lib=lib, **kw)
    else:
        lib = _rows_in_turn_library(source)
        sweep = _rows_in_turn_sweep(lib)

    def k2(*args):
        return resident._launch(*args, lib=lib)

    def k2b(*args):
        return resident._launch_batch(*args, lib=lib)

    return sweep, k2, k2b


def _case(name, a, b, specs, maxit, **kw):
    kw = dict(dict(prox_kind="l1", p1=0.0, p2=0.0, obj_kind="ls", m_true=None, cube_c=0.0), **kw)
    rows = resident._sweep_rows(resident.rule_rows(specs), maxit, torch.float32)
    return dict(name=name, a=a, b=b, x0=torch.zeros(a.shape[1], device=a.device), rows=rows,
                maxit=maxit, kw=kw)


def driver_cases(dev):
    """Each driver's K2c call, as its ``--resident`` run makes it (module docstring)."""
    from ..utils.datasets import load_or_synthesize
    from . import cubic_sparse_logreg as cubic
    from . import nesterov_worst_case as worst
    from . import sparse_logreg as slr
    from .lasso import RESIDENT_ROWS as LASSO_ROWS

    f32 = dict(dtype=torch.float32, device=dev)
    prob = random_lasso(m=4000, n=1000, pfactor=10, seed=0, lam=1.0)
    a, b = pad_tiles(torch.as_tensor(prob.a, **f32), torch.as_tensor(prob.b, **f32))
    gam = 1.0 / float(np.linalg.norm(prob.a, 2) ** 2)
    cases = [_case("lasso 4000x1024", a, b,
                   [(gam, rule, mom, 1e-7, 2000) for _, rule, mom in LASSO_ROWS], 2000,
                   p1=prob.lam)]
    h, q = worst.worst_case_model(100, 100, 100.0, dev, torch.float32)
    cases.append(_case("nesterov_worst_case 128x128", h, q,
                       [(0.01, rule, mom, 1e-6, 10000) for _, rule, mom in worst.RESIDENT_ROWS],
                       10000, prox_kind="zero", obj_kind="cubic"))
    for ds in DATASETS:
        x_np, y_np, _ = load_or_synthesize(ds, labels=(0.0, 1.0))
        m = x_np.shape[0]
        x = torch.as_tensor(x_np, device=dev).to(torch.float32)
        y = torch.as_tensor(y_np, device=dev).to(torch.float32)
        a, b = pad_tiles(torch.cat([x, torch.ones((m, 1), **f32)], 1), y)
        gam = 1.0 / slr.lipschitz_estimate(x_np)
        cases.append(_case(f"sparse_logreg {ds} {a.shape[0]}x{a.shape[1]}", a, b,
                           slr.rule_specs(gam, 1e-7, 2000), 20000, p1=0.01, obj_kind="logreg",
                           m_true=float(m)))
    for ds in DATASETS:
        x_np, y_np, _ = load_or_synthesize(ds, labels=(0.0, 1.0))
        n = x_np.shape[1] + 1
        h_np, q_np = cubic.logistic_loss_grad_hessian(x_np, y_np, np.zeros(n))
        f = cubic.cubic_from_numpy(h_np, q_np, 1.0, device=dev, dtype=torch.float32)
        gam = cubic.secant_gamma(f, np.zeros(n), 0, dev, torch.float32)
        h, q = cubic.padded_model(h_np, q_np, dev, torch.float32)
        cases.append(_case(f"cubic_sparse_logreg {ds} {h.shape[0]}x{h.shape[1]}", h, q,
                           cubic.rule_specs(gam, 1e-7, 100), 1000, prox_kind="zero",
                           obj_kind="cubic", cube_c=1.0))
    return cases


def reference_lasso(dev):
    """random_lasso(4000, 1000, 10) zero-padded to 4096x1024 f32, and 1/||A||^2."""
    prob = random_lasso(m=4000, n=1000, pfactor=10, seed=0)
    a = torch.zeros(4096, 1024, device=dev)
    a[:4000, :1000] = torch.as_tensor(prob.a, dtype=torch.float32, device=dev)
    b = torch.zeros(4096, device=dev)
    b[:4000] = torch.as_tensor(prob.b, dtype=torch.float32, device=dev)
    return a, b, 1.0 / float(np.linalg.norm(prob.a, 2) ** 2)


def iteration_cases(dev):
    """(shape name, case) of the lockstep iteration (module docstring), and K2's one-row
    iteration at each shape as (a, b, gamma0, kw)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a_ref, b_ref, gam_ref = reference_lasso(dev)
    a8 = torch.randn(8, 2176, generator=gen, device=dev) / 2176
    b8 = torch.randn(8, generator=gen, device=dev)
    g = torch.randn(128, 128, generator=gen, device=dev) / 128 ** 0.5
    h = g @ g.t()
    q = torch.randn(128, generator=gen, device=dev)
    shapes = {"4096x1024": (a_ref, b_ref, gam_ref, dict(prox_kind="zero")),
              "8x2176": (a8, b8, 1.0 / float((a8 * a8).sum()), dict(prox_kind="zero")),
              "128x128 cubic": (h, q, 1.0 / (float(torch.linalg.matrix_norm(h, 2)) + 1.0),
                                dict(prox_kind="zero", obj_kind="cubic", cube_c=1.0))}
    cases = []
    for shape, (a, b, gam, kw) in shapes.items():
        tables = {f"fixed {r}": [(gam * (1 - 0.05 * j), "fixed", False, -1.0, ITERS)
                                 for j in range(r)] for r in (1, 4, 8)}
        tables["momentum 4"] = [(gam * (1 - 0.05 * (j // 2)), "fixed", j % 2 == 1, -1.0, ITERS)
                                for j in range(4)]
        for label, specs in tables.items():
            if shape.endswith("cubic") and label in ("fixed 1", "fixed 8"):
                continue
            cases.append(_case(f"{shape} {label}", a, b, specs, ITERS, **kw))
    return cases, shapes


def _sweep_args(case):
    kw = case["kw"]
    return (case["a"], case["b"], case["x0"], case["rows"], case["maxit"], kw["prox_kind"],
            kw["p1"], kw["p2"], kw["obj_kind"], kw["m_true"], kw["cube_c"])


def _flat(out):
    return [*out[:4], *out[4]]


def _same_bits(u, w):
    return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)
               for x, y in zip(_flat(u), _flat(w)))


def rows_are_k2(case, out, k2):
    """Whether every row of the sweep ``out`` equals ``k2``'s launch with its arguments."""
    kw = case["kw"]
    for j, (g0, rule, mom, tol, cap) in enumerate(case["rows"].tolist()):
        cap = int(cap)
        one = k2(case["a"], case["b"], case["x0"], g0, tol, cap, kw["prox_kind"], kw["p1"],
                 kw["p2"], resident._RULE_OF_IDX[int(rule)], mom > 0, True, kw["obj_kind"],
                 kw["m_true"], kw["cube_c"])
        row = (out[0][j], out[1][j], out[2][j], out[3][j], tuple(h[j][:cap] for h in out[4]))
        if not _same_bits(row, one[:4] + (one[4:],)):
            return False
        if any(bool(h[j][cap:].any()) for h in out[4]):
            return False
    return True


def measure(builds, dev, reps):
    """Times every build's launchers in turns; ``builds`` maps a name to (sweep, k2, k2b),
    and must hold "this" (for the bit checks) and "other"."""
    names = list(builds)
    order = ((names + names[::-1]) * reps)[:len(names) * reps]
    cases = driver_cases(dev)
    it_cases, it_shapes = iteration_cases(dev)
    out = {"sweeps": {}, "iter_us": {}, "k2_it_us": {}, "k2": {}, "k2b": {}}

    def best(fn):
        return 1e3 * timed(fn, reps=3)[0]

    for case in cases + it_cases:
        args = _sweep_args(case)
        ms, results = {}, {}
        for name in order:
            sweep = builds[name][0]
            t = best(lambda: sweep(*args))
            ms[name] = min(ms.get(name, t), t)
            results[name] = sweep(*args)
        torch.cuda.synchronize()
        this = results["this"]
        numit = this[1].tolist()
        if case in it_cases:
            if min(numit) != ITERS:
                raise RuntimeError(f"k2c_lockstep: {case['name']}: numit {numit}")
            out["iter_us"][case["name"]] = {k: v * 1e3 / ITERS for k, v in ms.items()}
            continue
        out["sweeps"][case["name"]] = dict(
            ms=ms, numit=numit, rows_are_k2=rows_are_k2(case, this, builds["this"][1]),
            same_bits=all(_same_bits(results[name], this) for name in names))
    for shape, (a, b, gam, kw) in it_shapes.items():
        x0 = torch.zeros(a.shape[1], device=dev)
        k2_args = (a, b, x0, gam, -1.0, ITERS, kw["prox_kind"], 0.0, 0.0, "fixed", False, False,
                   kw.get("obj_kind", "ls"), None, kw.get("cube_c", 0.0))
        us = {}
        for name in order:
            t = best(lambda: builds[name][1](*k2_args)) * 1e3 / ITERS
            us[name] = min(us.get(name, t), t)
        out["k2_it_us"][shape] = us
    a, b, gam = reference_lasso(dev)
    x0 = torch.zeros(1024, device=dev)
    k2_args = (a, b, x0, gam, 1e-4, 4000, "l1", 1.0, 0.0, "adapgm", False, False, "ls", None, 0.0)
    shared = a.expand(len(BATCH_LAMS), *a.shape)
    bb = b.expand(len(BATCH_LAMS), a.shape[0]).contiguous()
    xb = torch.zeros(len(BATCH_LAMS), a.shape[1], device=dev)
    scal = resident._check_batch(shared, bb, xb, torch.tensor(
        [[gam, 0.0, lam, 0.0] for lam in BATCH_LAMS]), "l1", "adapgm", "ls")
    k2b_args = (shared, bb, xb, scal, 300, "l1", "adapgm", False, "ls", None)
    for key, index, args in (("k2", 1, k2_args), ("k2b", 2, k2b_args)):
        ms, results = {}, {}
        for name in order:
            fn = builds[name][index]
            t = best(lambda: fn(*args))
            ms[name] = min(ms.get(name, t), t)
            results[name] = fn(*args)
        torch.cuda.synchronize()
        same = all(all(torch.equal(u, w) for u, w in zip(results[name], results["this"]))
                   for name in names)
        out[key] = dict(ms=ms, this_over_other=ms["this"] / ms["other"], same_bits=same)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", required=True,
                        help="the root of another checkout whose K2c is run beside this tree's")
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k2c_lockstep measures on a CUDA device and none is available")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    builds = {"other": launchers(args.against), "this": launchers(kernels._PKG.parent)}
    out = measure(builds, dev, args.reps)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                      "against": str(Path(args.against).resolve()), **out}), flush=True)


if __name__ == "__main__":
    main()
