"""Measures K4 and K4b, the backtracking solve and sweep (``csrc/resident_bt.cu``), of this
tree against another checkout's, on one card. Prints the card's name and power limit, then one
line of JSON.

    python -m adaprox_tpu_torch.experiments.k4b_lockstep --against DIR [--reps 2]

DIR is the root of another checkout of this repository (e.g. the parent commit unpacked with
``git archive``). Each tree's ``csrc/resident_bt.cu`` is built (nvcc, under this tree's
``adaprox_tpu_torch/_build/``) and bound with its own entries: the rows-in-turn build's (two grid
syncs a trial, K4's scratch once, no sync count) or this tree's (one sync a trial, the rows in
lockstep groups, ``ops.resident_bt.k4b_plan``'s scratch). The builds run in turns (other, this,
this, other at 2 reps); each time is the best of a build's turns, each turn the best of 3 calls
after a warm-up (CUDA events, ``utils.profiling.timed``; the wrapper's host work included, as the
drivers call it):

  sweeps   each driver's K4b call on the driver's own inputs (f32): ``ms`` by build, each row's
           ``numit`` and trials, ``same_bits`` (both trees give the same x, stats and histories),
           ``rows_are_k4`` (this tree's every row equals this tree's K4 launch with its arguments,
           bit for bit), ``syncs`` by build (this tree's as the kernel counted them, held equal
           to ``k4b_syncs`` of the records: ``syncs_match``; the other's from its design: two a
           trial, PG one and Nesterov three after each iteration it goes on from, two of warm-up a
           row, one between two rows, for every objective) and ``us_per_sync``. The calls: lasso
           (random_lasso(4000, 1000, 10) padded to 4000x1024, the four backtracking rows, l1 1,
           tol 1e-7, maxit 2000), sparse_logreg on a5a, mushrooms and phishing ([X 1] padded, l1
           0.01, tol 1e-7, maxit 1000), cubic_sparse_logreg on the same (H padded to 128, tol
           1e-7, maxit 100) and nesterov_worst_case (the c = 0 cubic model at 128^2, PG and
           Nesterov from gamma0 1, tol 1e-6, maxit 10000); each dataset its synthetic stand-in
           where the file is absent
  bits     the same calls with A in bf16, and the lasso's with the exact-Bregman test: whether
           both trees give the same bits (one call each, not timed)
  k4       K4's solve at the resident reference size (random_lasso(4000, 1000, 10) padded to
           4096x1024, PG xi 1.5, l1 1, tol 1e-4, maxit 4000): ``ms`` by build, numit, trials,
           ``same_bits`` (record mode)
  iter_us  K4's one-trial iteration (zero prox, gamma 1e-3 / ||A||_F^2 so every first trial
           passes, tol -1, 1000 iterations: ms / 1000) at 4096x1024 (the reference A) and
           8x2176 (a full grid with almost no work: the sync floor), PG and Nesterov, by build,
           with ``same_bits`` and the syncs; beside them ``one_row_k4b``: this tree's K4b launched
           over the one row (the lockstep kernel's one-row launch, against K4's own kernel)
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
from ..ops import kernels, resident, resident_bt
from ..utils.profiling import timed
from .common import BT_ROWS, bt_sweep_rows, pad_tiles
from .k2c_lockstep import reference_lasso

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# obj_kind .. part_len, the leading arguments of both entries
_PROBLEM = [_I, _F, _F, _F, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _LL]
DATASETS = ("a5a", "mushrooms", "phishing")
ITERS = 1000


def _rows_in_turn_library(source):
    """The rows-in-turn build at ``source``: K4 and K4b over K4's scratch, no sync count."""
    return kernels.load_library(source, resident_bt.NVCC_FLAGS, {
        "adaprox_resident_bt_parts": ([], _I),
        "adaprox_resident_bt": (_PROBLEM + [_P, _P, _P, _LL, _LL, _I, _F, _F, _F, _F, _F, _F, _I,
                                            _I, _I, _I, _P], _I),
        "adaprox_resident_bt_sweep": (_PROBLEM + [_P, _I, _P, _P, _P, _LL, _LL, _I, _F, _F, _F,
                                                  _F, _I, _I, _P], _I),
        "adaprox_resident_bt_error_string": ([_I], ctypes.c_char_p)})


def _rows_in_turn(lib):
    def k4(a, b, x0, gamma0, tol, maxit, xi, shrink, prox_kind, p1, p2, cube_c, nesterov,
           obj_kind, m_true, record, exact_bregman):
        dev, n = a.device, a.shape[1]
        with torch.cuda.device(dev):
            args, keep = resident._problem(lib.adaprox_resident_bt_parts(), a, b, x0, obj_kind,
                                           m_true, cube_c, "K4", res_bufs=2)
            f32 = dict(dtype=torch.float32, device=dev)
            x_out, stats = torch.empty(n, **f32), torch.empty(5, **f32)
            hist = torch.empty((4, maxit), **f32) if record else None
            err = lib.adaprox_resident_bt(
                *args, x_out.data_ptr(), stats.data_ptr(),
                hist.data_ptr() if record and maxit else None, *a.shape, maxit, float(gamma0),
                1.0 if nesterov else float(xi), float(shrink), float(tol), float(p1), float(p2),
                resident._PROX_IDX[prox_kind], int(bool(nesterov)), int(bool(exact_bregman)),
                int(record), torch.cuda.current_stream(dev).cuda_stream)
        resident_bt._raise_on(lib.adaprox_resident_bt_error_string, err, "K4 (rows in turn)")
        base = (x_out, stats[0].to(torch.int32), stats[1], stats[3] > 0, stats[4] > 0)
        return base + tuple(hist) if record else base

    def sweep(a, b, x0, rows, tol, maxit, shrink, prox_kind, p1, p2, cube_c, obj_kind, m_true,
              exact_bregman):
        dev, n = a.device, a.shape[1]
        count = rows.shape[0]
        with torch.cuda.device(dev):
            args, keep = resident._problem(lib.adaprox_resident_bt_parts(), a, b, x0, obj_kind,
                                           m_true, cube_c, "K4b", res_bufs=2)
            f32 = dict(dtype=torch.float32, device=dev)
            rows_d = rows.to(**f32).contiguous()
            x_out, stats = torch.empty((count, n), **f32), torch.empty((count, 5), **f32)
            hist = torch.empty((count, 4, maxit), **f32)
            err = lib.adaprox_resident_bt_sweep(
                *args, rows_d.data_ptr(), count, x_out.data_ptr(), stats.data_ptr(),
                hist.data_ptr() if maxit else None, *a.shape, maxit, float(shrink), float(tol),
                float(p1), float(p2), resident._PROX_IDX[prox_kind], int(bool(exact_bregman)),
                torch.cuda.current_stream(dev).cuda_stream)
        resident_bt._raise_on(lib.adaprox_resident_bt_error_string, err, "K4b (rows in turn)")
        return (x_out, stats[:, 0].to(torch.int32), stats[:, 1], stats[:, 3] > 0,
                stats[:, 4] > 0, tuple(hist[:, k] for k in range(4)))

    return k4, sweep


def launchers(root):
    """(k4, sweep, lockstep) of the checkout at ``root``: K4 and K4b taking the arguments of
    ``resident_bt._launch`` and ``resident_bt._launch_sweep``, and whether the build counts its
    grid syncs (the lockstep design)."""
    source = Path(root).resolve() / "adaprox_tpu_torch" / "csrc" / "resident_bt.cu"
    if "adaprox_resident_bt_plan" not in source.read_text():
        return (*_rows_in_turn(_rows_in_turn_library(source)), False)
    lib = resident_bt._library(source)

    def k4(*args):
        return resident_bt._launch(*args, lib=lib)

    def sweep(*args):
        return resident_bt._launch_sweep(*args, lib=lib)

    return k4, sweep, True


def rows_in_turn_syncs(numits, trials, nesterovs):
    """The grid syncs of the rows-in-turn design: per row two of warm-up, two a trial, and
    after each iteration it goes on from PG one and Nesterov three; one between two rows."""
    return len(numits) - 1 + sum(
        2 + 2 * sum(int(t) for t in tr[:int(k)]) + max(int(k) - 1, 0) * (3 if nest else 1)
        for k, tr, nest in zip(numits, trials, nesterovs))


def _case(name, a, b, rows, tol, maxit, **kw):
    kw = dict(dict(shrink=0.5, prox_kind="l1", p1=0.0, p2=0.0, cube_c=0.0, obj_kind="ls",
                   m_true=None, exact_bregman=False), **kw)
    return dict(name=name, a=a, b=b, x0=torch.zeros(a.shape[1], device=a.device),
                rows=torch.as_tensor(rows, dtype=torch.float32), tol=tol, maxit=maxit, kw=kw)


def driver_cases(dev):
    """Each driver's K4b call, as its ``--resident`` run makes it (module docstring)."""
    from ..utils.datasets import load_or_synthesize
    from . import cubic_sparse_logreg as cubic
    from . import nesterov_worst_case as worst
    from .sparse_logreg import lipschitz_estimate

    f32 = dict(dtype=torch.float32, device=dev)
    prob = random_lasso(m=4000, n=1000, pfactor=10, seed=0)
    a, b = pad_tiles(torch.as_tensor(prob.a, **f32), torch.as_tensor(prob.b, **f32))
    gam = 1.0 / float(np.linalg.norm(prob.a, 2) ** 2)
    cases = [_case("lasso 4000x1024", a, b, bt_sweep_rows(BT_ROWS, gam), 1e-7, 2000,
                   p1=prob.lam)]
    for ds in DATASETS:
        x_np, y_np, _ = load_or_synthesize(ds, labels=(0.0, 1.0))
        m = x_np.shape[0]
        x = torch.as_tensor(x_np, device=dev).to(torch.float32)
        y = torch.as_tensor(y_np, device=dev).to(torch.float32)
        a, b = pad_tiles(torch.cat([x, torch.ones((m, 1), **f32)], 1), y)
        cases.append(_case(f"sparse_logreg {ds} {a.shape[0]}x{a.shape[1]}", a, b,
                           bt_sweep_rows(BT_ROWS, 1.0 / lipschitz_estimate(x_np)), 1e-7, 1000,
                           p1=0.01, obj_kind="logreg", m_true=float(m)))
    for ds in DATASETS:
        x_np, y_np, _ = load_or_synthesize(ds, labels=(0.0, 1.0))
        n = x_np.shape[1] + 1
        h_np, q_np = cubic.logistic_loss_grad_hessian(x_np, y_np, np.zeros(n))
        f = cubic.cubic_from_numpy(h_np, q_np, 1.0, device=dev, dtype=torch.float32)
        gam = cubic.secant_gamma(f, np.zeros(n), 0, dev, torch.float32)
        h, q = cubic.padded_model(h_np, q_np, dev, torch.float32)
        cases.append(_case(f"cubic_sparse_logreg {ds} {h.shape[0]}x{h.shape[1]}", h, q,
                           bt_sweep_rows(BT_ROWS, gam), 1e-7, 100, prox_kind="zero",
                           obj_kind="cubic", cube_c=1.0))
    h, q = worst.worst_case_model(100, 100, 100.0, dev, torch.float32)
    cases.append(_case("nesterov_worst_case 128x128", h, q, bt_sweep_rows(worst.BT_ROWS, 1.0),
                       1e-6, 10000, prox_kind="zero", obj_kind="cubic"))
    return cases


def _sweep_args(case, a=None, **kw):
    kw = dict(case["kw"], **kw)
    return (case["a"] if a is None else a, case["b"], case["x0"], case["rows"], case["tol"],
            case["maxit"], kw["shrink"], kw["prox_kind"], kw["p1"], kw["p2"], kw["cube_c"],
            kw["obj_kind"], kw["m_true"], kw["exact_bregman"])


def _flat(out):
    return [*out[:5], *out[5]] if isinstance(out[5], tuple) else list(out)


def _same_bits(u, w):
    return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)
               for x, y in zip(_flat(u), _flat(w)))


def _records(out):
    """(numits, trials, nesterov flags unknown) of a sweep output: numit and each row's trial
    counts as lists."""
    return out[1].tolist(), out[5][3].tolist()


def rows_are_k4(case, out, k4):
    """Whether every row of the sweep ``out`` equals ``k4``'s launch with its arguments."""
    kw = case["kw"]
    for j, (g0, xi, flag) in enumerate(case["rows"].tolist()):
        one = k4(case["a"], case["b"], case["x0"], g0, case["tol"], case["maxit"], xi,
                 kw["shrink"], kw["prox_kind"], kw["p1"], kw["p2"], kw["cube_c"], flag > 0,
                 kw["obj_kind"], kw["m_true"], True, kw["exact_bregman"])
        row = (out[0][j], out[1][j], out[2][j], out[3][j], out[4][j], *(h[j] for h in out[5]))
        if not _same_bits(row, one):
            return False
    return True


def _syncs(case, out, lockstep, count=None):
    """(the syncs the design takes on these records, the syncs the kernel counted or None)."""
    numits, trials = _records(out)
    nests = [flag > 0 for flag in case["rows"][:, 2].tolist()]
    if not lockstep:
        return rows_in_turn_syncs(numits, trials, nests), None
    m, n = case["a"].shape
    plan = resident_bt.k4b_plan(len(numits), m, n, case["a"].element_size(),
                                kernels._sm_count(case["a"].device.index))
    return (resident_bt.k4b_syncs(plan["groups"], numits, trials, nests,
                                  case["kw"]["obj_kind"] == "cubic"), count)


def _best_in_turns(order, fns):
    ms, results = {}, {}
    for name in order:
        t = 1e3 * timed(fns[name], reps=3)[0]
        ms[name] = min(ms.get(name, t), t)
        results[name] = fns[name]()
    torch.cuda.synchronize()
    return ms, results


def measure(builds, dev, reps):
    """Times every build's launchers in turns; ``builds`` maps a name to (k4, sweep, lockstep)
    and must hold "this" and "other"."""
    names = list(builds)
    order = ((names + names[::-1]) * reps)[:len(names) * reps]
    out = {"sweeps": {}, "bits": {}, "k4": {}, "iter_us": {}}
    for case in driver_cases(dev):
        args = _sweep_args(case)
        ms, results = _best_in_turns(order, {k: (lambda s=v[1]: s(*args))
                                             for k, v in builds.items()})
        this = results["this"]
        counted = int(resident_bt.resident_bt_sweep.last_syncs)
        syncs, us_sync = {}, {}
        for name in names:
            syncs[name], got = _syncs(case, results[name], builds[name][2], counted)
            if got is not None and got != syncs[name]:
                raise RuntimeError(f"k4b_lockstep: {case['name']}: the kernel counted {got} grid "
                                   f"syncs, k4b_syncs {syncs[name]}")
            us_sync[name] = 1e3 * ms[name] / syncs[name]
        numits, trials = _records(this)
        out["sweeps"][case["name"]] = dict(
            ms=ms, this_over_other=ms["this"] / ms["other"], numit=numits,
            trials=[int(sum(t[:k])) for t, k in zip(trials, numits)], syncs=syncs,
            syncs_match=True, us_per_sync=us_sync,
            same_bits=all(_same_bits(results[name], this) for name in names),
            rows_are_k4=rows_are_k4(case, this, builds["this"][0]))
        variants = [("bf16", dict(a=case["a"].to(torch.bfloat16)))]
        if case["kw"]["obj_kind"] == "ls":
            variants.append(("exact", dict(exact_bregman=True)))
        for label, kw in variants:
            runs = {name: builds[name][1](*_sweep_args(case, **kw)) for name in names}
            torch.cuda.synchronize()
            out["bits"][f"{case['name']} {label}"] = all(_same_bits(runs[name], runs["this"])
                                                         for name in names)

    a, b, gam = reference_lasso(dev)
    x0 = torch.zeros(a.shape[1], device=dev)
    k4_args = (a, b, x0, gam, 1e-4, 4000, 1.5, 0.5, "l1", 1.0, 0.0, 0.0, False, "ls", None)
    ms, _ = _best_in_turns(order, {k: (lambda f=v[0]: f(*k4_args, False, False))
                                   for k, v in builds.items()})
    recs = {name: builds[name][0](*k4_args, True, False) for name in names}
    torch.cuda.synchronize()
    out["k4"] = dict(ms=ms, this_over_other=ms["this"] / ms["other"],
                     numit=int(recs["this"][1]), trials=int(recs["this"][8].sum()),
                     same_bits=all(_same_bits(recs[name], recs["this"]) for name in names))

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    a8 = torch.randn(8, 2176, generator=gen, device=dev) / 2176
    b8 = torch.randn(8, generator=gen, device=dev)
    for shape, (a_, b_) in (("4096x1024", (a, b)), ("8x2176", (a8, b8))):
        gam_ = 1e-3 / float((a_ * a_).sum())
        x0_ = torch.zeros(a_.shape[1], device=dev)
        for nest in (False, True):
            args = (a_, b_, x0_, gam_, -1.0, ITERS, 1.0, 0.5, "zero", 0.0, 0.0, 0.0, nest, "ls",
                    None)
            fns = {k: (lambda f=v[0]: f(*args, False, False)) for k, v in builds.items()}
            row = torch.tensor([[gam_, 1.0, float(nest)]])
            one_row = (a_, b_, x0_, row, -1.0, ITERS, 0.5, "zero", 0.0, 0.0, 0.0, "ls", None,
                       False)
            fns["one_row_k4b"] = lambda s=builds["this"][1]: s(*one_row)
            ms, _ = _best_in_turns(order + ["one_row_k4b", "one_row_k4b"], fns)
            recs = {name: builds[name][0](*args, True, False) for name in names}
            torch.cuda.synchronize()
            if int(recs["this"][1]) != ITERS or int(recs["this"][8].sum()) != ITERS:
                raise RuntimeError(f"k4b_lockstep: {shape}: not {ITERS} one-trial iterations")
            syncs = {name: (resident_bt.k4b_syncs([[0]], [ITERS], [recs[name][8].tolist()],
                                                  [nest]) if builds[name][2] else
                            rows_in_turn_syncs([ITERS], [recs[name][8].tolist()], [nest]))
                     for name in names}
            out["iter_us"][f"{shape} {'Nesterov' if nest else 'PG'}"] = dict(
                us={k: v * 1e3 / ITERS for k, v in ms.items()}, syncs=syncs,
                us_per_sync={name: 1e3 * ms[name] / syncs[name] for name in names},
                same_bits=all(_same_bits(recs[name], recs["this"]) for name in names))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", required=True,
                        help="the root of another checkout whose K4/K4b is run beside this tree's")
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k4b_lockstep measures on a CUDA device and none is available")
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
