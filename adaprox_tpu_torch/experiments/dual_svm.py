"""Dual SVM experiment (counterpart of ``adaprox_tpu/experiments/dual_svm.py``;
reference experiments/dual_svm/runme.jl).

A box-constrained QP with one equality through the composite term: f =
0.5 x'Qx + q'x with Q = D_y X X' D_y and q = -1 (runme.jl:47-50), g =
IndBox(0, C), h = IndZero, A = y' (1 x N). Datasets svmguide3, mushrooms and
heart_scale, C in {0.1, 1}, maxit 10000, tol 1e-5; the JSONL keeps only
[method, it, f_evals, norm_res] (runme.jl:141). A dataset whose LIBSVM file
is not in the datasets directory is replaced by the shape-matched synthetic
data of ``utils.datasets`` with labels -1/+1 (``data_source`` says which).

The menu, in the JAX driver's order: AdaPDM for the 12 couplings t of
``T_VALUES``, Malitsky-Pock for the same 12 (sigma0 = 1/||y||) and Condat-Vu
with the reference's par heuristics. The engine runs f as
``FactoredQuadratic(B = D_y X)``, which never forms the N x N Gram. The
Malitsky-Pock linesearch takes its Bregman term in the exact form
0.5 <dx, Q dx> below f64 (``--exact-bregman auto``): in f32 the reference's raw
objective difference carries eps*|f| noise that stalls it.

Where it runs. The default path runs every row through the engine
(``adaptive_primal_dual``, ``malitsky_pock``, ``condat_vu``), on the card or,
with ``--device cpu``, on the CPU in f64. ``--resident`` runs the 12 AdaPDM rows
as ONE launch of the t-sweep kernel K6b
(``ops.resident_pd.resident_adapdm_dsvm_sweep``), the 12 Malitsky-Pock rows as
ONE launch of K6c (``ops.resident_mp.resident_mp_dsvm_sweep``) and Condat-Vu as
ONE launch of K6d (``resident_cv_dsvm``), with the JAX driver's choice of form:
the dense Gram when itemsize * n_pad^2 <= 24 MiB (svmguide3 and heart_scale),
else B padded to (n_pad, d_pad) (mushrooms); n_pad and d_pad are multiples of
128, the labels are zero-padded and the unpadded count is passed as
``n_true``. On the CPU the same calls take the kernels' plain versions; where
neither form fits, the CPU falls back to the engine as the JAX driver does; the
card takes the factored kernels at any size.

    python -m adaprox_tpu_torch.experiments.dual_svm
    python -m adaprox_tpu_torch.experiments.dual_svm --resident
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from ..convert import dsvm_from_numpy
from ..ops.resident_mp import resident_mp_dsvm_sweep, resident_mp_records
from ..ops.resident_pd import (resident_adapdm_dsvm_sweep, resident_cv_dsvm,
                               resident_cv_records, resident_pd_records)
from ..solvers.malitsky_pock import malitsky_pock
from ..solvers.primal_dual import adaptive_primal_dual, condat_vu, condat_vu_steps
from ..solvers.rules import AdaPGMRule
from ..utils.datasets import load_or_synthesize
from ..utils.libsvm import load_libsvm_dataset
from .common import Sink, group_rows, plot_lines, run_timed, sync_wall

T_VALUES = [0.01, 0.15, 0.02, 0.025, 0.05, 0.1, 0.2, 0.5, 1, 2, 5, 10]
KEYS = ["method", "it", "f_evals", "norm_res"]
# the JAX driver's routing limit: Q (or B) in a TPU core's VMEM
_VMEM_BYTES = 24 * 1024 * 1024
FAST_METHODS = ["AdaPDM t-sweep (resident)", "MP t-sweep (resident)", "Condat-Vu"]


def load(name_or_path):
    """(X, labels in {-1, +1}, source) of a LIBSVM file or a dataset name."""
    if os.path.isfile(str(name_or_path)):
        x_np, y_np = load_libsvm_dataset(name_or_path, labels=(-1.0, 1.0))
        return x_np, y_np, "libsvm"
    return load_or_synthesize(str(name_or_path), labels=(-1.0, 1.0))


def cv_steps(lf, norm_a):
    """Condat-Vu's (gamma, sigma) from the par heuristics as Python floats, as
    the JAX driver forms them (its f64 arithmetic, dual_svm.py:151-154)."""
    f64 = dict(dtype=torch.float64)
    return tuple(float(v) for v in condat_vu_steps(torch.tensor(lf, **f64),
                                                   torch.tensor(norm_a, **f64)))


def resident_inputs(dyx, labels, dtype, device):
    """The kernels' inputs as the JAX driver forms them: (q, lab_pad, factored),
    the dense Gram D_y X X' D_y zero-padded to (n_pad, n_pad) when it fits the
    routing limit, else B = D_y X padded to (n_pad, d_pad); or None when
    neither fits and the solve is on the CPU."""
    n, d = dyx.shape
    n_pad, d_pad = -(-n // 128) * 128, -(-d // 128) * 128
    item = torch.empty((), dtype=dtype).element_size()
    dense_ok = item * n_pad * n_pad <= _VMEM_BYTES
    factored_ok = item * n_pad * d_pad <= _VMEM_BYTES
    if not (dense_ok or factored_ok or torch.device(device).type == "cuda"):
        return None
    b = torch.as_tensor(dyx, device=device).to(dtype)
    lab_pad = F.pad(torch.as_tensor(labels, device=device).to(dtype), (0, n_pad - n))
    if dense_ok:
        # full-f32 matmul on the card: the package turns TF32 off when imported
        return F.pad(torch.matmul(b, b.t()), (0, n_pad - n, 0, n_pad - n)), lab_pad, False
    return F.pad(b, (0, d_pad - d, 0, n_pad - n)), lab_pad, True


def run_dsvm(name_or_path, sink, *, device, big_c=0.1, tol=1e-5, maxit=10_000, dtype=None,
             resident=False, exact_bregman=None):
    """Run the menu on dataset ``name_or_path`` on ``device``. ``dtype``
    defaults to float64 on the CPU (the reference's regime) and float32 on
    CUDA. ``exact_bregman`` (the Malitsky-Pock acceptance test's form) defaults
    to on below float64. Returns the data source ("libsvm" or "synthetic")."""
    device = torch.device(device)
    if dtype is None:
        dtype = torch.float64 if device.type == "cpu" else torch.float32
    x_np, y_np, source = load(name_or_path)
    n_pts = y_np.shape[0]
    f, g, h, a_op = dsvm_from_numpy(x_np, y_np, big_c, device=device, dtype=dtype)
    lf = float(f.norm_q())  # Julia's norm(Q), the Frobenius norm (runme.jl:56), gram-free
    norm_a = float(np.linalg.norm(y_np))
    x0 = torch.zeros(n_pts, dtype=dtype, device=device)
    y0 = torch.zeros(1, dtype=dtype, device=device)
    times = {}
    if exact_bregman is None:
        exact_bregman = torch.finfo(dtype).bits < 64
    sigma0 = 1.0 / norm_a

    inputs = None
    if resident:
        dyx = y_np[:, None] * x_np
        inputs = resident_inputs(dyx, y_np, dtype, device)
        if inputs is None:
            print(f"  [resident] Q {-(-n_pts // 128) * 128}^2 exceeds the routing limit; "
                  "falling back to the engine sweep")
    if inputs is not None:
        q, lab_pad, factored = inputs
        kw = dict(n_true=n_pts, record=True, factored=factored)
        (_, numits, _, _, hg, hr), wall = sync_wall(lambda: resident_adapdm_dsvm_sweep(
            q, lab_pad, float(big_c), T_VALUES, norm_a, tol, maxit, **kw))
        times["AdaPDM t-sweep (resident)"] = round(wall, 4)
        for i, t in enumerate(T_VALUES):
            recs = resident_pd_records(numits[i], hg[i], hr[i], maxit=maxit, t=float(t))
            sink.add(SimpleNamespace(records=recs, name=f"AdaPDM (t={t})"), primal_dual=True)
        (_, numits, _, _, _, hists), wall = sync_wall(lambda: resident_mp_dsvm_sweep(
            q, lab_pad, float(big_c), T_VALUES, sigma0, tol, maxit,
            exact_bregman=exact_bregman, **kw))
        times["MP t-sweep (resident)"] = round(wall, 4)
        for i, t in enumerate(T_VALUES):
            recs = resident_mp_records(numits[i], tuple(h[i] for h in hists), maxit=maxit)
            sink.add(SimpleNamespace(records=recs, name=f"Malitsky-Pock (t={t})"),
                     primal_dual=True)
        gamma, sigma = cv_steps(lf, norm_a)
        _, numit, _, _, hists = run_timed(times, "Condat-Vu", lambda: resident_cv_dsvm(
            q, lab_pad, float(big_c), gamma, sigma, tol, maxit, **kw))
        sink.add(SimpleNamespace(records=resident_cv_records(numit, gamma, sigma, hists,
                                                             maxit=maxit), name="Condat-Vu"),
                 primal_dual=True)
    else:
        total = 0.0
        for t in T_VALUES:
            res, wall = sync_wall(lambda t=t: adaptive_primal_dual(
                x0, y0, f=f, g=g, h=h, A=a_op, rule=AdaPGMRule.make(t=float(t), norm_a=norm_a),
                tol=tol, maxit=maxit, history=True, name=f"AdaPDM (t={t})"))
            sink.add(res, primal_dual=True)
            total += wall
        times["AdaPDM t-sweep"] = round(total, 4)
        total = 0.0
        for t in T_VALUES:
            res, wall = sync_wall(lambda t=t: malitsky_pock(
                x0, y0, f=f, g=g, h=h, A=a_op, t=float(t), sigma=sigma0, tol=tol, maxit=maxit,
                history=True, name=f"Malitsky-Pock (t={t})", exact_bregman=exact_bregman))
            sink.add(res, primal_dual=True)
            total += wall
        times["MP t-sweep"] = round(total, 4)
        sink.add(run_timed(times, "Condat-Vu", lambda: condat_vu(
            x0, y0, f=f, g=g, h=h, A=a_op, Lf=lf, tol=tol, maxit=maxit, history=True,
            name="Condat-Vu")), primal_dual=True)
    sink.emit_meta(wall_s=times, fast_path="resident" if inputs is not None else "default",
                   fast_methods=FAST_METHODS if inputs is not None else [])
    return source


def plot_residual(path):
    from ..utils.logging import find_best, read_jsonl

    groups = group_rows(read_jsonl(path))
    names = []
    for fam in ["Condat-Vu", "Malitsky-Pock", "AdaPDM"]:
        matching = [k for k in groups if k.startswith(fam)]
        if matching:
            names.append(find_best(groups, matching, "norm_res", 1e-5, "f_evals"))
    series = [(name, [r["f_evals"] for r in groups[name]], [r["norm_res"] for r in groups[name]])
              for name in names]
    return plot_lines(path, series, f"Dual SVM ({os.path.basename(path)})",
                      "#passes through data", "||v||")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="results/dual_svm")
    p.add_argument("--maxit", type=int, default=10_000)
    p.add_argument("--tol", type=float, default=1e-5)
    p.add_argument("--datasets", default="svmguide3,mushrooms,heart_scale")
    p.add_argument("--C", default="0.1,1")
    p.add_argument("--resident", action="store_true",
                   help="the whole-solve kernels: the 12 AdaPDM rows in one K6b launch, the 12 "
                        "Malitsky-Pock rows in one K6c launch, Condat-Vu in one K6d launch")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs float32; cpu runs float64, the reference's regime")
    p.add_argument("--no-plot", action="store_true")
    p.add_argument("--exact-bregman", choices=("auto", "on", "off"), default="auto",
                   help="MP linesearch Bregman term: 'auto' uses the cancellation-resistant "
                        "quadratic form in f32 (where the reference's raw difference stalls at "
                        "eps*|f| noise) and the reference-exact difference in f64")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but PyTorch finds no CUDA device; "
                           "pass --device cpu to run on the CPU")

    for big_c in (float(v) for v in args.C.split(",")):
        for ds in args.datasets.split(","):
            path = os.path.join(args.outdir, f"{os.path.basename(ds)}_C_{big_c}.jsonl")
            sink = Sink(path, keys=KEYS)
            src = run_dsvm(ds, sink, device=args.device, big_c=big_c, tol=args.tol,
                           maxit=args.maxit, resident=args.resident,
                           exact_bregman={"auto": None, "on": True,
                                          "off": False}[args.exact_bregman])
            sink.emit_meta(data_source=src)
            print(f"{path}: data={src}")
            if not args.no_plot:
                plot_residual(path)


if __name__ == "__main__":
    main()
