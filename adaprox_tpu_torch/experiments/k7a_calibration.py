"""Calibrates the bounds that chip_smoke.py (phase 13) and tests/test_torch_cuda.py hold
K7a to: K7a's plain versions (``ops.resident_f0.resident_mpls_sweep_plain`` and
``resident_adapdmp_sweep_plain``) in float32 against float64 on the square-root lasso
driver's padded inputs (``experiments.square_root_lasso.resident_inputs``: the synthetic
stand-ins of housing_scale 512x128, abalone 4224x128 and cpusmall_scale 8192x128; lam 10;
sigma0 = 1, eta0 = ||A||_F), with A stored f32 or bf16 (the float64 run takes the same
bf16-rounded values). The bounds are the constants below, each beside the readings it
was set from. Prints one JSON line a case.

    python -m adaprox_tpu_torch.experiments.k7a_calibration --mode horizon [--device cpu]
    python -m adaprox_tpu_torch.experiments.k7a_calibration --mode driver [--datasets ...]

``--device`` is cuda (the default; it raises when PyTorch finds no card) or cpu; the
plain versions run on either, in both precisions.

``--mode horizon`` (tol -1, ``--cut`` iterations, the couplings ``--ts``): for each row
the first iteration where the trial counts differ, the first where gamma, sigma or
norm_res part by more than ``--rtol`` of the float64 row's largest magnitude so far, the
largest relative gap of the gamma, sigma, norm_res and objective rows over ``--horizon``
iterations, the gap of x after ``--horizon`` iterations relative to the float64 row's
max |x|, and the relative gap of the objective after ``--cut``.

``--mode driver`` (maxit 5000, the 15 couplings, the drivers' tol 1e-5 or ``--tol``): for
every row that reports convergence, its final objective F and |F - F_cv| / |F_cv|, with
F_cv the final objective of K7d's plain version in float64 at tol 1e-5 (the Condat-Vu
row); the largest a (dataset, h, core, precision), and the rows that converged.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..convert import sqrt_lasso_from_numpy
from ..ops import resident_f0
from . import square_root_lasso

# K7a on the card against its plain version in f32, tol -1. Read on the CPU (--mode
# horizon --device cpu: the three stand-ins, l2 and l1, A f32 and bf16, the couplings
# K7A_TS, 300 iterations, horizon 40; 120 rows): the trial counts first differed at
# iteration 61 (housing_scale, bf16, l1, MP, t 100), and in 71 rows not at all; over the
# first 40 iterations the gamma, sigma, norm_res and objective rows parted by at most
# 9.5e-6 of each row's largest value (housing_scale, f32, l2, MP, t 0.01) and x by 7.8e-5
# of max |x| (abalone, bf16, l1, MP, t 100); after 300 iterations the objective by up to
# 5.0e-2 (cpusmall_scale, f32, l1, AdaPDM+, t 0.05: the trajectories had parted at 163).
# The card sums in another order than the plain f32 version, a perturbation of about the
# same size. Held: the trial counts and ls_failed equal over K7A_HORIZON, the rows within
# K7A_RTOL and x within K7A_X_RTOL of max |x| there (about 10x the largest), the objective
# after K7A_CUT within K7A_OBJ_RTOL (2x).
K7A_TS = [0.01, 0.05, 1.0, 20.0, 100.0]
K7A_HORIZON = 40
K7A_RTOL = 1e-4
K7A_X_RTOL = 1e-3
K7A_CUT = 300  # the depth at which the plain sweep (a host sync a trial) is held and timed
K7A_OBJ_RTOL = 0.1
# Past the horizon the card's and the plain version's trajectories part, so each core is
# also held on a converged l1 case (with l2 the drivers' tol 1e-5 does that): no f32 l1
# row reaches tol 1e-5, but at K7A_L1_TOL 1e-3 (--mode driver --tol 1e-3 --h-kinds l1
# --datasets housing_scale) MP converged at t 0.01-0.15 (2237-4767 iterations) and AdaPDM+
# at t 2-100 (427-4736), in f32 and f64 alike. The final objectives of those 24 converged
# runs (both cores, both precisions, 12 couplings, each its own trajectory) spanned 1.83e-5
# of their value (90.819687-90.821353); f32 and f64 at the same t differed by at most
# 3.3e-7. Held: the card's and the plain version's final objectives at K7A_L1_TS within
# K7A_L1_OBJ_RTOL (2x the span), both converged.
K7A_L1_TOL = 1e-3
K7A_L1_TS = {"mp": 0.05, "adapdmp": 20.0}  # f32 converged at 2546 and 535 iterations
K7A_L1_OBJ_RTOL = 4e-5
# The drivers' converged rows against the f64 Condat-Vu objective (--mode driver: the plain
# sweeps at the drivers' tol 1e-5, maxit 5000, the 15 couplings, in f32 and f64): with l2
# every converged row's final objective was within 7.5e-8 of it (abalone, f32; f64 rows
# within 1.9e-13); with l1 the Condat-Vu run stops at maxit 5000 short of tol, no f32 row
# converged, and the f64 rows that did (AdaPDM+ at the largest t) read up to 3.6e-4 from it
# (housing_scale; abalone 1.5e-4, cpusmall_scale 2.0e-4). In f32 most l2 rows stall above tol
# 1e-5 and run all 5000 iterations (cpusmall_scale: 14 of 15 MP rows and all 15 AdaPDM+
# rows; f64 converges every l2 row). Bound 2x the largest.
K7A_DRIVER_OBJ_RTOL = {"l2": 1.5e-7, "l1": 7.2e-4}

CORES = {"mp": resident_f0.resident_mpls_sweep_plain,
         "adapdmp": resident_f0.resident_adapdmp_sweep_plain}
ROWS = (0, 1, 2, 4)  # gamma, sigma, norm_res and the objective of the five histories


def inputs(name, a_dtype, device):
    """(a f32/bf16 storage, a f64 with the same values, bv f32, bv f64, eta0, gamma, sigma)."""
    x, y, _ = square_root_lasso.load(name)
    _, _, h, a_op, norm_a = sqrt_lasso_from_numpy(x, y, 10.0, "l2", device=device,
                                                  dtype=torch.float64)
    a, bv = square_root_lasso.resident_inputs(a_op.a, -h.b)
    a_st = a.to(torch.float32).to(a_dtype)
    gamma, sigma = square_root_lasso.cv_steps(norm_a)
    return (a_st, a_st.to(torch.float64), bv.to(torch.float32), bv, norm_a, gamma, sigma)


def first_part(got, want, rtol):
    """The first iteration at which got parts from want by more than rtol of want's
    largest magnitude so far (None if never)."""
    scale = torch.cummax(want.abs(), 0).values
    bad = ((got - want).abs() > rtol * scale).nonzero()
    return int(bad[0]) if len(bad) else None


def horizon(args):
    hz = args.horizon
    for name in args.datasets:
        for a_dtype in (torch.float32, torch.bfloat16):
            a32, a64, b32, b64, norm_a, _, _ = inputs(name, a_dtype, args.device)
            for h_kind in resident_f0.H_KINDS:
                for core, fn in CORES.items():
                    p2 = 1.0 if core == "mp" else norm_a
                    lo, hi = (fn(a, b, 10.0, args.ts, p2, -1.0, args.cut, record=True,
                                 h_kind=h_kind) for a, b in ((a32, b32), (a64, b64)))
                    short = [fn(a, b, 10.0, args.ts, p2, -1.0, hz, h_kind=h_kind)
                             for a, b in ((a32, b32), (a64, b64))]
                    rows = []
                    for i, t in enumerate(args.ts):
                        trials = (lo[5][3][i] != hi[5][3][i].to(torch.float32)).nonzero()
                        parts = [first_part(lo[5][k][i].double(), hi[5][k][i], args.rtol)
                                 for k in range(3)]
                        x_lo, x_hi = short[0][0][i].double(), short[1][0][i]
                        rows_err = max(float((lo[5][k][i][:hz].double() - hi[5][k][i][:hz]).abs()
                                             .max() / hi[5][k][i][:hz].abs().max())
                                       for k in ROWS)
                        x_max = float(x_hi.abs().max())
                        obj = abs(float(lo[5][4][i][-1]) - float(hi[5][4][i][-1])) / abs(
                            float(hi[5][4][i][-1]))
                        rows.append(dict(
                            t=t, trials_differ_at=int(trials[0]) if len(trials) else None,
                            rows_part_at=min((p for p in parts if p is not None), default=None),
                            rows_err=rows_err,
                            x_rel=float((x_lo - x_hi).abs().max()) / (x_max if x_max > 0 else 1.0),
                            obj_rel=obj, mean_trials=float(lo[5][3][i].mean()),
                            ls_failed=[bool(lo[4][i]), bool(hi[4][i])]))
                    print(json.dumps(dict(mode="horizon", dataset=name, shape=list(a32.shape),
                                          a=str(a_dtype).removeprefix("torch."), h_kind=h_kind,
                                          core=core, cut=args.cut, horizon=hz,
                                          rows=rows)), flush=True)


def driver(args):
    ts = square_root_lasso.T_VALUES
    for name in args.datasets:
        a32, a64, b32, b64, norm_a, gamma, sigma = inputs(name, torch.float32, args.device)
        for h_kind in args.h_kinds:
            cv = resident_f0.resident_condat_vu_plain(a64, b64, 10.0, gamma, sigma, 1e-5, 5000,
                                                      record=True, h_kind=h_kind)
            f_cv = float(cv[4][1][int(cv[1]) - 1])
            for core, fn in CORES.items():
                p2 = 1.0 if core == "mp" else norm_a
                for label, a, b in (("f32", a32, b32), ("f64", a64, b64)):
                    out = fn(a, b, 10.0, ts, p2, args.tol, 5000, record=True, h_kind=h_kind)
                    objs, gaps = {}, {}
                    for i, t in enumerate(ts):
                        k = int(out[1][i])
                        if bool(out[3][i]):
                            objs[str(t)] = float(out[5][4][i][k - 1])
                            gaps[str(t)] = abs(objs[str(t)] - f_cv) / abs(f_cv)
                    print(json.dumps(dict(
                        mode="driver", dataset=name, h_kind=h_kind, core=core, iterates=label,
                        tol=args.tol,
                        f_cv=f_cv, cv_numit=int(cv[1]), numit=out[1].tolist(),
                        ls_failed=out[4].tolist(), converged_objs=objs, converged_gaps=gaps,
                        max_gap=max(gaps.values(), default=None))), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=("horizon", "driver"), required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--datasets", default="housing_scale,abalone,cpusmall_scale")
    p.add_argument("--ts", default=",".join(map(str, K7A_TS)))
    p.add_argument("--cut", type=int, default=K7A_CUT)
    p.add_argument("--horizon", type=int, default=K7A_HORIZON)
    p.add_argument("--rtol", type=float, default=1e-3)
    p.add_argument("--tol", type=float, default=1e-5, help="--mode driver: the sweeps' tol")
    p.add_argument("--h-kinds", default=",".join(resident_f0.H_KINDS))
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but PyTorch finds no CUDA device; "
                           "pass --device cpu to run on the CPU")
    args.datasets = args.datasets.split(",")
    args.h_kinds = args.h_kinds.split(",")
    args.ts = [float(t) for t in args.ts.split(",")]
    torch.set_num_threads(1)
    (horizon if args.mode == "horizon" else driver)(args)


if __name__ == "__main__":
    main()
