"""The sparse slice's case and the bound that chip_smoke.py (phase 16) holds its solves
to: each sparse route's final objective against the dense route's.

The case (``sparse_case``): an m x n float32 matrix whose (bm, bn) tiles are each
nonzero with probability ``density`` and Gaussian inside, the block-sparse size the JAX
package measured (8192 x 16384 at 10% of (64, 512) tiles, its docs/PERFORMANCE.md and
tools/bcsr_probe.py). The three problems over it (``problem``), each from the seed:

  * "lasso": AdaPGM on 0.5 ||A x - b||^2 + lam ||x||_1, lam = 0.1 ||A'b||_inf;
  * "sqrt_lasso": AdaPDM on lam ||x||_1 + ||A x - b||_2 (f = 0, h = Translate(L2Norm,
    -b)), lam = 0.1 ||A'b||_inf / ||b||, steps from AdaPGMRule.make(t = 1, ||A||_F);
  * "logreg": AdaPGM on the mean logistic loss of labels (A w_true > 0) plus
    lam ||w||_1, lam = 0.1 ||A'(y - 1/2)||_inf / m;

each from zero, tol 0, ``maxit`` iterations, the step from sigma = ``opnorm`` of the
dense operator (50 power iterations). ``objective`` is the problem's F at the end,
from the dense matrix.

Calibration (``python -m adaprox_tpu_torch.experiments.sparse_calibration --device cpu
[--m 2048 --n 4096] [--maxit 500]``): every route in float32 (ELL's and BCSR's plain
versions, which are K8's and K9a/K9b's CPU paths: "xla" takes A'y over A''s tiles,
"pallas" over A's own, as K9a and K9b do on the card; and the dense matrix) against the
dense route in float64, each solve on the same case at a cut size (the full case is a
card's work). Prints one JSON line a (problem, route): the relative gap of F to the
float64 dense run's and to the float32 dense run's. The bound SPARSE_OBJ_RTOL below
stands beside the readings it was set from.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ..models.objectives import LeastSquares, LogisticLoss
from ..ops.bcsr import BCSROperator
from ..ops.linops import DenseOperator
from ..ops.oracles import ZeroSmooth
from ..ops.prox import L1Norm, L2Norm, Translate
from ..ops.sparse import ELLOperator
from ..solvers.primal_dual import adaptive_primal_dual, adaptive_proxgrad
from ..solvers.rules import AdaPGMRule

SPARSE_SHAPE = (8192, 16384)
SPARSE_BLOCK = (64, 512)
SPARSE_DENSITY = 0.1
SPARSE_SEED = 16
# the engine's depth in chip_smoke's phase 16 (tol 0, every solve runs all of them)
SPARSE_MAXIT = 500
PROBLEMS = ("lasso", "sqrt_lasso", "logreg")
# |F(route) - F(dense)| / |F(dense)|, both float32, after SPARSE_MAXIT iterations.
# Read on the CPU (--device cpu, --maxit 500; routes ell and xla, the plain versions that
# K8 and K9a/K9b replace on the card, against the dense route, all f32): at most 2.7e-7
# at 1024 x 2048 (logreg, xla), 9.2e-8 at 2048 x 4096, 7.9e-8 at 4096 x 8192, about one
# f32 spacing of F. Every f32 route against the f64 dense run: lasso and logreg at most
# 1.3e-11, sqrt_lasso 3.7e-8, 1.4e-7 and 3.3e-7 at the three sizes (about 2.4x for a
# 4x larger case: ~8e-7 expected at the full case). The card sums in other orders again;
# about 10x the largest: 1e-5. Re-read with the "pallas" route, whose A'y takes A's own
# tiles (at 2048 x 4096): against the f32 dense run at most 8.4e-8 (logreg),
# against the f64 one lasso 1.1e-11, logreg 6.2e-13, sqrt_lasso 1.4e-7, as the other
# routes: the bound stays.
SPARSE_OBJ_RTOL = 1e-5


def sparse_case(m=SPARSE_SHAPE[0], n=SPARSE_SHAPE[1], block=SPARSE_BLOCK,
                density=SPARSE_DENSITY, seed=SPARSE_SEED):
    """The m x n float32 numpy matrix: each (bm, bn) tile (the last ones cut at m, n)
    nonzero with probability ``density``, its entries standard normal."""
    rng = np.random.default_rng(seed)
    bm, bn = block
    mask = rng.random((-(-m // bm), -(-n // bn))) < density
    d = np.zeros((m, n), np.float32)
    for i, c in zip(*np.nonzero(mask)):
        tile = d[i * bm:(i + 1) * bm, c * bn:(c + 1) * bn]
        tile[...] = rng.standard_normal(tile.shape, dtype=np.float32)
    return d


def operators(d, device, dtype=torch.float32, routes=("ell", "pallas", "slab", "xla", "dense")):
    """{route: operator} over the numpy matrix ``d`` on ``device``: "ell" the
    ELLOperator, "pallas" / "slab" / "xla" the BCSROperator at SPARSE_BLOCK with that
    route (one structure shared), "dense" the DenseOperator."""
    out = {}
    if "ell" in routes:
        out["ell"] = ELLOperator.from_dense(d, device=device, dtype=dtype)
    bcsr = [r for r in routes if r in ("pallas", "slab", "xla")]
    if bcsr:
        op = BCSROperator.from_dense(d, SPARSE_BLOCK, bcsr[0], device=device, dtype=dtype)
        for r in bcsr:
            out[r] = dataclasses.replace(op, kernel=r)
    if "dense" in routes:
        out["dense"] = DenseOperator(torch.as_tensor(d, device=device).to(dtype))
    return out


def problem(name, dense, seed=SPARSE_SEED):
    """The data of problem ``name`` over the dense operator ``dense`` (its device and
    dtype): a dict of b or labels, lam, the step data, and x0 (and y0)."""
    a = dense.a
    m, n = a.shape
    dev, dt = a.device, a.dtype
    rng = np.random.default_rng(seed + 1)
    sigma = float(dense.opnorm(iters=50))
    if name == "logreg":
        w_true = torch.as_tensor(rng.standard_normal(n), device=dev, dtype=dt)
        y = (dense.matvec(w_true) > 0).to(dt)
        lam = 0.1 * float(dense.rmatvec(y - 0.5).abs().max()) / m
        return dict(y=y, lam=lam, gamma=4.0 * m / sigma**2, x0=torch.zeros(n + 1, device=dev,
                                                                             dtype=dt))
    b = torch.as_tensor(rng.standard_normal(m), device=dev, dtype=dt)
    atb = float(dense.rmatvec(b).abs().max())
    if name == "lasso":
        return dict(b=b, lam=0.1 * atb, gamma=1.0 / sigma**2,
                    x0=torch.zeros(n, device=dev, dtype=dt))
    return dict(b=b, lam=0.1 * atb / float(torch.linalg.vector_norm(b)),
                norm_a=float(dense.norm()), x0=torch.zeros(n, device=dev, dtype=dt),
                y0=torch.zeros(m, device=dev, dtype=dt))


def solve(name, op, prob, maxit=SPARSE_MAXIT):
    """The engine's solve of problem ``name`` with the operator ``op`` in the data's
    place; returns the SolveResult."""
    g = L1Norm(prob["lam"])
    if name == "lasso":
        return adaptive_proxgrad(prob["x0"], f=LeastSquares(op, prob["b"]), g=g,
                                 rule=AdaPGMRule(gamma=prob["gamma"]), tol=0.0, maxit=maxit)
    if name == "logreg":
        return adaptive_proxgrad(prob["x0"], f=LogisticLoss(op, prob["y"]), g=g,
                                 rule=AdaPGMRule(gamma=prob["gamma"]), tol=0.0, maxit=maxit)
    return adaptive_primal_dual(prob["x0"], prob["y0"], f=ZeroSmooth(), g=g,
                                h=Translate(L2Norm(1.0), -prob["b"]), A=op,
                                rule=AdaPGMRule.make(t=1.0, norm_a=prob["norm_a"]), tol=0.0,
                                maxit=maxit)


def objective(name, dense, prob, x):
    """F at x of problem ``name``, from the dense operator."""
    lam_l1 = prob["lam"] * torch.sum(torch.abs(x))
    if name == "lasso":
        return float(LeastSquares(dense.a, prob["b"]).value(x) + lam_l1)
    if name == "logreg":
        return float(LogisticLoss(dense.a, prob["y"]).value(x) + lam_l1)
    return float(torch.linalg.vector_norm(dense.matvec(x) - prob["b"]) + lam_l1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--m", type=int, default=2048)
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--maxit", type=int, default=SPARSE_MAXIT)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but PyTorch finds no CUDA device; "
                           "pass --device cpu to run on the CPU")
    d = sparse_case(args.m, args.n)
    routes = ("ell", "xla", "pallas", "dense")
    ops32 = operators(d, args.device, torch.float32, routes)
    dense64 = DenseOperator(torch.as_tensor(d, device=args.device).to(torch.float64))
    for name in PROBLEMS:
        prob64 = problem(name, dense64)
        f64 = objective(name, dense64, prob64, solve(name, dense64, prob64, args.maxit).x)
        prob32 = problem(name, ops32["dense"])
        xs = {r: solve(name, op, prob32, args.maxit).x for r, op in ops32.items()}
        f32 = {r: objective(name, ops32["dense"], prob32, x) for r, x in xs.items()}
        for r, x in xs.items():
            f = objective(name, dense64, prob64, x.to(torch.float64))
            print(json.dumps(dict(problem=name, route=r, shape=[args.m, args.n],
                                  maxit=args.maxit, objective=f32[r], f64_dense=f64,
                                  gap_f64=abs(f - f64) / abs(f64),
                                  gap_f32_dense=abs(f32[r] - f32["dense"]) / abs(f32["dense"]))),
                  flush=True)


if __name__ == "__main__":
    main()
