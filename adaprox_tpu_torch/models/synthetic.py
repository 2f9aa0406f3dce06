"""Synthetic problem generators (numpy only).

A copy of ``adaprox_tpu/models/synthetic.py``: the JAX package imports jax,
which the GPU machine does not have. The tests hold the two copies to
bit-identical arrays for the same arguments.

``random_lasso`` reproduces the reference's known-optimum lasso construction
(experiments/lasso/runme.jl:45-77): columns of a random matrix are scaled so
that a chosen sparse x_star and unit-norm residual y_star satisfy the lasso
optimality conditions by construction, giving the analytic optimal value
``||y_star||/2 + lam * ||x_star||_1``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["LassoProblem", "random_lasso"]


class LassoProblem(NamedTuple):
    a: np.ndarray
    b: np.ndarray
    lam: float
    x_star: np.ndarray
    optimum: float


def random_lasso(m=400, n=1000, pfactor=5, seed=0, lam=1.0, rho=1.0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    p = n // pfactor  # number of nonzeros in x_star
    y_star = rng.random(m)
    y_star /= np.linalg.norm(y_star)
    c = rng.random((m, n)) * 2 - 1
    cty = np.abs(c.T @ y_star)
    perm = np.argsort(-cty)  # decreasing |C'y*|
    alpha = np.zeros(n)
    for rank, j in enumerate(perm):
        if rank < p:
            alpha[j] = lam / cty[j]
        elif cty[j] < 0.1 * lam:
            # dual feasibility needs alpha*cty <= lam. The reference's
            # plain `alpha = lam` (runme.jl, with lam hardcoded to 1) only
            # satisfies that when cty <= 1 — guaranteed for lam <= 10 by
            # this branch's guard but violated for larger lam; the min()
            # is bit-identical for lam <= 10 and keeps x_star/optimum
            # genuinely optimal for any lam.
            alpha[j] = min(lam, lam / cty[j])
        else:
            alpha[j] = lam * rng.random() / cty[j]
    a = c * alpha[None, :]
    x_star = np.zeros(n)
    for rank, j in enumerate(perm):
        if rank < p:
            x_star[j] = rng.random() * rho / np.sqrt(p) * np.sign(a[:, j] @ y_star)
    b = a @ x_star + y_star
    optimum = float(np.linalg.norm(y_star) / 2 + lam * np.abs(x_star).sum())
    return LassoProblem(
        a=a.astype(dtype), b=b.astype(dtype), lam=lam,
        x_star=x_star.astype(dtype), optimum=optimum,
    )
