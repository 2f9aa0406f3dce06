"""Adaptive Golden Ratio Algorithm, aGRAAL (counterpart of
``adaprox_tpu/solvers/agraal.py``; reference src/AdaProx.jl:150-192, after
Malitsky, "Golden ratio algorithms for variational inequalities", Math. Prog.
184 (2020)).

The step size comes from the inverse-cocoercivity estimate
||dx||^2 / ||dgrad||^2 and a golden-ratio average x_bar of the iterates. The
loop runs on the host over device tensors, as the engine does
(``solvers/primal_dual.py``): the gamma/theta recurrence is 0-d tensor
arithmetic in the iterate dtype, and the stop test is read on the host once an
iteration.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.jax_random import normal
from .common import Counters, SolveResult, Records, l2sq, run_loop

__all__ = ["agraal"]

_LATER = "not ported yet: see ROADMAP.md, 'Engine behaviours still to port'"


class _Carry(NamedTuple):
    it: int
    x: torch.Tensor
    x_prev: torch.Tensor
    x_bar: torch.Tensor
    grad_x: torch.Tensor
    grad_x_prev: torch.Tensor
    gamma: torch.Tensor
    theta: torch.Tensor
    counters: Counters
    ck_counters: Counters  # counters at the record of the last iteration
    norm_res: torch.Tensor
    done: bool


def _solve(f, g, x1, x0, gamma0, gamma_max, phi, tol, maxit, history):
    dt, dev = x1.dtype, x1.device
    gamma0, gamma_max, phi, tol = (torch.as_tensor(v, dtype=dt, device=dev)
                                   for v in (gamma0, gamma_max, phi, tol))
    rho = 1 / phi + 1 / phi**2

    _, aux1 = f.value_and_aux(x1)
    grad_x = f.grad_from_aux(x1, aux1)
    _, aux0 = f.value_and_aux(x0)
    grad_x_prev = f.grad_from_aux(x0, aux0)
    counters = Counters.zeros().bump(f_evals=2, grad_f_evals=2)
    # gamma0 <= 0 (or NaN) selects the secant estimate, two square roots
    secant = torch.sqrt(l2sq(x1 - x0)) / torch.sqrt(l2sq(grad_x - grad_x_prev))
    gamma = torch.where(gamma0 > 0, gamma0, secant)

    carry0 = _Carry(it=0, x=x1, x_prev=x0, x_bar=x1, grad_x=grad_x, grad_x_prev=grad_x_prev,
                    gamma=gamma, theta=torch.ones((), dtype=dt, device=dev), counters=counters,
                    ck_counters=counters, norm_res=torch.full((), math.inf, dtype=dt, device=dev),
                    done=False)

    def step(c):
        # src/AdaProx.jl:175-189; identical iterates give C = 0/0 = NaN: taken
        # as +inf, so the min keeps the growth bound
        curv = l2sq(c.x - c.x_prev) / l2sq(c.grad_x - c.grad_x_prev)
        curv = torch.where(torch.isnan(curv), torch.full_like(curv, math.inf), curv)
        gamma = torch.minimum(torch.minimum(rho * c.gamma, phi * c.theta * curv / (4 * c.gamma)),
                              gamma_max)
        theta = phi * gamma / c.gamma
        x_bar = ((phi - 1) * c.x + c.x_bar) / phi
        x, g_x = g.prox(x_bar - gamma * c.grad_x, gamma)
        counters = c.counters.bump(prox_g_evals=1)
        norm_res = torch.sqrt(l2sq(x - c.x)) / gamma
        ck = counters
        it = c.it + 1
        row = None
        if history:
            # the objective at the new prox point, uncounted (src/AdaProx.jl:183-185)
            row = (it, gamma, torch.zeros_like(gamma), norm_res, f.value(x) + g_x, ck)
        # the gradient for the next iteration (the reference skips it on the
        # converging iteration, src/AdaProx.jl:186-189: the ck snapshot above)
        _, aux = f.value_and_aux(x)
        grad_x = f.grad_from_aux(x, aux)
        counters = counters.bump(f_evals=1, grad_f_evals=1)
        new = _Carry(it=it, x=x, x_prev=c.x, x_bar=x_bar, grad_x=grad_x, grad_x_prev=c.grad_x,
                     gamma=gamma, theta=theta, counters=counters, ck_counters=ck,
                     norm_res=norm_res, done=bool(norm_res <= tol))  # the stop test's host sync
        return new, row

    final, rows = run_loop(carry0, step, maxit, history)
    converged = bool(final.norm_res <= tol)
    return SolveResult(
        x=final.x, y=None, numit=final.it, norm_res=final.norm_res,
        counters=final.ck_counters if converged else final.counters,
        records=None if rows is None else Records.stack(rows, dtype=dt, device=dev))


def agraal(x1, *, f, g, x0=None, gamma0=None, gamma_max=1e6, phi=1.5, tol=1e-5,
           maxit=100_000, name="aGRAAL", key=None, history=False, resume_state=None,
           scalar_dtype=None, it_cap=None):
    """aGRAAL (reference src/AdaProx.jl:150-192) from ``x1``, which fixes the
    device and dtype of the solve. ``x0``, the companion point, defaults to
    ``x1 + N(0, I)`` drawn as ``jax.random.normal(PRNGKey(key), x1.shape)``
    (``utils.jax_random``, float32 or float64; ``key`` an integer seed, 0 by
    default). ``gamma0`` defaults to the secant estimate
    ||x1 - x0|| / ||grad(x1) - grad(x0)||. ``resume_state``,
    ``scalar_dtype`` and ``it_cap`` are not ported yet and raise
    ``NotImplementedError``."""
    for opt, val in (("resume_state", resume_state), ("scalar_dtype", scalar_dtype),
                     ("it_cap", it_cap)):
        if val is not None:
            raise NotImplementedError(f"{opt} is {_LATER}")
    if not isinstance(x1, torch.Tensor):
        raise TypeError("x1 must be a torch.Tensor; it sets the solve's device and dtype")
    if x0 is None:
        noise = normal(0 if key is None else key, tuple(x1.shape),
                       str(x1.dtype).removeprefix("torch."))
        x0 = x1 + torch.from_numpy(noise).to(x1.device)
    res = _solve(f, g, x1, x0, 0.0 if gamma0 is None else gamma0, gamma_max, phi, tol,
                 int(maxit), bool(history))
    return res.with_name(name)
