"""Fixed-stepsize accelerated proximal gradient with optional strong
convexity (counterpart of ``adaprox_tpu/solvers/nesterov.py``; Chambolle-Pock
style momentum, reference src/AdaProx.jl:91-142).

The loop runs on the host over device tensors, like the engine
(``solvers/primal_dual.py``): the theta/beta recurrence is 0-d tensor
arithmetic in the iterate dtype, and the stop test ``norm_res <= tol`` is
read on the host once per iteration.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .common import Counters, Records, SolveResult, l2sq, run_loop

__all__ = ["fixed_nesterov"]

_LATER = "not ported yet: see ROADMAP.md, 'Engine behaviours still to port'"


class _Carry(NamedTuple):
    it: int
    x: torch.Tensor
    x_prev: torch.Tensor
    theta: torch.Tensor
    counters: Counters
    norm_res: torch.Tensor
    done: bool


def _solve(f, g, x0, gamma, muf, mug, theta0, tol, maxit, history, strongly_convex):
    dt, dev = x0.dtype, x0.device
    gamma, muf, mug, theta0, tol = (torch.as_tensor(v, dtype=dt, device=dev)
                                    for v in (gamma, muf, mug, theta0, tol))
    mu = muf + mug
    q = gamma * mu / (1 + gamma * mug)
    carry0 = _Carry(it=0, x=x0, x_prev=x0, theta=theta0,
                    counters=Counters.zeros(), norm_res=torch.full_like(gamma, math.inf),
                    done=False)

    def step(c):
        theta_prev = c.theta
        if strongly_convex:
            # src/AdaProx.jl:126-127
            a = 1 - q * theta_prev**2
            theta = (a + torch.sqrt(a**2 + 4 * theta_prev**2)) / 2
            beta = ((theta_prev - 1) * (1 + gamma * mug - theta * gamma * mu) / theta
                    / (1 - gamma * muf))
        else:
            # src/AdaProx.jl:123-124
            theta = (1 + torch.sqrt(1 + 4 * theta_prev**2)) / 2
            beta = (theta_prev - 1) / theta

        z = c.x + beta * (c.x - c.x_prev)
        _, aux = f.value_and_aux(z)
        grad_z = f.grad_from_aux(z, aux)
        counters = c.counters.bump(f_evals=1, grad_f_evals=1)
        x, g_x = g.prox(z - gamma * grad_z, gamma)
        counters = counters.bump(prox_g_evals=1)
        norm_res = torch.sqrt(l2sq(x - z)) / gamma
        it = c.it + 1
        # logging-only objective, not counted (src/AdaProx.jl:134-136)
        objective = f.value(x) + g_x if history else torch.zeros_like(norm_res)
        row = (it, gamma, torch.zeros_like(gamma), norm_res, objective, counters)
        new = _Carry(it=it, x=x, x_prev=c.x, theta=theta, counters=counters,
                     norm_res=norm_res, done=bool(norm_res <= tol))  # the host sync
        return new, row

    final, rows = run_loop(carry0, step, maxit, history)
    return SolveResult(
        x=final.x, y=None, numit=final.it, norm_res=final.norm_res, counters=final.counters,
        records=None if rows is None else Records.stack(rows, dtype=dt, device=dev))


def fixed_nesterov(x0, *, f, g, Lf=None, muf=0.0, mug=0.0, gamma=None, theta=None,
                   tol=1e-5, maxit=100_000, name="Fixed Nesterov", history=False,
                   resume_state=None, scalar_dtype=None, it_cap=None):
    """Fixed-step accelerated PG; q-based momentum when muf+mug > 0
    (reference src/AdaProx.jl:91-142). Exactly one of ``gamma`` and ``Lf``
    (gamma = 1/Lf); q = gamma mu / (1 + gamma mug) must be < 1, and theta
    (default 1/sqrt(q), or 0 when q = 0) in [0, 1/sqrt(q)].

    ``x0`` fixes the device and dtype of the solve. ``resume_state``,
    ``scalar_dtype`` and ``it_cap`` are not ported yet and raise
    ``NotImplementedError``."""
    for opt, val in (("resume_state", resume_state), ("scalar_dtype", scalar_dtype),
                     ("it_cap", it_cap)):
        if val is not None:
            raise NotImplementedError(f"{opt} is {_LATER}")
    if (gamma is None) == (Lf is None):
        raise ValueError("provide exactly one of gamma or Lf")
    if gamma is None:
        gamma = 1.0 / Lf
    gamma, muf, mug = float(gamma), float(muf), float(mug)
    mu = muf + mug
    q = gamma * mu / (1 + gamma * mug)
    if not q < 1:
        raise ValueError("q = gamma*mu/(1+gamma*mug) must be < 1")
    if theta is None:
        theta = 1.0 / math.sqrt(q) if q > 0 else 0.0
    if not (0 <= float(theta) <= (1.0 / math.sqrt(q) if q > 0 else math.inf)):
        raise ValueError("need 0 <= theta <= 1/sqrt(q)")
    if not isinstance(x0, torch.Tensor):
        raise TypeError("x0 must be a torch.Tensor; it sets the solve's device and dtype")
    res = _solve(f, g, x0, gamma, muf, mug, float(theta), tol, int(maxit), bool(history),
                 mu != 0)
    return res.with_name(name)
