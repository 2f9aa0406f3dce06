"""Fully adaptive primal-dual with a linesearch on the operator-norm estimate
("AdaPDM+"; counterpart of ``adaprox_tpu/solvers/adapdm_plus.py``; reference
``adaptive_linesearch_primal_dual``, src/AdaProx.jl:463-550).

For when ||A|| is unknown: the solver keeps an estimate ``eta``, decays it
optimistically by R = 0.95 each outer iteration, inflates it by r = 2 inside
the linesearch, and accepts a trial dual step once

    eta >= ||A'y_next - A'y|| / ||y_next - y||.

Each trial costs one prox_{h*} and one A'-matvec. The loop runs on the host
over device tensors, as ``malitsky_pock``'s does: the trial loop reads the
acceptance test on the host, one device sync a trial, and the stop test once
an iteration.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import prox as prox_ops
from .common import Counters, Records, SolveResult, l2sq, run_loop
from .rules import nan_to_zero, validate_positive

__all__ = ["adaptive_linesearch_primal_dual"]

_LATER = "not ported yet: see ROADMAP.md, 'Engine behaviours still to port'"

# inflations after the first trial: at most 101 trials an iteration
_MAX_TRIALS = 100


class _Carry(NamedTuple):
    it: int
    x: torch.Tensor
    v: torch.Tensor
    y: torch.Tensor
    at_y: torch.Tensor
    x_prev: torch.Tensor
    a_x_prev: torch.Tensor
    grad_prev: torch.Tensor
    gamma: torch.Tensor
    gamma_prev: torch.Tensor
    eta: torch.Tensor
    counters: Counters
    norm_res: torch.Tensor
    ck_x: torch.Tensor  # x at the convergence check (the reference returns this)
    ck_counters: Counters  # counters at the check
    ls_failed: bool  # latched: some linesearch exhausted _MAX_TRIALS
    done: bool


def _solve(f, g, h, a_op, x0, y0, gamma0, eta0, t, delta, big_theta, r, big_r, tol, maxit,
           history):
    dt, dev = x0.dtype, x0.device
    h_conj = prox_ops.conjugate(h)
    t, big_theta, r, big_r, tol, eta0, gamma0 = (
        torch.as_tensor(v, dtype=dt, device=dev)
        for v in (t, big_theta, r, big_r, tol, eta0, gamma0))
    delta1 = 1 + torch.as_tensor(delta, dtype=dt, device=dev)

    # warm-up (src/AdaProx.jl:491-499)
    a_x = a_op.matvec(x0)
    _, aux0 = f.value_and_aux(x0)
    grad0 = f.grad_from_aux(x0, aux0)
    at_y = a_op.rmatvec(y0)
    counters = Counters.zeros().bump(A_evals=1, f_evals=1, grad_f_evals=1, At_evals=1)
    v = x0 - gamma0 * (grad0 + at_y)
    x1, _ = g.prox(v, gamma0)
    counters = counters.bump(prox_g_evals=1)
    carry0 = _Carry(it=0, x=x1, v=v, y=y0, at_y=at_y, x_prev=x0, a_x_prev=a_x, grad_prev=grad0,
                    gamma=gamma0, gamma_prev=gamma0, eta=eta0, counters=counters,
                    norm_res=torch.full_like(gamma0, math.inf), ck_x=x1, ck_counters=counters,
                    ls_failed=False, done=False)

    def step(c):
        # outer half 1 (src/AdaProx.jl:502-514)
        a_x = a_op.matvec(c.x)
        f_x, aux = f.value_and_aux(c.x)
        grad_x = f.grad_from_aux(c.x, aux)
        counters = c.counters.bump(A_evals=1, f_evals=1, grad_f_evals=1)
        primal_res = (c.v - c.x) / c.gamma + grad_x + c.at_y
        dg, dx = grad_x - c.grad_prev, c.x - c.x_prev
        # the cancellation-free form of gamma L (gamma C - 1) (src/AdaProx.jl:507-509)
        big_delta = nan_to_zero(c.gamma * (c.gamma * l2sq(dg) - torch.dot(dg, dx)) / l2sq(dx))
        xi_bar = t**2 * c.gamma**2 * c.eta**2 * delta1**2
        m4xim1 = 1 - 4 * xi_bar

        # the inner linesearch on eta (src/AdaProx.jl:516-533)
        def trial(eta, counters):
            # D + sqrt(D^2 + ...) is >= 0 but can round one ulp negative when D < 0
            # and the xi-term underflows next to D^2: clamped, as AdaPGMRule.update does
            denom_ls = torch.clamp_min(
                big_delta + torch.sqrt(big_delta**2 + m4xim1 * (t * eta * c.gamma) ** 2), 0.0)
            gamma_next = torch.minimum(
                c.gamma * torch.sqrt(1 + c.gamma / c.gamma_prev),
                torch.minimum(1 / (2 * big_theta * t * eta),
                              c.gamma * torch.sqrt(m4xim1 / (2 * delta1 * denom_ls))))
            rho = gamma_next / c.gamma
            sigma = t**2 * gamma_next
            w = c.y + sigma * ((1 + rho) * a_x - rho * c.a_x_prev)
            y_next, _ = h_conj.prox(w, sigma)
            at_y_next = a_op.rmatvec(y_next)
            ok = bool(eta >= torch.sqrt(l2sq(at_y_next - c.at_y))
                      / torch.sqrt(l2sq(y_next - c.y)))  # the host sync of each trial
            return (eta, gamma_next, sigma, w, y_next, at_y_next, ok,
                    counters.bump(prox_h_evals=1, At_evals=1))

        eta, gamma, sigma, w, y, at_y, ok, counters = trial(big_r * c.eta, counters)
        trials = 0
        while not ok and trials < _MAX_TRIALS:  # a NaN ratio fails every trial
            eta, gamma, sigma, w, y, at_y, ok, counters = trial(eta * r, counters)
            trials += 1

        dual_res = (w - y) / sigma - a_x
        norm_res = torch.sqrt(l2sq(primal_res) + l2sq(dual_res))
        ck = counters
        it = c.it + 1
        # the objective, uncounted, for the record only (src/AdaProx.jl:538-540)
        objective = f_x + g(c.x) + h(a_x) if history else torch.zeros_like(f_x)
        row = (it, gamma, sigma, norm_res, objective, ck)

        # outer half 2 (src/AdaProx.jl:545-547; the reference skips it on the
        # converging iteration: it is run and the at-check snapshot reported)
        v = c.x - gamma * (grad_x + at_y)
        x_new, _ = g.prox(v, gamma)
        counters = counters.bump(prox_g_evals=1)
        new = _Carry(it=it, x=x_new, v=v, y=y, at_y=at_y, x_prev=c.x, a_x_prev=a_x,
                     grad_prev=grad_x, gamma=gamma, gamma_prev=c.gamma, eta=eta,
                     counters=counters, norm_res=norm_res, ck_x=c.x, ck_counters=ck,
                     ls_failed=c.ls_failed or not ok,
                     done=bool(norm_res <= tol))  # the stop test's host sync
        return new, row

    final, rows = run_loop(carry0, step, maxit, history)
    converged = final.done
    return SolveResult(
        x=final.ck_x if converged else final.x, y=final.y, numit=final.it,
        norm_res=final.norm_res, counters=final.ck_counters if converged else final.counters,
        records=None if rows is None else Records.stack(rows, dtype=dt, device=dev),
        diag={"eta": final.eta, "trials_exhausted": torch.tensor(final.ls_failed, device=dev)})


def adaptive_linesearch_primal_dual(x0, y0, *, f, g, h, A, gamma=None, eta=1.0, t=1.0,
                                    delta=1e-8, Theta=1.2, r=2.0, R=0.95, tol=1e-5,
                                    maxit=10_000, name="AdaPDM+", history=False,
                                    resume_state=None, scalar_dtype=None, it_cap=None):
    """AdaPDM+ (reference src/AdaProx.jl:463-550) for min_x f(x) + g(x) + h(Ax): the
    fully adaptive primal-dual method, which needs no ||A||, only a first estimate
    ``eta``. ``eta`` and ``t`` must be positive and ``Theta > delta + 1``; ``gamma``
    defaults to, and may not exceed, 1/(2 Theta t eta).

    ``x0`` fixes the device and dtype of the solve; ``y0`` is the dual start.
    ``diag`` holds ``eta`` (the final estimate) and ``trials_exhausted`` (some
    linesearch hit the cap of 101 trials with the test still failing). On
    convergence the solve returns the x of the check, as the engine does.
    ``resume_state``, ``scalar_dtype`` and ``it_cap`` are not ported yet and raise
    ``NotImplementedError``."""
    # t <= 0 flips the sigma = t^2 gamma coupling and eta <= 0 breaks the
    # operator-norm estimate: both would NaN silently inside the loop
    validate_positive(eta=eta, t=t)
    if not Theta > delta + 1:
        raise ValueError("must have Theta > delta + 1")
    if gamma is None:
        gamma = 1.0 / (2 * Theta * t * eta)
    elif gamma > 1.0 / (2 * Theta * t * eta):
        raise ValueError("gamma is too large")
    for opt, val in (("resume_state", resume_state), ("scalar_dtype", scalar_dtype),
                     ("it_cap", it_cap)):
        if val is not None:
            raise NotImplementedError(f"{opt} is {_LATER}")
    if not isinstance(x0, torch.Tensor):
        raise TypeError("x0 must be a torch.Tensor; it sets the solve's device and dtype")
    y0 = torch.as_tensor(y0, dtype=x0.dtype, device=x0.device)
    res = _solve(f, g, h, A, x0, y0, gamma, eta, t, delta, Theta, r, R, tol, int(maxit),
                 bool(history))
    return res.with_name(name)
