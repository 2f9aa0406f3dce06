"""Malitsky-Pock primal-dual with linesearch (counterpart of
``adaprox_tpu/solvers/malitsky_pock.py``; Algorithm 4 of "A first-order
primal-dual algorithm with linesearch", applied to the dual; reference
src/AdaProx.jl:552-629).

Each outer iteration takes the dual step, grows sigma by sqrt(2) and halves it
until

    gamma*sigma*||A x - A x_prev||^2
      + 2*gamma*(f(x) - f(x_prev) - <grad_prev, x - x_prev>)  <=  0.95 ||x - x_prev||^2

with gamma = t^2 sigma. Each trial costs one prox_g, one A-matvec and one f
evaluation; the gradient at the accepted x is finished once from its ``aux``.
The loop runs on the host over device tensors, as the engine does
(``solvers/primal_dual.py``): the trial loop reads the acceptance test on the
host, one device sync a trial, and the stop test once an iteration.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import prox as prox_ops
from .common import Counters, Records, SolveResult, l2sq, run_loop
from .rules import validate_positive

__all__ = ["malitsky_pock"]

_LATER = "not ported yet: see ROADMAP.md, 'Engine behaviours still to port'"

# halvings after the first trial: at most 101 trials an iteration
_MAX_TRIALS = 100


class _Carry(NamedTuple):
    it: int
    x: torch.Tensor
    y: torch.Tensor
    a_x: torch.Tensor
    at_y: torch.Tensor
    sigma: torch.Tensor
    counters: Counters
    norm_res: torch.Tensor
    ls_failed: bool  # latched: some linesearch exhausted _MAX_TRIALS
    done: bool


def _solve(f, g, h, a_op, x0, y0, sigma0, t, tol, maxit, history, exact_bregman):
    dt, dev = x0.dtype, x0.device
    h_conj = prox_ops.conjugate(h)
    t, tol, sigma0 = (torch.as_tensor(v, dtype=dt, device=dev) for v in (t, tol, sigma0))
    # the reference sets theta = 1 once and never updates it in the outer loop
    # (src/AdaProx.jl:597), so sigma grows by sqrt(2) each iteration
    sqrt2 = torch.sqrt(torch.tensor(2.0, dtype=dt, device=dev))
    carry0 = _Carry(it=0, x=x0, y=y0, a_x=a_op.matvec(x0), at_y=a_op.rmatvec(y0), sigma=sigma0,
                    counters=Counters.zeros().bump(A_evals=1, At_evals=1),
                    norm_res=torch.full_like(sigma0, math.inf), ls_failed=False, done=False)

    def step(c):
        # the dual step (src/AdaProx.jl:600-603)
        at_y_prev = c.at_y
        w = c.y + c.sigma * c.a_x
        y, _ = h_conj.prox(w, c.sigma)
        at_y = a_op.rmatvec(y)
        counters = c.counters.bump(prox_h_evals=1, At_evals=1)
        sigma_prev = c.sigma
        f_x_prev, aux_prev = f.value_and_aux(c.x)
        grad_x_prev = f.grad_from_aux(c.x, aux_prev)
        counters = counters.bump(f_evals=1, grad_f_evals=1)
        x_prev, a_x_prev = c.x, c.a_x

        # the linesearch on sigma (backtrack_stepsize_MP, src/AdaProx.jl:555-579)
        def trial(sigma, counters):
            theta = sigma / sigma_prev
            gamma = t * t * sigma
            at_ybar = (1 + theta) * at_y - theta * at_y_prev
            v = x_prev - gamma * (at_ybar + grad_x_prev)
            x, _ = g.prox(v, gamma)
            a_x = a_op.matvec(x)
            f_x, aux = f.value_and_aux(x)
            dx = x - x_prev
            breg = f.bregman_from_aux(dx, aux, aux_prev) if exact_bregman else None
            if breg is None:  # the reference's raw difference
                breg = f_x - f_x_prev - torch.dot(grad_x_prev, dx)
            lhs = gamma * sigma * l2sq(a_x - a_x_prev) + 2 * gamma * breg
            failed = bool(lhs > 0.95 * l2sq(dx))  # the host sync of each trial
            return (sigma, gamma, x, v, a_x, f_x, aux, failed,
                    counters.bump(prox_g_evals=1, A_evals=1, f_evals=1))

        sigma, gamma, x, v, a_x, f_x, aux, failed, counters = trial(sigma_prev * sqrt2, counters)
        trials = 0
        while failed and trials < _MAX_TRIALS:
            sigma, gamma, x, v, a_x, f_x, aux, failed, counters = trial(sigma / 2, counters)
            trials += 1
        grad_x = f.grad_from_aux(x, aux)
        counters = counters.bump(grad_f_evals=1)
        primal_res = (v - x) / gamma + grad_x + at_y
        dual_res = (w - y) / sigma_prev - a_x
        norm_res = torch.sqrt(l2sq(primal_res) + l2sq(dual_res))
        it = c.it + 1
        # the objective, uncounted, for the record only (src/AdaProx.jl:620-622)
        objective = f_x + g(x) + h(a_x) if history else torch.zeros_like(f_x)
        row = (it, gamma, sigma, norm_res, objective, counters)
        new = _Carry(it=it, x=x, y=y, a_x=a_x, at_y=at_y, sigma=sigma, counters=counters,
                     norm_res=norm_res, ls_failed=c.ls_failed or failed,
                     done=bool(norm_res <= tol))  # the stop test's host sync
        return new, row

    final, rows = run_loop(carry0, step, maxit, history)
    return SolveResult(
        x=final.x, y=final.y, numit=final.it, norm_res=final.norm_res, counters=final.counters,
        records=None if rows is None else Records.stack(rows, dtype=dt, device=dev),
        # cf. the reference's underflow error at src/AdaProx.jl:566-568
        diag={"sigma": final.sigma, "stepsize_underflow": final.sigma < 1e-12,
              "trials_exhausted": torch.tensor(final.ls_failed, device=dev)})


def malitsky_pock(x0, y0, *, f, g, h, A, sigma, t=1.0, tol=1e-5, maxit=10_000, name="MP-ls",
                  history=False, resume_state=None, scalar_dtype=None, exact_bregman=False,
                  it_cap=None):
    """Malitsky-Pock linesearch primal-dual for min_x f(x) + g(x) + h(Ax)
    (reference src/AdaProx.jl:581-629). ``t`` couples the steps through gamma
    = t^2 sigma; ``sigma`` is the first dual step. Both must be positive.

    ``x0`` fixes the device and dtype of the solve; ``y0`` is the dual start.
    ``exact_bregman``: the acceptance test's Bregman term through the
    oracle's cancellation-resistant form where it has one
    (``SmoothOracle.bregman_from_aux``: 0.5 <dx, Q dx> for the quadratics),
    else the reference's raw difference, whose eps*|f| noise stalls f32
    solves at the dual SVM's scale. ``diag`` holds ``sigma``,
    ``stepsize_underflow`` (sigma below 1e-12) and ``trials_exhausted`` (some
    linesearch hit the cap of 101 trials with the test still failing). The
    solve returns the last x (there is no check snapshot here).
    ``resume_state``, ``scalar_dtype`` and ``it_cap`` are not ported yet and
    raise ``NotImplementedError``."""
    validate_positive(sigma=sigma, t=t)
    for opt, val in (("resume_state", resume_state), ("scalar_dtype", scalar_dtype),
                     ("it_cap", it_cap)):
        if val is not None:
            raise NotImplementedError(f"{opt} is {_LATER}")
    if not isinstance(x0, torch.Tensor):
        raise TypeError("x0 must be a torch.Tensor; it sets the solve's device and dtype")
    y0 = torch.as_tensor(y0, dtype=x0.dtype, device=x0.device)
    res = _solve(f, g, h, A, x0, y0, sigma, t, tol, int(maxit), bool(history),
                 bool(exact_bregman))
    return res.with_name(name)
