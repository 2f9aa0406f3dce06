"""Backtracking proximal gradient and backtracking Nesterov, with Beck's
sufficient-descent test (counterpart of ``adaprox_tpu/solvers/backtracking.py``;
reference src/AdaProx.jl:28-84).

Each trial costs one prox and one f evaluation; the gradient at the accepted
point is finished once from the carried forward-pass ``aux`` (the reference's
lazy pullback, src/AdaProx.jl:37,45,61). The loop runs on the host over
device tensors, as the engine does (``solvers/primal_dual.py``): the trial
loop reads the sufficient-descent test on the host, one device sync a trial,
and the stop test once an iteration.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .common import Counters, Records, SolveResult, l2sq, run_loop

__all__ = ["backtracking_proxgrad", "backtracking_nesterov"]

_LATER = "not ported yet: see ROADMAP.md, 'Engine behaviours still to port'"

# the cap on halvings after the first trial: at most 101 prox/f evaluations an
# iteration (the reference loops unboundedly, src/AdaProx.jl:40-42)
_MAX_TRIALS = 100


def _backtrack(gamma, x, f_x, grad_x, aux_x, *, f, g, counters, shrink, exact_bregman):
    """``backtrack_stepsize`` (src/AdaProx.jl:34-48): shrink gamma until the
    quadratic upper bound holds. Returns (gamma, z, f_z, g_z, aux_z, counters,
    failed); ``failed`` is True when the cap was hit with the test still
    violated."""

    def trial(gamma, counters):
        z, g_z = g.prox(x - gamma * grad_x, gamma)
        f_z, aux = f.value_and_aux(z)
        return z, g_z, f_z, aux, counters.bump(prox_g_evals=1, f_evals=1)

    def violates(gamma, z, f_z, aux_z):
        dz = z - x
        if exact_bregman:
            # the cancellation-resistant Bregman form, where the oracle has one
            breg = f.bregman_from_aux(dz, aux_z, aux_x)
            if breg is not None:
                return bool(breg > l2sq(dz) / (2 * gamma))
        # the reference's operand order: the knife-edge trial counts depend on it
        return bool(f_z > f_x + torch.dot(grad_x, dz) + l2sq(dz) / (2 * gamma))

    z, g_z, f_z, aux, counters = trial(gamma, counters)
    trials = 0
    failed = violates(gamma, z, f_z, aux)  # the host sync of each trial
    while failed and trials < _MAX_TRIALS:
        gamma = gamma * shrink
        z, g_z, f_z, aux, counters = trial(gamma, counters)
        trials += 1
        failed = violates(gamma, z, f_z, aux)
    return gamma, z, f_z, g_z, aux, counters, failed


class _Carry(NamedTuple):
    it: int
    x: torch.Tensor       # point where (f_x, grad_x) are evaluated
    z: torch.Tensor       # last accepted backtracked point
    gamma: torch.Tensor
    f_x: torch.Tensor
    grad_x: torch.Tensor
    aux_x: object         # oracle aux at x (feeds the exact-Bregman test)
    theta: torch.Tensor   # momentum (Nesterov only; 1 otherwise)
    counters: Counters
    ck_counters: Counters  # counters at the record of the last iteration
    norm_res: torch.Tensor
    ls_failed: bool        # latched: some backtrack exhausted the cap
    done: bool


def _solve_bt(f, g, x0, gamma0, xi, shrink, tol, maxit, history, nesterov, exact_bregman):
    dt, dev = x0.dtype, x0.device
    gamma0, xi, shrink, tol = (torch.as_tensor(v, dtype=dt, device=dev)
                               for v in (gamma0, xi, shrink, tol))
    f_x0, aux0 = f.value_and_aux(x0)
    grad0 = f.grad_from_aux(x0, aux0)
    counters = Counters.zeros().bump(f_evals=1, grad_f_evals=1)
    carry0 = _Carry(it=0, x=x0, z=x0, gamma=gamma0, f_x=f_x0, grad_x=grad0, aux_x=aux0,
                    theta=torch.ones((), dtype=dt, device=dev), counters=counters,
                    ck_counters=counters, norm_res=torch.full_like(gamma0, math.inf),
                    ls_failed=False, done=False)

    def step(c):
        # PG inflates the trial step by xi each iteration (src/AdaProx.jl:54);
        # Nesterov does not (src/AdaProx.jl:72)
        trial_gamma = c.gamma * (1.0 if nesterov else xi)
        gamma, z, f_z, g_z, aux, counters, bt_failed = _backtrack(
            trial_gamma, c.x, c.f_x, c.grad_x, c.aux_x, f=f, g=g, counters=c.counters,
            shrink=shrink, exact_bregman=exact_bregman)
        norm_res = torch.sqrt(l2sq(z - c.x)) / gamma
        ck = counters
        it = c.it + 1
        row = (it, gamma, torch.zeros_like(gamma), norm_res, f_z + g_z, ck)
        if nesterov:
            theta = (1 + torch.sqrt(1 + 4 * c.theta**2)) / 2
            x = z + ((c.theta - 1) / theta) * (z - c.z)
            f_x, aux_x = f.value_and_aux(x)
            grad_x = f.grad_from_aux(x, aux_x)
            counters = counters.bump(f_evals=1, grad_f_evals=1)
        else:
            theta, x, f_x, aux_x = c.theta, z, f_z, aux
            grad_x = f.grad_from_aux(z, aux)
            counters = counters.bump(grad_f_evals=1)
        new = _Carry(it=it, x=x, z=z, gamma=gamma, f_x=f_x, grad_x=grad_x, aux_x=aux_x,
                     theta=theta, counters=counters, ck_counters=ck, norm_res=norm_res,
                     ls_failed=c.ls_failed or bt_failed,
                     done=bool(norm_res <= tol))  # the stop test's host sync
        return new, row

    final, rows = run_loop(carry0, step, maxit, history)
    # converged: the counters at the check (the reference returns before the
    # last pullback or momentum evaluation); otherwise all of them
    converged = bool(final.norm_res <= tol)
    return SolveResult(
        x=final.z, y=None, numit=final.it, norm_res=final.norm_res,
        counters=final.ck_counters if converged else final.counters,
        records=None if rows is None else Records.stack(rows, dtype=dt, device=dev),
        diag={"gamma": final.gamma, "stepsize_underflow": final.gamma < 1e-12,
              "trials_exhausted": torch.tensor(final.ls_failed, device=dev)})


def _refuse_later(**opts):
    for opt, val in opts.items():
        if val is not None:
            raise NotImplementedError(f"{opt} is {_LATER}")


def backtracking_proxgrad(x0, *, f, g, gamma0, xi=1.0, shrink=0.5, tol=1e-5, maxit=100_000,
                          name="Backtracking PG", history=False, resume_state=None,
                          scalar_dtype=None, exact_bregman=False, it_cap=None):
    """Proximal gradient with sufficient-descent backtracking and the
    per-iteration step inflation ``xi`` (reference src/AdaProx.jl:50-64).

    ``x0`` fixes the device and dtype of the solve. ``exact_bregman``: the
    sufficient-descent test through the oracle's cancellation-resistant
    Bregman form where it has one (``SmoothOracle.bregman_from_aux``), else
    the raw test. ``diag`` holds ``gamma``, ``stepsize_underflow`` (gamma
    below 1e-12) and ``trials_exhausted`` (some backtrack hit the cap of 101
    evaluations with the test still violated). ``resume_state``,
    ``scalar_dtype`` and ``it_cap`` are not ported yet and raise
    ``NotImplementedError``."""
    _refuse_later(resume_state=resume_state, scalar_dtype=scalar_dtype, it_cap=it_cap)
    if not isinstance(x0, torch.Tensor):
        raise TypeError("x0 must be a torch.Tensor; it sets the solve's device and dtype")
    res = _solve_bt(f, g, x0, gamma0, xi, shrink, tol, int(maxit), bool(history), False,
                    bool(exact_bregman))
    return res.with_name(name)


def backtracking_nesterov(x0, *, f, g, gamma0, shrink=0.5, tol=1e-5, maxit=100_000,
                          name="Backtracking Nesterov", history=False, resume_state=None,
                          scalar_dtype=None, exact_bregman=False, it_cap=None):
    """Accelerated proximal gradient with backtracking and the momentum
    recurrence theta' = (1 + sqrt(1 + 4 theta^2)) / 2 (reference
    src/AdaProx.jl:66-84). Arguments as ``backtracking_proxgrad``."""
    _refuse_later(resume_state=resume_state, scalar_dtype=scalar_dtype, it_cap=it_cap)
    if not isinstance(x0, torch.Tensor):
        raise TypeError("x0 must be a torch.Tensor; it sets the solve's device and dtype")
    res = _solve_bt(f, g, x0, gamma0, 1.0, shrink, tol, int(maxit), bool(history), True,
                    bool(exact_bregman))
    return res.with_name(name)
