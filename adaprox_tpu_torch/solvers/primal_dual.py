"""The adaptive primal-dual engine (AdaPDM) and its proximal-gradient
specializations (counterpart of ``adaprox_tpu/solvers/primal_dual.py``;
reference ``adaptive_primal_dual`` at src/AdaProx.jl:312-364).

Only the ``A=None`` case is ported: the proximal-gradient family, where the
dual residual is identically zero. Iteration (x: primal, v: pre-prox point):

    f_x, grad_x = f(x) with pullback
    p_res  = (v - x)/gamma + grad_x
    (gamma, sigma) <- rule(state, curvature(x, grad_x, x_prev, grad_prev))
    stop when ||p_res|| <= tol
    v = x - gamma grad_x; x = prox_{gamma g}(v)

The loop runs on the host over device tensors. The stop test reads
``norm_res <= tol`` on the host once per iteration (one device sync each);
everything else stays on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.prox import Zero
from . import rules as rules_mod
from .common import Counters, Records, SolveResult, l2sq, run_loop

__all__ = ["adaptive_primal_dual", "adaptive_proxgrad", "fixed_proxgrad"]

_LATER = "not ported yet: see ROADMAP.md, 'Engine behaviours still to port'"


class _Carry(NamedTuple):
    it: int
    x: torch.Tensor
    v: torch.Tensor
    x_prev: torch.Tensor
    grad_prev: torch.Tensor
    gamma: torch.Tensor
    sigma: torch.Tensor
    rstate: object
    counters: Counters
    norm_res: torch.Tensor
    ck_x: torch.Tensor  # x at the convergence check (the reference returns this)
    ck_counters: Counters  # counters at the check
    rule_nan: torch.Tensor  # latched: the rule produced a NaN step size
    done: bool


def _init(f, g, rule, x0):
    """Warm-up phase, reference src/AdaProx.jl:324-332."""
    (gamma, sigma), rstate = rule.init()
    counters = Counters.zeros()
    f_x, aux = f.value_and_aux(x0)
    grad = f.grad_from_aux(x0, aux)
    counters = counters.bump(f_evals=1, grad_f_evals=1)
    v = x0 - gamma * grad
    x1, _ = g.prox(v, gamma)
    counters = counters.bump(prox_g_evals=1)
    return _Carry(
        it=0, x=x1, v=v, x_prev=x0, grad_prev=grad, gamma=gamma, sigma=sigma,
        rstate=rstate, counters=counters,
        norm_res=torch.full_like(gamma, float("inf")), ck_x=x1, ck_counters=counters,
        # a NaN initial step is latched so it surfaces as diag["rule_nan"]
        rule_nan=torch.isnan(gamma), done=False,
    )


def _step(c: _Carry, *, f, g, rule, tol, with_objective):
    """One iteration (reference src/AdaProx.jl:334-362). Returns the new
    carry and the record row ``(it, gamma, sigma, norm_res, objective,
    counters)`` of this iteration."""
    counters = c.counters
    f_x, aux = f.value_and_aux(c.x)
    grad_x = f.grad_from_aux(c.x, aux)
    counters = counters.bump(f_evals=1, grad_f_evals=1)

    primal_res = (c.v - c.x) / c.gamma + grad_x
    curv = rules_mod.Curvature.of(c.x, grad_x, c.x_prev, c.grad_prev)
    (gamma, sigma), rstate = rule.update(c.rstate, curv)
    # a NaN step size makes every later stop test false: latch it
    rule_nan = c.rule_nan | torch.isnan(gamma) | torch.isnan(sigma)
    norm_res = torch.sqrt(l2sq(primal_res))
    ck_counters = counters
    it = c.it + 1

    # objective recomputed for logging only (src/AdaProx.jl:350-352)
    objective = f_x + g(c.x) if with_objective else torch.zeros_like(f_x)
    row = (it, gamma, sigma, norm_res, objective, ck_counters)

    # second half: the next primal point (the reference skips it on the
    # converging iteration; it is run and the at-check snapshot reported)
    v = c.x - gamma * grad_x
    x_new, _ = g.prox(v, gamma)
    counters = counters.bump(prox_g_evals=1)

    new = _Carry(
        it=it, x=x_new, v=v, x_prev=c.x, grad_prev=grad_x, gamma=gamma, sigma=sigma,
        rstate=rstate, counters=counters, norm_res=norm_res, ck_x=c.x,
        ck_counters=ck_counters, rule_nan=rule_nan,
        done=bool(norm_res <= tol),  # the per-iteration host sync
    )
    return new, row


def _solve_pg(f, g, rule, x0, tol, maxit, history):
    rule = rule.to(dtype=x0.dtype, device=x0.device)
    tol = torch.as_tensor(tol, dtype=x0.dtype, device=x0.device)
    carry0 = _init(f, g, rule, x0)
    final, rows = run_loop(
        carry0,
        lambda c: _step(c, f=f, g=g, rule=rule, tol=tol, with_objective=history),
        maxit, history)
    converged = final.done
    return SolveResult(
        x=final.ck_x if converged else final.x,
        y=None,
        numit=final.it,
        norm_res=final.norm_res,
        counters=final.ck_counters if converged else final.counters,
        records=None if rows is None else Records.stack(
            rows, dtype=x0.dtype, device=x0.device),
        diag={"gamma": final.gamma, "rule_nan": final.rule_nan},
    )


def adaptive_primal_dual(
    x0,
    y0=None,
    *,
    f,
    g,
    h=None,
    A=None,
    rule,
    tol=1e-5,
    maxit=10_000,
    name="AdaPDM",
    history=False,
    resume_state=None,
    scalar_dtype=None,
    it_cap=None,
):
    """Adaptive primal-dual (AdaPDM) for min_x f(x) + g(x) + h(Ax), ported
    for ``A=None``: the proximal-gradient family.

    ``x0`` fixes the device and dtype of the solve. ``history=True`` returns
    one record row per iteration that ran. The dual branch (``A``, ``h``,
    ``y0``), ``resume_state``, ``scalar_dtype`` and ``it_cap`` are not ported
    yet and raise ``NotImplementedError``.
    """
    if A is not None or y0 is not None:
        raise NotImplementedError(f"the dual branch (A, y0) is {_LATER}")
    if h is not None and not isinstance(h, Zero):
        # the dual term is h(Ax): silently dropping h would solve another problem
        raise ValueError("h was given without A; pass A or drop h")
    for opt, val in (("resume_state", resume_state), ("scalar_dtype", scalar_dtype),
                     ("it_cap", it_cap)):
        if val is not None:
            raise NotImplementedError(f"{opt} is {_LATER}")
    if not isinstance(x0, torch.Tensor):
        raise TypeError("x0 must be a torch.Tensor; it sets the solve's device and dtype")
    res = _solve_pg(f, g, rule, x0, tol, int(maxit), bool(history))
    return res.with_name(name)


def adaptive_proxgrad(x0, *, f, g, rule, tol=1e-5, maxit=100_000, name="AdaPGM",
                      history=False, resume_state=None, scalar_dtype=None,
                      it_cap=None):
    """Adaptive proximal gradient: the engine with h=Zero, A=0 (reference
    src/AdaProx.jl:418-421)."""
    return adaptive_primal_dual(
        x0, f=f, g=g, rule=rule, tol=tol, maxit=maxit, name=name,
        history=history, resume_state=resume_state, scalar_dtype=scalar_dtype,
        it_cap=it_cap,
    )


def fixed_proxgrad(x0, *, f, g, gamma, tol=1e-5, maxit=100_000,
                   name="Fixed stepsize PGM", history=False, resume_state=None,
                   scalar_dtype=None, it_cap=None):
    """Fixed-stepsize PGM (reference src/AdaProx.jl:457-459)."""
    rule = rules_mod.FixedStepsize(gamma=gamma, t=1.0)
    return adaptive_proxgrad(
        x0, f=f, g=g, rule=rule, tol=tol, maxit=maxit, name=name, history=history,
        resume_state=resume_state, scalar_dtype=scalar_dtype, it_cap=it_cap,
    )
