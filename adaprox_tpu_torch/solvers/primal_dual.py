"""The adaptive primal-dual engine (AdaPDM) and its proximal-gradient
specializations (counterpart of ``adaprox_tpu/solvers/primal_dual.py``;
reference ``adaptive_primal_dual`` at src/AdaProx.jl:312-364).

Iteration (x: primal, y: dual, v: pre-prox point):

    A_x    = A x
    f_x, grad_x = f(x) with pullback
    p_res  = (v - x)/gamma + grad_x + A' y
    (gamma, sigma) <- rule(state, curvature(x, grad_x, x_prev, grad_prev))
    rho    = gamma / gamma_prev
    w      = y + sigma ((1+rho) A_x - rho A_x_prev)
    y      = prox_{sigma h*}(w)
    d_res  = (w - y)/sigma - A_x
    stop when ||(p_res, d_res)|| <= tol
    A'y; v = x - gamma (grad_x + A'y); x = prox_{gamma g}(v)

With ``A=None`` every dual term is dropped (the proximal-gradient family,
where the dual residual is identically zero), and the iteration is exactly
what it was before the dual branch existed.

The loop runs on the host over device tensors. The stop test reads
``norm_res <= tol`` on the host once per iteration (one device sync each);
everything else stays on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import prox as prox_ops
from . import rules as rules_mod
from .common import Counters, Records, SolveResult, l2sq, run_loop

__all__ = ["adaptive_primal_dual", "adaptive_proxgrad", "fixed_proxgrad", "condat_vu",
           "condat_vu_steps"]

_LATER = "not ported yet: see ROADMAP.md, 'Engine behaviours still to port'"


class _Carry(NamedTuple):
    it: int
    x: torch.Tensor
    v: torch.Tensor
    y: Optional[torch.Tensor]  # the dual iterate (None without A)
    at_y: Optional[torch.Tensor]  # A'y (None without A)
    x_prev: torch.Tensor
    a_x_prev: Optional[torch.Tensor]  # A x_prev (None without A)
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


def _init(f, g, a_op, rule, x0, y0):
    """Warm-up phase, reference src/AdaProx.jl:324-332."""
    (gamma, sigma), rstate = rule.init()
    counters = Counters.zeros()
    dual = a_op is not None
    a_x = at_y = None
    if dual:
        a_x = a_op.matvec(x0)
        counters = counters.bump(A_evals=1)
    f_x, aux = f.value_and_aux(x0)
    grad = f.grad_from_aux(x0, aux)
    counters = counters.bump(f_evals=1, grad_f_evals=1)
    if dual:
        at_y = a_op.rmatvec(y0)
        counters = counters.bump(At_evals=1)
        v = x0 - gamma * (grad + at_y)
    else:
        v = x0 - gamma * grad
    x1, _ = g.prox(v, gamma)
    counters = counters.bump(prox_g_evals=1)
    return _Carry(
        it=0, x=x1, v=v, y=y0 if dual else None, at_y=at_y, x_prev=x0, a_x_prev=a_x,
        grad_prev=grad, gamma=gamma, sigma=sigma, rstate=rstate, counters=counters,
        norm_res=torch.full_like(gamma, float("inf")), ck_x=x1, ck_counters=counters,
        # a NaN initial step is latched so it surfaces as diag["rule_nan"]
        rule_nan=torch.isnan(gamma), done=False,
    )


def _step(c: _Carry, *, f, g, h, h_conj, a_op, rule, tol, with_objective):
    """One iteration (reference src/AdaProx.jl:334-362). Returns the new
    carry and the record row ``(it, gamma, sigma, norm_res, objective,
    counters)`` of this iteration."""
    dual = a_op is not None
    counters = c.counters

    # first half: evaluate, adapt the steps, the dual update, the residuals
    a_x = None
    if dual:
        a_x = a_op.matvec(c.x)
        counters = counters.bump(A_evals=1)
    f_x, aux = f.value_and_aux(c.x)
    grad_x = f.grad_from_aux(c.x, aux)
    counters = counters.bump(f_evals=1, grad_f_evals=1)

    primal_res = (c.v - c.x) / c.gamma + grad_x
    if dual:
        primal_res = primal_res + c.at_y
    curv = rules_mod.Curvature.of(c.x, grad_x, c.x_prev, c.grad_prev)
    (gamma, sigma), rstate = rule.update(c.rstate, curv)
    # a NaN step size makes every later stop test false: latch it
    rule_nan = c.rule_nan | torch.isnan(gamma) | torch.isnan(sigma)
    if dual:
        rho = gamma / c.gamma
        w = c.y + sigma * ((1 + rho) * a_x - rho * c.a_x_prev)
        y, _ = h_conj.prox(w, sigma)
        counters = counters.bump(prox_h_evals=1)
        dual_res = (w - y) / sigma - a_x
        norm_res = torch.sqrt(l2sq(primal_res) + l2sq(dual_res))
    else:
        y = None
        norm_res = torch.sqrt(l2sq(primal_res))
    ck_counters = counters
    it = c.it + 1

    # objective recomputed for logging only (src/AdaProx.jl:350-352)
    if with_objective:
        objective = f_x + g(c.x)
        if dual:
            objective = objective + h(a_x)
    else:
        objective = torch.zeros_like(f_x)
    row = (it, gamma, sigma, norm_res, objective, ck_counters)

    # second half: the next primal point (the reference skips it on the
    # converging iteration; it is run and the at-check snapshot reported)
    if dual:
        at_y = a_op.rmatvec(y)
        counters = counters.bump(At_evals=1)
        v = c.x - gamma * (grad_x + at_y)
    else:
        at_y = None
        v = c.x - gamma * grad_x
    x_new, _ = g.prox(v, gamma)
    counters = counters.bump(prox_g_evals=1)

    new = _Carry(
        it=it, x=x_new, v=v, y=y, at_y=at_y, x_prev=c.x, a_x_prev=a_x, grad_prev=grad_x,
        gamma=gamma, sigma=sigma, rstate=rstate, counters=counters, norm_res=norm_res,
        ck_x=c.x, ck_counters=ck_counters, rule_nan=rule_nan,
        done=bool(norm_res <= tol),  # the per-iteration host sync
    )
    return new, row


def _solve_pd(f, g, h, a_op, rule, x0, y0, tol, maxit, history):
    rule = rule.to(dtype=x0.dtype, device=x0.device)
    tol = torch.as_tensor(tol, dtype=x0.dtype, device=x0.device)
    h_conj = prox_ops.conjugate(h) if h is not None else None
    carry0 = _init(f, g, a_op, rule, x0, y0)
    final, rows = run_loop(
        carry0,
        lambda c: _step(c, f=f, g=g, h=h, h_conj=h_conj, a_op=a_op, rule=rule, tol=tol,
                        with_objective=history),
        maxit, history)
    converged = final.done
    return SolveResult(
        x=final.ck_x if converged else final.x,
        y=final.y,
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
    """Adaptive primal-dual (AdaPDM) for min_x f(x) + g(x) + h(Ax).

    ``x0`` fixes the device and dtype of the solve; ``y0`` (the dual start)
    is required with ``A`` (a linear operator with ``matvec``, ``rmatvec``),
    and ``h`` defaults to ``Zero`` then. With ``A=None`` this is the
    proximal-gradient family; ``h`` or ``y0`` without ``A`` is refused.
    ``history=True`` returns one record row per iteration that ran.
    ``resume_state``, ``scalar_dtype`` and ``it_cap`` are not ported yet and
    raise ``NotImplementedError``.
    """
    if A is not None and y0 is None:
        raise ValueError("y0 is required when A is given")
    if A is None:
        # the dual term is h(Ax): silently dropping a user-supplied h or y0
        # would solve another problem
        if h is not None and not isinstance(h, prox_ops.Zero):
            raise ValueError("h was given without A; pass A or drop h")
        if y0 is not None:
            raise ValueError("y0 was given without A")
        h = None
    elif h is None:
        h = prox_ops.Zero()  # h omitted with a real A: h(Ax) = 0
    for opt, val in (("resume_state", resume_state), ("scalar_dtype", scalar_dtype),
                     ("it_cap", it_cap)):
        if val is not None:
            raise NotImplementedError(f"{opt} is {_LATER}")
    if not isinstance(x0, torch.Tensor):
        raise TypeError("x0 must be a torch.Tensor; it sets the solve's device and dtype")
    if y0 is not None:
        y0 = torch.as_tensor(y0, dtype=x0.dtype, device=x0.device)
    res = _solve_pd(f, g, h, A, rule, x0, y0, tol, int(maxit), bool(history))
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


def condat_vu_steps(lf, norm_a):
    """(gamma, sigma) from the reference's scaling heuristics
    (src/AdaProx.jl:396-412, par = 5, par2 = 100), in the dtype of the 0-d
    tensor ``norm_a``: alpha = 1 whenever norm_a > par * lf, so lf = 0 stays
    finite."""
    par, par2 = 5.0, 100.0
    alpha = torch.where(norm_a > par * lf, torch.ones_like(norm_a), par2 * norm_a / lf)
    gamma = 1.0 / (lf / 2 + norm_a / alpha)
    sigma = 0.99 / (norm_a * alpha)
    return gamma, sigma


def condat_vu(x0, y0, *, f, g, h, A, Lf, gamma=None, sigma=None, norm_A=None, tol=1e-5,
              maxit=10_000, name="Condat-Vu", history=False, resume_state=None,
              scalar_dtype=None, it_cap=None):
    """Condat-Vu fixed-step primal-dual: (gamma, sigma) from Lf and ||A||
    (``A.norm()`` unless ``norm_A`` is given) with the reference's scaling
    heuristics (src/AdaProx.jl:367-416), in the iterate dtype, then the
    engine with ``FixedStepsize(gamma, t = sqrt(sigma / gamma))``."""
    if gamma is None and sigma is None:
        if norm_A is None:
            norm_A = A.norm()
        norm_A = torch.as_tensor(norm_A, dtype=x0.dtype, device=x0.device)
        gamma, sigma = condat_vu_steps(torch.as_tensor(Lf, dtype=x0.dtype, device=x0.device),
                                       norm_A)
    if gamma is None or sigma is None:
        raise ValueError("provide both gamma and sigma, or neither")
    gamma = torch.as_tensor(gamma, dtype=x0.dtype, device=x0.device)
    sigma = torch.as_tensor(sigma, dtype=x0.dtype, device=x0.device)
    rule = rules_mod.FixedStepsize(gamma=gamma, t=torch.sqrt(sigma / gamma))
    return adaptive_primal_dual(
        x0, y0, f=f, g=g, h=h, A=A, rule=rule, tol=tol, maxit=maxit, name=name,
        history=history, resume_state=resume_state, scalar_dtype=scalar_dtype, it_cap=it_cap)
