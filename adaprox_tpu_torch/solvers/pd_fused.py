"""The primal-dual engine on the fused one-pass update K5 (counterpart of
``adaprox_tpu/solvers/pd_fused.py``).

The same algorithm as ``solvers.primal_dual.adaptive_primal_dual`` (reference
src/AdaProx.jl:312-364), with the iteration re-cut so that its two matvecs
(A x at :335, A'y at :358) become one pass over A': half 2 of iteration k
(A'y, the primal prox) runs with half 1 of iteration k + 1 (A x_new) in
``ops.pd_kernels.fused_pd_primal_update``. The carry holds ``a_x``, A x of the
current iterate from the previous fused pass, so no standalone A x runs after
the warm-up. Only A' is needed.

It applies when g's prox is in the kernel's menu (l1, box, elastic, zero); h and
the dual prox keep full generality (vector ops on m-vectors), and f is any smooth
oracle. Counters, records and the stop test are the engine's: A_evals and
At_evals each +1 an iteration, since the fused pass is both calls.

The loop runs on the host, like the engine's: one host sync an iteration (the
stop test). The step size reaches the kernel as a 0-d tensor on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import oracles, pd_kernels, prox as prox_ops
from ..ops.linops import acc_dtype, storage_norm
from . import rules as rules_mod
from .common import Counters, Records, SolveResult, l2sq, run_loop
from .primal_dual import condat_vu_steps

__all__ = ["fused_adaptive_primal_dual", "fused_condat_vu", "prox_menu_entry"]

_LATER = "not ported yet: see ROADMAP.md, 'Engine behaviours still to port'"


def prox_menu_entry(g):
    """g as the kernel's menu entry (kind, p1, p2), or None when its prox has no
    separable closed form there."""
    if isinstance(g, prox_ops.L1Norm):
        return "l1", g.lam, 0.0
    if isinstance(g, prox_ops.IndBox):
        return "box", g.lo, g.hi
    if isinstance(g, prox_ops.ElasticNet):
        return "elastic", g.lam1, g.lam2
    if isinstance(g, prox_ops.Zero):
        return "zero", 0.0, 0.0
    return None


class _Carry(NamedTuple):
    it: int
    x: torch.Tensor
    v: torch.Tensor
    y: torch.Tensor
    a_x: torch.Tensor  # A x of the current x (from the fused pass)
    at_y: torch.Tensor  # A'y of the current y
    x_prev: torch.Tensor
    a_x_prev: torch.Tensor
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


def _solve(f, g, h, at, rule, x0, y0, p1, p2, tol, maxit, history, prox_kind):
    dt, dev = x0.dtype, x0.device
    rule = rule.to(dtype=dt, device=dev)
    tol = torch.as_tensor(tol, dtype=dt, device=dev)
    h_conj = prox_ops.conjugate(h)

    def fused(y, x, grad, gamma):
        return pd_kernels.fused_pd_primal_update(at, y, x, grad, gamma, p1, p2,
                                                 prox_kind=prox_kind)

    # warm-up (src/AdaProx.jl:324-332): one standalone A x0, then the first fused
    # pass plays the engine's first half 2
    (gamma, sigma), rstate = rule.init()
    a_x0 = torch.mv(at.to(acc_dtype(at, x0)).t(), x0)
    _, aux0 = f.value_and_aux(x0)
    grad0 = f.grad_from_aux(x0, aux0)
    counters = Counters.zeros().bump(A_evals=1, f_evals=1, grad_f_evals=1)
    at_y0, v, x1, a_x1 = fused(y0, x0, grad0, gamma)
    counters = counters.bump(At_evals=1, prox_g_evals=1, A_evals=1)
    carry0 = _Carry(
        it=0, x=x1, v=v, y=y0, a_x=a_x1, at_y=at_y0, x_prev=x0, a_x_prev=a_x0,
        grad_prev=grad0, gamma=gamma, sigma=sigma, rstate=rstate, counters=counters,
        norm_res=torch.full_like(gamma, float("inf")), ck_x=x1, ck_counters=counters,
        rule_nan=torch.isnan(gamma), done=False)

    def step(c):
        counters = c.counters
        # a_x of the current x came from the previous fused pass; the engine
        # charges it as this iteration's A_eval (src/AdaProx.jl:335)
        f_x, aux = f.value_and_aux(c.x)
        grad_x = f.grad_from_aux(c.x, aux)
        counters = counters.bump(f_evals=1, grad_f_evals=1)
        primal_res = (c.v - c.x) / c.gamma + grad_x + c.at_y
        curv = rules_mod.Curvature.of(c.x, grad_x, c.x_prev, c.grad_prev)
        (gamma, sigma), rstate = rule.update(c.rstate, curv)
        rule_nan = c.rule_nan | torch.isnan(gamma) | torch.isnan(sigma)
        rho = gamma / c.gamma
        w = c.y + sigma * ((1 + rho) * c.a_x - rho * c.a_x_prev)
        y, _ = h_conj.prox(w, sigma)
        counters = counters.bump(prox_h_evals=1)
        dual_res = (w - y) / sigma - c.a_x
        norm_res = torch.sqrt(l2sq(primal_res) + l2sq(dual_res))
        ck = counters
        it = c.it + 1
        objective = f_x + g(c.x) + h(c.a_x) if history else torch.zeros_like(f_x)
        row = (it, gamma, sigma, norm_res, objective, ck)

        # the per-iteration host sync, taken before the fused pass is launched: the
        # pass then runs on the card while the host queues the next iteration
        done = bool(norm_res <= tol)
        # half 2 with the next half 1: one pass over A' (run on the converging
        # iteration too, as the reference's scan does; its snapshot is reported)
        at_y, v, x_new, a_x_new = fused(y, c.x, grad_x, gamma)
        counters = counters.bump(At_evals=1, prox_g_evals=1, A_evals=1)
        new = _Carry(
            it=it, x=x_new, v=v, y=y, a_x=a_x_new, at_y=at_y, x_prev=c.x, a_x_prev=c.a_x,
            grad_prev=grad_x, gamma=gamma, sigma=sigma, rstate=rstate, counters=counters,
            norm_res=norm_res, ck_x=c.x, ck_counters=ck, rule_nan=rule_nan, done=done)
        return new, row

    final, rows = run_loop(carry0, step, maxit, history)
    # the fused pass ran one A_eval ahead (the next iteration's A x); at the
    # convergence check the reference has not made that call yet, so the check's
    # snapshot is reported
    converged = final.done
    return SolveResult(
        x=final.ck_x if converged else final.x,
        y=final.y,
        numit=final.it,
        norm_res=final.norm_res,
        counters=final.ck_counters if converged else final.counters,
        records=None if rows is None else Records.stack(rows, dtype=dt, device=dev),
        diag={"gamma": final.gamma, "rule_nan": final.rule_nan},
    )


def _padded(t, shape):
    out = t.new_zeros(shape)
    out[tuple(slice(0, s) for s in t.shape)] = t
    return out


def fused_adaptive_primal_dual(x0, y0, *, f, g, h, A, rule, tol=1e-5, maxit=10_000,
                               name="AdaPDM (fused)", history=False, resume_state=None,
                               mesh=None, at=None, pad="auto", it_cap=None):
    """AdaPDM with the engine's semantics on the fused one-pass update K5.

    ``A`` is a dense (m, n) tensor or a ``DenseOperator``; ``g`` must map onto the
    kernel's prox menu (``prox_menu_entry``). ``x0`` sets the solve's device and
    dtype. ``at``, the transposed matrix (n, m), skips the transpose of A (a full
    strided pass) on every call; A's shape is then only validated against it.

    ``pad="auto"`` zero-pads a problem that the JAX kernel would not take compiled
    (``pd_fusable``: n a multiple of 8, 16 for bf16, and m of 128) and corrects for
    it exactly: the new columns of A get a zero gradient (``ops.oracles.PadDomain``)
    and, since every menu prox maps 0 to 0 (checked for "box"), stay 0; the new
    rows see h through ``ops.prox.PadTail``, whose conjugate pins the padded duals
    to 0. The padded solve follows the unpadded problem's trajectory; x and y come
    back at their own sizes. ``pad=False`` raises on such a shape instead.
    ``resume_state``, ``mesh`` and ``it_cap`` are not ported yet and raise
    ``NotImplementedError``.
    """
    for opt, val in (("resume_state", resume_state), ("mesh", mesh), ("it_cap", it_cap)):
        if val is not None:
            raise NotImplementedError(f"{opt} is {_LATER}")
    entry = prox_menu_entry(g)
    if entry is None:
        raise ValueError(f"g={type(g).__name__} not in the fused prox menu")
    kind, p1, p2 = entry
    if not isinstance(x0, torch.Tensor):
        raise TypeError("x0 must be a torch.Tensor; it sets the solve's device and dtype")
    a_mat = getattr(A, "a", A)
    a_shape = tuple(np.shape(a_mat))
    if at is not None:
        at_mat = torch.as_tensor(at, device=x0.device)
        if tuple(at_mat.shape) != a_shape[::-1]:
            raise ValueError(f"at shape {tuple(at_mat.shape)} is not the transpose of A shape "
                             f"{a_shape}")
    else:
        at_mat = torch.as_tensor(a_mat, device=x0.device).t()
    at_mat = at_mat.contiguous()
    y0 = torch.as_tensor(y0, dtype=x0.dtype, device=x0.device)
    n_true, m_true = at_mat.shape
    if not pd_kernels.pd_fusable(at_mat):
        if not pad:
            raise ValueError(
                f"A with shape {a_shape} is not tile-aligned for the fused PD kernel (need "
                "n % 8 == 0 and m % 128 == 0); use pad='auto' or "
                "solvers.primal_dual.adaptive_primal_dual")
        if kind == "box" and not (float(p1) <= 0.0 <= float(p2)):
            # prox_box(0) != 0 would move the padded coordinates off zero
            raise ValueError(f"auto-pad needs prox_g(0) = 0; IndBox({float(p1)}, "
                             f"{float(p2)}) violates it: pad the problem by hand")
        sub = pd_kernels.sublane(at_mat.element_size())
        n_pad, m_pad = -(-n_true // sub) * sub, -(-m_true // pd_kernels.LANE) * pd_kernels.LANE
        at_mat = _padded(at_mat, (n_pad, m_pad))
        x0, y0 = _padded(x0, (n_pad,)), _padded(y0, (m_pad,))
        if n_pad != n_true:
            f = oracles.PadDomain(f, n_true)
        if m_pad != m_true:
            h = prox_ops.PadTail(h, m_true)
    res = _solve(f, g, h, at_mat, rule, x0, y0, float(p1), float(p2), tol, int(maxit),
                 bool(history), kind)
    if res.x.shape[0] != n_true or res.y.shape[0] != m_true:
        res = res._replace(x=res.x[:n_true], y=res.y[:m_true])
    return res.with_name(name)


def fused_condat_vu(x0, y0, *, f, g, h, A, Lf, norm_A=None, tol=1e-5, maxit=10_000,
                    name="Condat-Vu (fused)", history=False, resume_state=None, mesh=None,
                    at=None, pad="auto", it_cap=None):
    """Condat-Vu on the fused engine: the reference's (gamma, sigma) heuristics
    (src/AdaProx.jl:367-416) formed in float64 as Python floats, as the JAX
    package forms them, then ``FixedStepsize(gamma, t = sqrt(sigma / gamma))``.
    ``norm_A`` defaults to the Frobenius norm of ``at`` (or A)."""
    a_mat = getattr(A, "a", A)
    if norm_A is None:
        # jnp.linalg.norm's value in the JAX package: in the storage dtype
        norm_A = float(storage_norm(torch.as_tensor(at if at is not None else a_mat)))
    f64 = torch.float64
    gamma, sigma = condat_vu_steps(torch.tensor(float(Lf), dtype=f64),
                                   torch.tensor(float(norm_A), dtype=f64))
    gamma, sigma = float(gamma), float(sigma)
    rule = rules_mod.FixedStepsize(gamma=gamma, t=float(np.sqrt(sigma / gamma)))
    return fused_adaptive_primal_dual(
        x0, y0, f=f, g=g, h=h, A=A, rule=rule, tol=tol, maxit=maxit, name=name,
        history=history, resume_state=resume_state, mesh=mesh, at=at, pad=pad, it_cap=it_cap)
