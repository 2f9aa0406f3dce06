"""Proximable functions, main-path subset (counterpart of
``adaprox_tpu/ops/prox.py``): ``Zero``, ``L1Norm``, ``IndZero``, ``IndBox``
and the convex conjugate (closed forms for these classes, the Moreau
identity otherwise).

Every operator has:

  * ``op(x)``             -> the function value at x (a 0-d tensor)
  * ``op.prox(v, gamma)`` -> ``(y, g_y)`` with y = argmin_z g(z) + ||z-v||^2/(2*gamma)
                             and g_y = g(y) (ProximalCore's ``prox(g, v, gamma)``)

Parameters are Python floats or 0-d tensors on the iterate's device and in
its dtype; ``gamma`` is a 0-d tensor or a float.
"""

from __future__ import annotations

import torch

__all__ = ["Zero", "L1Norm", "IndZero", "IndBox", "MoreauConjugate", "conjugate"]


class Zero:
    """g(x) = 0; prox is the identity (ProximalCore.Zero)."""

    def __call__(self, x):
        return torch.zeros((), dtype=x.dtype, device=x.device)

    def prox(self, v, gamma):
        del gamma
        return v, torch.zeros((), dtype=v.dtype, device=v.device)


class L1Norm:
    """g(x) = lam * ||x||_1; prox = soft-thresholding (NormL1 in the reference)."""

    def __init__(self, lam=1.0):
        self.lam = lam

    def __call__(self, x):
        return self.lam * torch.sum(torch.abs(x))

    def prox(self, v, gamma):
        thr = gamma * self.lam
        y = torch.sign(v) * torch.clamp_min(torch.abs(v) - thr, 0)
        return y, self(y)


class IndZero:
    """Indicator of {0}: 0 at x = 0, +inf elsewhere; prox maps everything to 0
    (ProximalCore.IndZero)."""

    def __call__(self, x):
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        return torch.where(torch.all(x == 0), zero, torch.full_like(zero, torch.inf))

    def prox(self, v, gamma):
        del gamma
        return torch.zeros_like(v), torch.zeros((), dtype=v.dtype, device=v.device)


class IndBox:
    """Indicator of the box [lo, hi]; prox = clamp (IndBox in the reference,
    used by the dual SVM at experiments/dual_svm/runme.jl:52). The clamp is
    min(max(v, lo), hi), NaN in NaN out, as ``jnp.clip``."""

    def __init__(self, lo=-torch.inf, hi=torch.inf):
        self.lo = lo
        self.hi = hi

    def __call__(self, x):
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        ok = torch.all((x >= self.lo) & (x <= self.hi))
        return torch.where(ok, zero, torch.full_like(zero, torch.inf))

    def prox(self, v, gamma):
        del gamma
        lo = torch.as_tensor(self.lo, dtype=v.dtype, device=v.device)
        hi = torch.as_tensor(self.hi, dtype=v.dtype, device=v.device)
        return (torch.minimum(torch.maximum(v, lo), hi),
                torch.zeros((), dtype=v.dtype, device=v.device))


class MoreauConjugate:
    """Convex conjugate h* with prox by the Moreau identity

        prox_{gamma h*}(v) = v - gamma * prox_{h / gamma}(v / gamma),

    how ProximalCore evaluates ``prox(convex_conjugate(h), w, sigma)`` in the
    reference's dual update (src/AdaProx.jl:345). No solver needs h*(y)."""

    def __init__(self, inner):
        self.inner = inner

    def __call__(self, x):
        raise NotImplementedError("MoreauConjugate has no closed-form value; solvers never "
                                  "need it")

    def prox(self, v, gamma):
        u, _ = self.inner.prox(v / gamma, 1.0 / gamma)
        return v - gamma * u, torch.zeros((), dtype=v.dtype, device=v.device)


def conjugate(g):
    """Convex conjugate of ``g``: closed form for the ported classes
    (Zero <-> IndZero, L1Norm(lam) -> IndBox(-lam, lam)), Moreau otherwise."""
    if isinstance(g, Zero):
        return IndZero()
    if isinstance(g, IndZero):
        return Zero()
    if isinstance(g, L1Norm):
        return IndBox(-g.lam, g.lam)
    return MoreauConjugate(g)
