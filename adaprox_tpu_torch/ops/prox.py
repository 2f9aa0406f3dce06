"""Proximable functions, the ported subset (counterpart of
``adaprox_tpu/ops/prox.py``): ``Zero``, ``L1Norm``, ``L2Norm``, ``ElasticNet``,
``IndZero``, ``IndBox``, ``IndBall2``, ``Translate``, ``PadTail`` and the convex
conjugate (closed forms for these classes, the Moreau identity otherwise).

Every operator has:

  * ``op(x)``             -> the function value at x (a 0-d tensor)
  * ``op.prox(v, gamma)`` -> ``(y, g_y)`` with y = argmin_z g(z) + ||z-v||^2/(2*gamma)
                             and g_y = g(y) (ProximalCore's ``prox(g, v, gamma)``)

Parameters are Python floats or 0-d tensors on the iterate's device and in
its dtype; ``gamma`` is a 0-d tensor or a float.
"""

from __future__ import annotations

import torch

__all__ = ["Zero", "L1Norm", "L2Norm", "ElasticNet", "IndZero", "IndBox", "IndBall2",
           "Translate", "PadTail", "MoreauConjugate", "conjugate"]


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


class L2Norm:
    """g(x) = lam * ||x||_2; prox = block soft-thresholding (NormL2). The
    division is guarded (nrm > 0) as in the JAX package, so v = 0 gives 0."""

    def __init__(self, lam=1.0):
        self.lam = lam

    def __call__(self, x):
        return self.lam * torch.sqrt(torch.sum(x * x))

    def prox(self, v, gamma):
        nrm = torch.sqrt(torch.sum(v * v))
        thr = gamma * self.lam
        one, zero = torch.ones_like(nrm), torch.zeros_like(nrm)
        scale = torch.where(nrm > thr, 1 - thr / torch.where(nrm > 0, nrm, one), zero)
        return scale * v, self.lam * scale * nrm


class ElasticNet:
    """g(x) = lam1 ||x||_1 + (lam2 / 2) ||x||_2^2; prox = soft-thresholding, then
    a shrink by 1 + gamma lam2 (closed form; beyond the reference's set). Its
    conjugate is taken by the Moreau identity, as in JAX."""

    def __init__(self, lam1=1.0, lam2=1.0):
        self.lam1 = lam1
        self.lam2 = lam2

    def __call__(self, x):
        return self.lam1 * torch.sum(torch.abs(x)) + 0.5 * self.lam2 * torch.sum(x * x)

    def prox(self, v, gamma):
        soft = torch.sign(v) * torch.clamp_min(torch.abs(v) - gamma * self.lam1, 0)
        y = soft / (1 + gamma * self.lam2)
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


class IndBall2:
    """Indicator of the L2 ball of radius r; prox = radial projection. It
    arises as the conjugate of L2Norm(r)."""

    def __init__(self, r=1.0):
        self.r = r

    def __call__(self, x):
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        nrm = torch.sqrt(torch.sum(x * x))
        # a dtype-relative tolerance: the projection lands on the boundary in exact
        # arithmetic, but its recomputed norm can overshoot by a few ulp (a fixed
        # 1e-12 is below f32's eps, so the prox's own output would read inf in f32)
        fi = torch.finfo(x.dtype)
        ok = nrm <= torch.as_tensor(self.r, dtype=x.dtype, device=x.device) * (
            1 + 8 * fi.eps) + fi.tiny
        return torch.where(ok, zero, torch.full_like(zero, torch.inf))

    def prox(self, v, gamma):
        del gamma
        nrm = torch.sqrt(torch.sum(v * v))
        one = torch.ones_like(nrm)
        scale = torch.where(nrm > self.r, self.r / torch.where(nrm > 0, nrm, one), one)
        return scale * v, torch.zeros((), dtype=v.dtype, device=v.device)


class Translate:
    """g(x) = inner(x + b) (ProximalOperators.Translate; the square-root lasso's
    h = Translate(NormL2(), -y), experiments/square_root_lasso/runme.jl:41), with
    prox_{gamma g}(v) = prox_{gamma inner}(v + b) - b."""

    def __init__(self, inner, b):
        self.inner = inner
        self.b = b

    def __call__(self, x):
        return self.inner(x + self.b)

    def prox(self, v, gamma):
        u, val = self.inner.prox(v + self.b, gamma)
        return u - self.b, val


class PadTail:
    """h_pad(z) = inner(z[:m_true]): the h of a problem whose coupling matrix was
    zero-padded with trailing rows (the fused primal-dual solver's auto-pad). The
    padded entries of A x are exactly 0, so ``inner`` on the head is exact; the tail
    is unpenalized, so the prox passes it through."""

    def __init__(self, inner, m_true):
        self.inner = inner
        self.m_true = int(m_true)

    def __call__(self, z):
        return self.inner(z[:self.m_true])

    def prox(self, v, gamma):
        u, val = self.inner.prox(v[:self.m_true], gamma)
        return torch.cat([u, v[self.m_true:]]), val


class _PadTailConjugate:
    """The conjugate of ``PadTail``: inner* on the head, the tail pinned to 0
    (h_pad*(y) = inner*(y_head) + ind{y_tail = 0}), so the padded dual
    coordinates add nothing to A'y or to the residuals."""

    def __init__(self, inner, m_true):
        self.inner = inner
        self.m_true = int(m_true)

    def __call__(self, y):
        raise NotImplementedError("the PadTail conjugate's value is never needed by solvers")

    def prox(self, v, gamma):
        u, val = self.inner.prox(v[:self.m_true], gamma)
        return torch.cat([u, torch.zeros_like(v[self.m_true:])]), val


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
    (Zero <-> IndZero, L1Norm(lam) -> IndBox(-lam, lam), L2Norm(lam) <->
    IndBall2(lam), PadTail(inner) -> inner* on the head with the tail pinned to 0),
    Moreau otherwise (``Translate`` and ``ElasticNet`` among them, as in JAX)."""
    if isinstance(g, Zero):
        return IndZero()
    if isinstance(g, IndZero):
        return Zero()
    if isinstance(g, L1Norm):
        return IndBox(-g.lam, g.lam)
    if isinstance(g, L2Norm):
        return IndBall2(g.lam)
    if isinstance(g, IndBall2):
        return L2Norm(lam=g.r)
    if isinstance(g, PadTail):
        return _PadTailConjugate(conjugate(g.inner), g.m_true)
    return MoreauConjugate(g)
