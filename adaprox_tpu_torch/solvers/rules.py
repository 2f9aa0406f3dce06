"""Adaptive stepsize rules (counterpart of ``adaprox_tpu/solvers/rules.py``;
reference src/AdaProx.jl:208-273).

Protocol:

  * ``rule.init() -> ((gamma, sigma), state)``
  * ``rule.update(state, curv) -> ((gamma, sigma), state)``

where ``curv`` is the ``Curvature`` triple of cross-iterate reductions
(||dgrad||^2, <dgrad, dx>, ||dx||^2).

Rules are small frozen dataclasses. Their fields may be Python floats when
built; ``rule.to(dtype=..., device=...)`` turns every field into a 0-d tensor,
which the engine does once before it iterates (the counterpart of the JAX
engine's ``cast_floats``). There are no tracers, so constructors validate
their parameters eagerly.
"""

from __future__ import annotations

import dataclasses
import math
import numbers
import warnings
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "Curvature",
    "FixedStepsize",
    "MalitskyMishchenkoRule",
    "AdaPGMRule",
    "OurRule",
    "nan_to_zero",
    "validate_positive",
]


class Curvature(NamedTuple):
    """Cross-iterate reductions feeding an adaptive rule."""

    ndg2: torch.Tensor  # ||grad_1 - grad_0||^2
    dgdx: torch.Tensor  # <grad_1 - grad_0, x_1 - x_0>
    ndx2: torch.Tensor  # ||x_1 - x_0||^2

    @staticmethod
    def of(x1, grad1, x0, grad0):
        dg = grad1 - grad0
        dx = x1 - x0
        return Curvature(ndg2=torch.sum(dg * dg), dgdx=torch.dot(dg, dx),
                         ndx2=torch.sum(dx * dx))


def nan_to_zero(v):
    """NaN guard on curvature ratios (src/AdaProx.jl:24): 0/0 -> 0, but
    +/-inf are preserved."""
    return torch.where(torch.isnan(v), torch.zeros_like(v), v)


def validate_positive(**params):
    """Raise for any non-positive, bool or complex parameter (the reference
    raises a DomainError at the first stepsize update, src/AdaProx.jl:267).
    Python and NumPy scalars and 0-d arrays or tensors are checked."""
    for name, v in params.items():
        if isinstance(v, (bool, np.bool_)) or (
                isinstance(v, (np.ndarray, torch.Tensor)) and v.dtype in (np.bool_, torch.bool)):
            raise TypeError(f"{name} must be a positive number, got the bool {v!r}")
        if isinstance(v, (np.ndarray, torch.Tensor)):
            if v.ndim != 0:
                continue
            if (v.is_complex() if isinstance(v, torch.Tensor)
                    else np.iscomplexobj(v)):
                raise TypeError(f"{name} must be a positive real number, got {v!r}")
            val = float(v)
        elif isinstance(v, numbers.Complex) and not isinstance(v, numbers.Real):
            raise TypeError(f"{name} must be a positive real number, got {v!r}")
        elif isinstance(v, numbers.Real):
            val = float(v)
        else:
            continue
        if not val > 0:
            raise ValueError(f"{name} must be positive, got {name}={v!r}")


class _Rule:
    """Shared ``to``: every field becomes a 0-d tensor of ``dtype`` on
    ``device``."""

    def to(self, dtype, device):
        return dataclasses.replace(self, **{
            f.name: torch.as_tensor(getattr(self, f.name), dtype=dtype, device=device)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class FixedStepsize(_Rule):
    """Constant (gamma, gamma * t^2) (src/AdaProx.jl:208-215)."""

    gamma: object
    t: object = 1.0

    def __post_init__(self):
        validate_positive(gamma=self.gamma, t=self.t)

    def init(self):
        return (self.gamma, self.gamma * self.t**2), ()

    def update(self, state, curv):
        del curv
        return self.init()[0], state


@dataclasses.dataclass(frozen=True)
class MalitskyMishchenkoRule(_Rule):
    """Malitsky & Mishchenko, "Adaptive Gradient Descent without Descent".
    gamma = min(sqrt(1+rho)*gamma_prev, 1/(2L)) with L = ||dgrad|| / ||dx||
    (src/AdaProx.jl:217-230). State: (gamma, rho)."""

    gamma: object
    t: object = 1.0

    def __post_init__(self):
        validate_positive(gamma=self.gamma, t=self.t)

    def init(self):
        g = self.gamma
        return (g, g * self.t**2), (g, torch.full_like(g, math.inf))

    def update(self, state, curv):
        gamma_prev, rho = state
        lip = torch.sqrt(curv.ndg2) / torch.sqrt(curv.ndx2)
        # rho is inf on the first update: the growth bound is inactive
        growth = torch.where(torch.isfinite(rho), torch.sqrt(1 + rho) * gamma_prev,
                             torch.full_like(rho, math.inf))
        # identical iterates give L = 0/0 = NaN; fall back to the growth bound
        gamma = torch.where(torch.isnan(lip), growth, torch.minimum(growth, 1 / (2 * lip)))
        return (gamma, gamma * self.t**2), (gamma, gamma / gamma_prev)


def _resolve_gamma(gamma, t, norm_a, theta, delta=0.0):
    """Reference OurRule constructor logic (src/AdaProx.jl:240-250): gamma
    if gamma > 0, else 1/(2*Theta*t*||A||) if ||A|| > 0, else error. A given
    gamma above the reference's failure bound 1/(2*t*||A||*(1+delta)) is
    clamped just inside it, with a warning (see the JAX package)."""
    gamma, t, norm_a, theta, delta = (
        0.0 if v is None else float(v) for v in (gamma, t, norm_a, theta, delta))
    if gamma <= 0 and norm_a <= 0:
        raise ValueError("you must provide gamma > 0 if norm_A = 0")
    if norm_a <= 0:
        return gamma
    bound = 1.0 / (2 * t * norm_a * (1.0 + delta) * (1 + 1e-6))
    if gamma <= 0:
        return 1.0 / (2 * theta * t * norm_a)
    if gamma > bound:
        warnings.warn(
            f"gamma={gamma} exceeds the coupling bound "
            f"1/(2*t*||A||*(1+delta)) = {bound:.3g}; clamping "
            "(the reference raises DomainError at the first stepsize "
            "update for such an init)", stacklevel=3)
        return bound
    return gamma


@dataclasses.dataclass(frozen=True)
class AdaPGMRule(_Rule):
    """The paper's adaptive rule ("OurRule", src/AdaProx.jl:232-273).
    State: (gamma_1, gamma_0).

    gamma = min( gamma1 * sqrt(1 + gamma1/gamma0),
                 1 / (2 * Theta * t * ||A||),
                 gamma1 * sqrt(1 - 4 xi (1+delta)^2)
                   / sqrt(2 (1+delta) (D + sqrt(D^2 + xi (1 - 4 xi (1+delta)^2)))) )
    with xi = t^2 gamma1^2 ||A||^2 and D = gamma1 * L * (gamma1 * C - 1),
    C = ||dg||^2 / <dg, dx>, L = <dg, dx> / ||dx||^2; sigma = gamma * t^2.
    """

    gamma: object
    t: object = 1.0
    norm_a: object = 0.0
    delta: object = 0.0
    theta: object = 1.2

    def __post_init__(self):
        validate_positive(gamma=self.gamma, t=self.t, theta=self.theta)

    @classmethod
    def make(cls, gamma=None, t=1.0, norm_a=0.0, delta=0.0, theta=1.2):
        g = _resolve_gamma(gamma, t, norm_a, theta, delta)
        return cls(gamma=g, t=t, norm_a=norm_a, delta=delta, theta=theta)

    def init(self):
        g = self.gamma
        return (g, g * self.t**2), (g, g)

    def update(self, state, curv):
        gamma1, gamma0 = state
        xi = self.t**2 * gamma1**2 * self.norm_a**2
        # cancellation-free D = gamma1 * (gamma1 * ndg2 - dgdx) / ndx2: the
        # factored form gives 0 * inf = NaN when dgdx underflows to 0; the nan
        # guard covers only the genuine 0/0 case ndx2 == 0
        dd = nan_to_zero(gamma1 * (gamma1 * curv.ndg2 - curv.dgdx) / curv.ndx2)
        one_p_delta = 1 + self.delta
        m4xim1 = 1 - 4 * xi * one_p_delta**2
        # D + sqrt(D^2 + xi*m4xim1) >= 0 mathematically; clamp the rounding
        denom = torch.clamp_min(dd + torch.sqrt(dd**2 + xi * m4xim1), 0.0)
        coupling = 1 / (2 * self.theta * self.t * self.norm_a)  # inf at norm_a == 0
        gamma = torch.minimum(
            gamma1 * torch.sqrt(1 + gamma1 / gamma0),
            torch.minimum(
                coupling,
                gamma1 * torch.sqrt(m4xim1) / torch.sqrt(2 * one_p_delta * denom),
            ),
        )
        sigma = gamma * self.t**2
        return (gamma, sigma), (gamma, gamma1)


# Reference-parity alias
OurRule = AdaPGMRule
