"""Proximable functions, main-path subset (counterpart of
``adaprox_tpu/ops/prox.py``).

Every operator has:

  * ``op(x)``             -> the function value at x (a 0-d tensor)
  * ``op.prox(v, gamma)`` -> ``(y, g_y)`` with y = argmin_z g(z) + ||z-v||^2/(2*gamma)
                             and g_y = g(y) (ProximalCore's ``prox(g, v, gamma)``)

Parameters are Python floats or 0-d tensors on the iterate's device and in
its dtype; ``gamma`` is a 0-d tensor or a float.
"""

from __future__ import annotations

import torch

__all__ = ["Zero", "L1Norm"]


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
