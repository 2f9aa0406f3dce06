"""Smooth objectives on the main path (counterpart of
``adaprox_tpu/models/objectives.py``): ``LeastSquares``, the reference's
hand-written pullback struct of experiments/lasso/runme.jl:16-27."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import kernels
from ..ops.linops import acc_dtype
from ..ops.oracles import SmoothOracle

__all__ = ["LeastSquares"]


class LeastSquares(nn.Module, SmoothOracle):
    """f(w) = 0.5 * ||A w - b||^2, with ``a`` and ``b`` as buffers.

    ``fused=False``: two matvecs; aux = residual, grad = A' res. ``a`` may be
    stored bf16; results accumulate in the iterate dtype.

    ``fused=True``: value and gradient from one call of K1
    (``ops.kernels.fused_ls_value_grad``); aux = gradient. On CUDA tensors
    that launches the hand-written kernel or raises; on CPU tensors it is the
    plain version. Any (m, n) is taken.
    """

    def __init__(self, a, b, fused=False):
        super().__init__()
        self.register_buffer("a", a)
        self.register_buffer("b", b)
        self.fused = fused

    def forward(self, w):
        return self.value(w)

    def value_and_aux(self, w):
        if self.fused:
            return kernels.fused_ls_value_grad(self.a, self.b, w)
        a = self.a.to(acc_dtype(self.a, w))
        res = torch.mv(a, w) - self.b
        return 0.5 * torch.sum(res * res), res

    def grad_from_aux(self, w, aux):
        del w
        if self.fused:
            return aux  # K1 already produced the gradient
        return torch.mv(self.a.to(acc_dtype(self.a, aux)).t(), aux)

    def bregman_from_aux(self, dx, aux, aux_prev):
        # 0.5||A dx||^2. Non-fused aux is the residual: ||res - res_prev||^2 is
        # a sum of squares, noise enters at second order. Fused aux is the
        # gradient: 0.5 dx'A'A dx = 0.5 <dx, dgrad>, clamped at the exact lower
        # bound 0 (the dot's noise can round a tiny term negative).
        if self.fused:
            return torch.clamp_min(0.5 * torch.dot(dx, aux - aux_prev), 0.0)
        dres = aux - aux_prev
        return 0.5 * torch.sum(dres * dres)
