"""Carry the JAX side's problem and parameters over to the port.

Both sides are handed numpy arrays (``np.asarray`` of the JAX arrays), so
the port computes from exactly the data the JAX package used.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.objectives import LeastSquares
from .ops.prox import L1Norm
from .solvers import rules

__all__ = ["lasso_from_numpy", "rule_from_numpy"]

_RULES = {cls.__name__: cls for cls in
          (rules.FixedStepsize, rules.MalitskyMishchenkoRule, rules.AdaPGMRule)}


def lasso_from_numpy(a, b, lam, *, device, dtype, fused):
    """``(LeastSquares, L1Norm)`` of 0.5||Ax - b||^2 + lam ||x||_1 on
    ``device``. ``dtype`` is the storage dtype of A (bf16 allowed); b and
    lam take ``dtype`` too unless it is bf16, where they take float32."""
    vec_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
    a_t = torch.as_tensor(np.asarray(a), device=device).to(dtype)
    b_t = torch.as_tensor(np.asarray(b), device=device).to(vec_dtype)
    lam_t = torch.as_tensor(float(np.asarray(lam)), dtype=vec_dtype, device=device)
    return LeastSquares(a_t, b_t, fused=fused), L1Norm(lam_t)


def rule_from_numpy(kind, **fields):
    """The port's rule of class name ``kind`` ("FixedStepsize",
    "MalitskyMishchenkoRule" or "AdaPGMRule") from a JAX rule's fields read
    with ``np.asarray``. Fields become Python floats; the engine casts them
    to the iterate's dtype and device."""
    try:
        cls = _RULES[kind]
    except KeyError:
        raise ValueError(f"unknown rule {kind!r}; ported: {sorted(_RULES)}") from None
    return cls(**{k: float(np.asarray(v)) for k, v in fields.items()})
