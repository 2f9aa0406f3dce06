"""Carry the JAX side's problem and parameters over to the port.

Both sides are handed numpy arrays (``np.asarray`` of the JAX arrays), so
the port computes from exactly the data the JAX package used.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.objectives import (Cubic, FactoredQuadratic, LeastSquares, LogisticLoss, Quadratic,
                                WorstQuadratic)
from .ops.prox import L1Norm
from .solvers import rules

__all__ = ["lasso_from_numpy", "logreg_from_numpy", "cubic_from_numpy", "worst_from_numpy",
           "quadratic_from_numpy", "factored_from_numpy", "dsvm_from_numpy",
           "sqrt_lasso_from_numpy", "rule_from_numpy", "ell_from_numpy", "bcsr_from_numpy"]

_RULES = {cls.__name__: cls for cls in
          (rules.FixedStepsize, rules.MalitskyMishchenkoRule, rules.AdaPGMRule)}


def _matrix(a, device, dtype):
    """A dense matrix as a tensor on ``device`` in ``dtype``; a port operator (one
    with ``matvec``, e.g. from ``ell_from_numpy``) as it is."""
    if hasattr(a, "matvec"):
        return a
    return torch.as_tensor(np.asarray(a), device=device).to(dtype)


def ell_from_numpy(vals, cols, vals_t, rows_t, shape, *, device, dtype):
    """The port's ``ELLOperator`` of a JAX ``ELLOperator``'s arrays (``np.asarray`` of
    its ``vals``, ``cols``, ``vals_t``, ``rows_t``; ``shape``) on ``device``, ``vals``
    in ``dtype``, the index arrays int32."""
    from .ops.sparse import ELLOperator

    return ELLOperator.from_arrays(vals, cols, vals_t, rows_t, shape, device=device, dtype=dtype)


def bcsr_from_numpy(vals, cols, rowptr, vals_t, cols_t, rowptr_t, shape, *, kernel="xla",
                    device, dtype):
    """The port's ``BCSROperator`` of a JAX ``BCSROperator``'s arrays (``np.asarray`` of
    ``vals``, ``cols``, ``rowptr`` and their ``_t`` twins; ``shape``) with the matvec
    route ``kernel`` on ``device``, ``vals`` in ``dtype``, the index arrays int32; the
    block rows, padded shape and largest tile counts are derived as JAX derives them."""
    from .ops.bcsr import BCSROperator

    return BCSROperator.from_arrays(vals, cols, rowptr, vals_t, cols_t, rowptr_t, shape,
                                    kernel=kernel, device=device, dtype=dtype)


def lasso_from_numpy(a, b, lam, *, device, dtype, fused):
    """``(LeastSquares, L1Norm)`` of 0.5||Ax - b||^2 + lam ||x||_1 on
    ``device``. ``dtype`` is the storage dtype of A (bf16 allowed); b and
    lam take ``dtype`` too unless it is bf16, where they take float32. ``a``
    may be a port operator (``ell_from_numpy``, ``bcsr_from_numpy``), taken as
    it is."""
    vec_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
    a_t = _matrix(a, device, dtype)
    b_t = torch.as_tensor(np.asarray(b), device=device).to(vec_dtype)
    lam_t = torch.as_tensor(float(np.asarray(lam)), dtype=vec_dtype, device=device)
    return LeastSquares(a_t, b_t, fused=fused), L1Norm(lam_t)


def logreg_from_numpy(x, y, lam, *, device, dtype, fused):
    """``(LogisticLoss, L1Norm)`` of the mean logistic loss of features ``x``
    (m, n) and labels ``y`` in {0, 1}, plus lam ||w||_1, on ``device``; the
    bias is folded into w[-1] (w has n + 1 entries). ``dtype`` is the storage
    dtype of x (bf16 allowed); y and lam take ``dtype`` too unless it is bf16,
    where they take float32. ``x`` may be a port operator, taken as it is."""
    vec_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
    x_t = _matrix(x, device, dtype)
    y_t = torch.as_tensor(np.asarray(y), device=device).to(vec_dtype)
    lam_t = torch.as_tensor(float(np.asarray(lam)), dtype=vec_dtype, device=device)
    return LogisticLoss(x_t, y_t, fused=fused), L1Norm(lam_t)


def cubic_from_numpy(q_mat, q_vec, c, *, device, dtype):
    """``Cubic`` of 0.5 x'Qx + q'x + (c/6)||x||^3 on ``device``. ``dtype`` is
    the storage dtype of Q (bf16 allowed); q and c take ``dtype`` too unless
    it is bf16, where they take float32."""
    vec_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
    q_t = torch.as_tensor(np.asarray(q_mat), device=device).to(dtype)
    v_t = torch.as_tensor(np.asarray(q_vec), device=device).to(vec_dtype)
    c_t = torch.as_tensor(float(np.asarray(c)), dtype=vec_dtype, device=device)
    return Cubic(q_t, v_t, c_t)


def worst_from_numpy(k, lip, n, *, device, dtype):
    """``WorstQuadratic`` on the first ``k`` of ``n`` coordinates with
    Lipschitz constant ``lip``, its ``lip`` in ``dtype`` on ``device``."""
    if not 1 <= int(k) <= int(n):
        raise ValueError(f"need 1 <= k <= n, got k={k}, n={n}")
    return WorstQuadratic(int(k), torch.as_tensor(float(np.asarray(lip)), dtype=dtype,
                                                  device=device))


def quadratic_from_numpy(q_mat, q_vec, *, device, dtype):
    """``Quadratic`` of 0.5 x'Qx + q'x on ``device``. ``dtype`` is the storage
    dtype of Q (bf16 allowed); q takes ``dtype`` too unless it is bf16, where
    it takes float32."""
    vec_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
    return Quadratic(torch.as_tensor(np.asarray(q_mat), device=device).to(dtype),
                     torch.as_tensor(np.asarray(q_vec), device=device).to(vec_dtype))


def factored_from_numpy(b_mat, q_vec, *, device, dtype):
    """``FactoredQuadratic`` of 0.5 x'(B B')x + q'x on ``device``, dtypes as
    ``quadratic_from_numpy``."""
    vec_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
    return FactoredQuadratic(torch.as_tensor(np.asarray(b_mat), device=device).to(dtype),
                             torch.as_tensor(np.asarray(q_vec), device=device).to(vec_dtype))


def dsvm_from_numpy(x, labels, big_c, *, device, dtype):
    """The dual SVM of features ``x`` (N, d) and labels in {-1, +1}
    (experiments/dual_svm/runme.jl:44-61): ``(f, g, h, A)`` with f =
    ``FactoredQuadratic(B = D_y X, q = -1)``, g = ``IndBox(0, big_c)``, h =
    ``IndZero`` and A = ``DenseOperator`` of the 1 x N row y', on ``device``
    in ``dtype`` (B is formed in float64 on the host, then cast)."""
    from .ops.linops import DenseOperator
    from .ops.prox import IndBox, IndZero

    lab = np.asarray(labels, dtype=np.float64)
    dyx = lab[:, None] * np.asarray(x, dtype=np.float64)
    f = factored_from_numpy(dyx, -np.ones(lab.shape[0]), device=device, dtype=dtype)
    a = DenseOperator(torch.as_tensor(lab[None, :], device=device).to(f.q_vec.dtype))
    return f, IndBox(0.0, float(big_c)), IndZero(), a


def sqrt_lasso_from_numpy(x, y, lam, inner, *, device, dtype):
    """The square-root lasso (``inner="l2"``) or the least absolute deviation
    (``inner="l1"``) of features ``x`` (m, n) and targets ``y`` (m,)
    (experiments/square_root_lasso/runme.jl:37-42): ``(f, g, h, A, norm_a)`` with
    f = ``ZeroSmooth``, g = ``L1Norm(lam)``, h = ``Translate(inner(1), -y)``, A =
    the ``DenseOperator`` of [X 1] (m, n + 1) on ``device`` in ``dtype``, and
    ``norm_a`` its Frobenius norm, a Python float from the float64 matrix."""
    from .ops.linops import DenseOperator
    from .ops.oracles import ZeroSmooth
    from .ops.prox import L2Norm, Translate

    inners = {"l2": L2Norm, "l1": L1Norm}
    if inner not in inners:
        raise ValueError(f"inner must be 'l2' or 'l1', got {inner!r}")
    x = np.asarray(x, dtype=np.float64)
    a = np.hstack([x, np.ones((x.shape[0], 1))])
    y_t = torch.as_tensor(np.asarray(y, dtype=np.float64), device=device).to(dtype)
    h = Translate(inners[inner](1.0), -y_t)
    return (ZeroSmooth(), L1Norm(float(lam)), h,
            DenseOperator(torch.as_tensor(a, device=device).to(dtype)), float(np.linalg.norm(a)))


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
