"""Smooth objectives ported so far (counterpart of
``adaprox_tpu/models/objectives.py``), the reference's hand-written pullback
structs:

  * LeastSquares    experiments/lasso/runme.jl:16-27
  * LogisticLoss    experiments/sparse_logreg/runme.jl:18-39
  * Quadratic, FactoredQuadratic  experiments/dual_svm/runme.jl:19-28
  * Cubic           experiments/cubic_sparse_logreg/runme.jl:26-32
  * WorstQuadratic  experiments/nesterov_worst_case/runme.jl:14-40
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import kernels
from ..ops.linops import acc_dtype, frobenius_norm
from ..ops.oracles import SmoothOracle

__all__ = ["LeastSquares", "LogisticLoss", "Quadratic", "FactoredQuadratic", "Cubic",
           "WorstQuadratic"]


def _mv(a, v):
    """a @ v, accumulated in ``v``'s dtype for bf16 storage. ``a`` may also be any
    linear operator with ``matvec`` (``ops.sparse.ELLOperator``,
    ``ops.bcsr.BCSROperator``): the sparse data path plugs into the oracles here."""
    if isinstance(a, torch.Tensor):
        return torch.mv(a.to(acc_dtype(a, v)), v)
    return a.matvec(v)


def _vm(v, a):
    """a' @ v, the transposed matvec (``rmatvec`` of an operator)."""
    if isinstance(a, torch.Tensor):
        return torch.mv(a.to(acc_dtype(a, v)).t(), v)
    return a.rmatvec(v)


def _data(module, name, a, fused, kernel):
    """Keep the data ``a`` on ``module``: a tensor as a buffer, an operator as an
    attribute. ``fused=True`` takes a tensor only: the fused kernel ``kernel`` reads
    A itself, and an operator is refused rather than quietly given two matvecs."""
    if isinstance(a, torch.Tensor):
        module.register_buffer(name, a)
        return
    if fused:
        raise ValueError(f"fused=True runs {kernel} on a dense tensor {name}; "
                         f"{type(a).__name__} is an operator: pass fused=False")
    setattr(module, name, a)


class LeastSquares(nn.Module, SmoothOracle):
    """f(w) = 0.5 * ||A w - b||^2, with ``a`` and ``b`` as buffers.

    ``fused=False``: two matvecs; aux = residual, grad = A' res. ``a`` may be
    stored bf16; results accumulate in the iterate dtype.

    ``fused=True``: value and gradient from one call of K1
    (``ops.kernels.fused_ls_value_grad``); aux = gradient. On CUDA tensors
    that launches the hand-written kernel or raises; on CPU tensors it is the
    plain version. Any (m, n) is taken.

    ``a`` may also be a linear operator (``ELLOperator``, ``BCSROperator``,
    ``DenseOperator``): its ``matvec`` and ``rmatvec`` take the two matvecs'
    places. ``fused=True`` with an operator raises a ``ValueError``.
    """

    def __init__(self, a, b, fused=False):
        super().__init__()
        _data(self, "a", a, fused, "K1")
        self.register_buffer("b", b)
        self.fused = fused

    def forward(self, w):
        return self.value(w)

    def value_and_aux(self, w):
        if self.fused:
            return kernels.fused_ls_value_grad(self.a, self.b, w)
        res = _mv(self.a, w) - self.b
        return 0.5 * torch.sum(res * res), res

    def grad_from_aux(self, w, aux):
        del w
        if self.fused:
            return aux  # K1 already produced the gradient
        return _vm(aux, self.a)

    def bregman_from_aux(self, dx, aux, aux_prev):
        # 0.5||A dx||^2. Non-fused aux is the residual: ||res - res_prev||^2 is
        # a sum of squares, noise enters at second order. Fused aux is the
        # gradient: 0.5 dx'A'A dx = 0.5 <dx, dgrad>, clamped at the exact lower
        # bound 0 (the dot's noise can round a tiny term negative).
        if self.fused:
            return torch.clamp_min(0.5 * torch.dot(dx, aux - aux_prev), 0.0)
        dres = aux - aux_prev
        return 0.5 * torch.sum(dres * dres)


class LogisticLoss(nn.Module, SmoothOracle):
    """Mean logistic loss with the bias folded into the last coordinate of w
    (reference experiments/sparse_logreg/runme.jl:23-39), with ``x`` (m, n)
    and labels ``y`` in {0, 1} as buffers:

        logits = X @ w[:-1] + w[-1]
        f(w) = -mean((y - 1) * logits - log(1 + exp(-logits)))

    ``fused=False``: aux = sigmoid(logits), grad = [X'(probs - y)/m,
    mean(probs - y)]; ``x`` may be stored bf16, results accumulate in the
    iterate dtype.

    ``fused=True``: value and gradient from one call of K3
    (``ops.kernels.fused_logistic_value_grad``); aux = gradient. On CUDA
    tensors that launches the hand-written kernel or raises; on CPU tensors
    it is the plain version. Any (m, n) is taken: the JAX package takes its
    fused branch only on TPU-tile-aligned X, a tiling limit K3 does not have.

    ``x`` may also be a linear operator, as ``LeastSquares``'s ``a``; ``fused=True``
    with an operator raises a ``ValueError``.
    """

    def __init__(self, x, y, fused=False):
        super().__init__()
        _data(self, "x", x, fused, "K3")
        self.register_buffer("y", y)
        self.fused = fused

    def forward(self, w):
        return self.value(w)

    def value_and_aux(self, w):
        if self.fused:
            f_x, gw, gb = kernels.fused_logistic_value_grad(self.x, self.y, w[:-1], w[-1])
            return f_x, torch.cat([gw, gb[None]]).to(w.dtype)
        logits = _mv(self.x, w[:-1]) + w[-1]
        terms, probs = kernels.logistic_terms(logits, self.y)
        return -torch.mean(terms), probs

    def grad_from_aux(self, w, aux):
        if self.fused:
            return aux  # K3 already produced the gradient
        diff = aux - self.y
        gw = _vm(diff, self.x) / self.y.shape[0]
        return torch.cat([gw, torch.mean(diff)[None]]).to(w.dtype)


class Quadratic(nn.Module, SmoothOracle):
    """f(x) = 0.5 x'Qx + q'x, with ``q_mat`` (n, n) and ``q_vec`` (n,) as
    buffers; aux = Qx, grad = Qx + q. ``q_mat`` may be stored bf16; results
    accumulate in the iterate dtype."""

    def __init__(self, q_mat, q_vec):
        super().__init__()
        self.register_buffer("q_mat", q_mat)
        self.register_buffer("q_vec", q_vec)

    def forward(self, x):
        return self.value(x)

    def value_and_aux(self, x):
        qx = torch.mv(self.q_mat.to(acc_dtype(self.q_mat, x)), x)
        return 0.5 * torch.dot(x, qx) + torch.dot(x, self.q_vec), qx

    def grad_from_aux(self, x, qx):
        del x
        return qx + self.q_vec

    def bregman_from_aux(self, dx, aux, aux_prev):
        # 0.5 dx'Q dx = 0.5 <dx, qx - qx_prev>, clamped at 0 (Q PSD in every use)
        return torch.clamp_min(0.5 * torch.dot(dx, aux - aux_prev), 0.0)


class FactoredQuadratic(nn.Module, SmoothOracle):
    """f(x) = 0.5 x'(B B')x + q'x without the (m, m) Gram: aux = B (B' x), two
    skinny matvecs, with ``b_mat`` (m, d) and ``q_vec`` (m,) as buffers. The
    dual SVM's objective at scale (B = D_y X; the reference builds the Gram,
    dual_svm/runme.jl:47-50). ``norm_q()`` is the Frobenius norm of the
    implied Gram from the (d, d) B'B (||B B'||_F = ||B'B||_F), the
    reference's Lf (runme.jl:56). ``b_mat`` may be stored bf16."""

    def __init__(self, b_mat, q_vec):
        super().__init__()
        self.register_buffer("b_mat", b_mat)
        self.register_buffer("q_vec", q_vec)

    def forward(self, x):
        return self.value(x)

    def value_and_aux(self, x):
        b = self.b_mat.to(acc_dtype(self.b_mat, x))
        qx = torch.mv(b, torch.mv(b.t(), x))
        return 0.5 * torch.dot(x, qx) + torch.dot(x, self.q_vec), qx

    def grad_from_aux(self, x, qx):
        del x
        return qx + self.q_vec

    def bregman_from_aux(self, dx, aux, aux_prev):
        # 0.5 dx'BB'dx = 0.5 <dx, qx - qx_prev>, clamped at 0 (BB' PSD)
        return torch.clamp_min(0.5 * torch.dot(dx, aux - aux_prev), 0.0)

    def norm_q(self):
        # the (d, d) Gram accumulated in >= f32: a bf16 sum over m ~ 8k terms is
        # percent-level wrong, and this seeds every solver's Lf
        b = self.b_mat.float() if self.b_mat.dtype == torch.bfloat16 else self.b_mat
        return frobenius_norm(b.t() @ b)


class Cubic(nn.Module, SmoothOracle):
    """Cubic-regularized quadratic model (cubic_sparse_logreg/runme.jl:26-32),
    with ``q_mat`` (n, n), ``q_vec`` (n,) and ``c`` (0-d) as buffers:

        grad = Q x + q + (c ||x|| / 2) x
        f(x) = (<x, grad> + <q, x>) / 2 - c ||x||^3 / 12

    aux = grad (the reference's pullback returns the precomputed gradient),
    so value and gradient share one matvec. The formula order is the JAX
    engine's (``nx**3``); K2's cubic objective (``ops.resident``) writes
    ``nx * nx * nx`` as the JAX kernel does, so the two are kept apart.
    ``q_mat`` may be stored bf16; results accumulate in the iterate dtype.
    """

    def __init__(self, q_mat, q_vec, c):
        super().__init__()
        self.register_buffer("q_mat", q_mat)
        self.register_buffer("q_vec", q_vec)
        self.register_buffer("c", torch.as_tensor(c, dtype=q_vec.dtype, device=q_vec.device))

    def forward(self, x):
        return self.value(x)

    def value_and_aux(self, x):
        nx = torch.sqrt(torch.sum(x * x))
        hx = torch.mv(self.q_mat.to(acc_dtype(self.q_mat, x)), x)
        grad = hx + self.q_vec + (nx * self.c / 2) * x
        val = (torch.dot(x, grad) + torch.dot(self.q_vec, x)) / 2 - nx**3 * self.c / 12
        return val, grad

    def grad_from_aux(self, x, aux):
        del x
        return aux


class WorstQuadratic(nn.Module, SmoothOracle):
    """Nesterov's worst-case tridiagonal quadratic on the first ``k``
    coordinates (nesterov_worst_case/runme.jl:14-40), with ``lip`` (0-d) as a
    buffer:

        f(x) = (L/4) ((x_1^2 + x_k^2 + sum_{i<k} (x_i - x_{i+1})^2) / 2 - x_1)

    The gradient is the stencil (L/4)(T x - e_1), T = tridiag(-1, 2, -1) on
    x[:k] and zero beyond: no dense T. aux is None; the gradient is formed
    from x.
    """

    def __init__(self, k, lip):
        super().__init__()
        self.k = int(k)
        self.register_buffer("lip", torch.as_tensor(lip))

    def forward(self, x):
        return self.value(x)

    def value_and_aux(self, x):
        xk = x[: self.k]
        s = xk[0] ** 2 + xk[-1] ** 2 + torch.sum(torch.diff(xk) ** 2)
        return (self.lip / 4) * (s / 2 - xk[0]), None

    def grad_from_aux(self, x, aux):
        del aux
        xk = x[: self.k]
        zero = torch.zeros(1, dtype=xk.dtype, device=xk.device)
        left = torch.cat([zero, xk[:-1]])
        right = torch.cat([xk[1:], zero])
        tx = 2 * xk - left - right
        e1 = torch.zeros_like(xk)
        e1[0] = 1.0
        gk = (self.lip / 4) * (tx - e1)
        return torch.cat([gk, torch.zeros(x.shape[0] - self.k, dtype=x.dtype, device=x.device)])
