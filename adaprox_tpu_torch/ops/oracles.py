"""Smooth-term oracles (the ``f`` in min f(x) + g(x) + h(Ax)); counterpart of
``adaprox_tpu/ops/oracles.py``.

The reference's gradient interface is ``eval_with_pullback(f, x) -> (f_x, pb)``
(src/AdaProx.jl:11-16). The protocol splits the pullback into data and a
function, as the JAX package does:

  * ``value_and_aux(x) -> (f_x, aux)``  forward pass; ``aux`` is what makes the
    gradient cheap (the saved pullback state).
  * ``grad_from_aux(x, aux) -> grad``   finishes the gradient from ``aux``.
"""

from __future__ import annotations

__all__ = ["SmoothOracle"]


class SmoothOracle:
    """Method mixin: concrete oracles define value_and_aux / grad_from_aux."""

    def value_and_aux(self, x):  # pragma: no cover - interface
        raise NotImplementedError

    def grad_from_aux(self, x, aux):  # pragma: no cover - interface
        raise NotImplementedError

    def value(self, x):
        return self.value_and_aux(x)[0]

    def grad(self, x):
        f_x, aux = self.value_and_aux(x)
        del f_x
        return self.grad_from_aux(x, aux)

    def value_and_grad(self, x):
        f_x, aux = self.value_and_aux(x)
        return f_x, self.grad_from_aux(x, aux)

    def bregman_from_aux(self, dx, aux, aux_prev):
        """Optional: the Bregman term f(x) - f(x_prev) - <grad(x_prev), dx> in
        a cancellation-resistant form, or None when the oracle has no better
        form than the raw difference (see the JAX package's docstring)."""
        del dx, aux, aux_prev
        return None
