"""Linear operators and the accumulation-dtype policy (counterpart of
``adaprox_tpu/ops/linops.py``): ``DenseOperator``, ``frobenius_norm`` and
``acc_dtype``, single-sourced here."""

from __future__ import annotations

import torch

__all__ = ["DenseOperator", "acc_dtype", "frobenius_norm"]


def acc_dtype(a, v):
    """Accumulate in the iterate/vector dtype when ``a`` is stored bf16 (f32
    accumulation for bf16 matrices), otherwise in the promoted type."""
    if a.dtype == torch.bfloat16:
        return v.dtype
    return torch.promote_types(a.dtype, v.dtype)


def frobenius_norm(a):
    """sqrt(sum(a^2)) accumulated in >= f32 (bf16 storage is upcast: an
    8-mantissa-bit sum over millions of squares is meaningless)."""
    a = a.float() if a.dtype == torch.bfloat16 else a
    return torch.sqrt(torch.sum(a * a))


class DenseOperator:
    """A dense matrix ``a`` (m, n) as the linear operator of h(Ax): ``matvec``
    A x, ``rmatvec`` A' y, both plain ``torch.mv`` (the JAX package leaves
    them to XLA, outside any Pallas kernel); bf16 storage accumulates in the
    vector's dtype."""

    def __init__(self, a):
        self.a = a

    @property
    def shape(self):
        return tuple(self.a.shape)

    def matvec(self, x):
        return torch.mv(self.a.to(acc_dtype(self.a, x)), x)

    def rmatvec(self, y):
        return torch.mv(self.a.to(acc_dtype(self.a, y)).t(), y)

    def norm(self):
        """The Frobenius norm, Julia's ``norm(A)`` on a matrix, which the
        reference takes for norm_A (experiments/dual_svm/runme.jl:59)."""
        return frobenius_norm(self.a)
