"""Linear operators and the accumulation-dtype policy (counterpart of
``adaprox_tpu/ops/linops.py``): ``DenseOperator``, ``frobenius_norm``,
``acc_dtype`` and ``opnorm2``, single-sourced here. The sparse operators are
``ops.sparse.ELLOperator`` and ``ops.bcsr.BCSROperator``."""

from __future__ import annotations

import torch

from ..utils.jax_random import normal

__all__ = ["DenseOperator", "acc_dtype", "frobenius_norm", "opnorm2", "storage_norm",
           "widened"]


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


def storage_norm(a):
    """sqrt(sum(a^2)) in a's own dtype, as the JAX package's sparse operators
    (``jnp.sqrt(jnp.sum(vals * vals))``) and ``jnp.linalg.norm`` compute it:
    the squares rounded to a's dtype, summed in >= f32, the sum rounded to
    a's dtype, then the root. bf16 storage gives a bf16 norm, where
    ``frobenius_norm`` upcasts first."""
    acc = torch.float32 if a.dtype in (torch.bfloat16, torch.float16) else a.dtype
    return torch.sqrt(torch.sum(a * a, dtype=acc).to(a.dtype))


def widened(dtype):
    """The iteration dtype of a power iteration over storage of ``dtype``: bf16
    widened to float32 (a bf16 power iteration would hand the stepsize bounds a
    sigma_max 0.5-1% off), any other dtype as it is."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def opnorm2(op, iters=100, key=None, n=None, dtype=None, device=None):
    """The largest singular value of the linear operator ``op`` by power iteration
    on A'A, one ``matvec`` and one ``rmatvec`` a step (counterpart of JAX's
    ``opnorm2``, which replaces the reference's exact ``opnorm(A)``,
    experiments/lasso/runme.jl:81).

    The start vector is ``jax.random.normal(PRNGKey(key), (n,), dtype)``
    (``utils.jax_random``; ``key`` an integer seed, 0 by default), normalised. ``n``
    defaults to ``op.shape[1]``; ``dtype`` to the storage dtype of ``op.a`` widened to
    float32 (float32 without ``op.a``); ``device`` to ``op.a``'s (else the CPU). A zero
    operator keeps v, and the norm is then 0."""
    store = getattr(op, "a", None)
    if n is None:
        n = op.shape[1] if hasattr(op, "shape") else None
    if n is None:
        raise ValueError("pass n= for operators without a .shape")
    if dtype is None:
        dtype = widened(store.dtype) if store is not None else torch.float32
    if device is None:
        device = store.device if store is not None else "cpu"
    draw = normal(0 if key is None else key, (int(n),), str(dtype).removeprefix("torch."))
    v = torch.from_numpy(draw).to(device)
    v = v / torch.sqrt(torch.sum(v * v))
    for _ in range(int(iters)):
        w = op.rmatvec(op.matvec(v))
        nrm = torch.sqrt(torch.sum(w * w))
        # a zero (or numerically null) operator keeps v instead of 0/0
        v = torch.where(nrm > 0, w / torch.where(nrm > 0, nrm, torch.ones_like(nrm)), v)
    return torch.sqrt(torch.sum(op.matvec(v) ** 2))


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

    def opnorm(self, iters=100, key=None):
        """The largest singular value by ``opnorm2``'s power iteration."""
        return opnorm2(self, iters=iters, key=key)
