"""Batched solves: many problem instances, one result with a leading axis
(counterpart of ``adaprox_tpu/solvers/batch.py``).

The reference runs hyperparameter sweeps as sequential outer loops (the
t-grid at dual_svm/runme.jl:63-76, per-lambda lasso paths). The JAX package
vmaps the engine over the batch, one compiled program. ``torch.func.vmap``
cannot trace the port's engine, whose loop stops on a host check of the
residual, so here ``batch_solve`` runs ``solve`` on each slice in turn, each
with its own early exit, and stacks the results into the layout of JAX's
vmapped one: every leaf of the ``SolveResult`` gains a leading axis.

``regularization_path`` is the canonical instance: a lasso path over a
vector of L1 weights, AdaPGM through ``adaptive_proxgrad`` on the tensors'
device (as in the JAX package, not through the whole-solve batch kernel
``ops.resident.resident_adapgm_batch``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.prox import L1Norm
from .common import Records
from .primal_dual import adaptive_proxgrad
from .rules import AdaPGMRule

__all__ = ["batch_solve", "regularization_path"]


def _length(tree):
    """The leading length of the first array leaf of ``tree``."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return tree.shape[0]
    leaves = tree.values() if isinstance(tree, dict) else tree
    for leaf in leaves:
        n = _length(leaf)
        if n is not None:
            return n
    return None


def _slice(tree, i):
    """Slice ``i`` of every array leaf of ``tree`` (tuples, named tuples,
    lists and dicts of tensors or numpy arrays)."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_slice(v, i) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_slice(v, i) for v in tree)
    return tree


def _stack_records(recs):
    """Records of one row an iteration that ran, padded with invalid zero
    rows to the longest and stacked: (B, rows) columns with ``valid`` marking
    each slice's rows, as the rows of JAX's frozen scan are marked (JAX's
    invalid rows hold the frozen carry's step; only valid rows are data)."""
    rows = max(len(r.it) for r in recs)
    return Records(*(torch.stack([F.pad(col, (0, rows - col.shape[0])) for col in cols])
                     for cols in zip(*recs)))


def _stack(leaves):
    """One leaf of the batched result from the slices' leaves."""
    first = leaves[0]
    if first is None:
        return None
    if isinstance(first, Records):
        return _stack_records(leaves)
    if isinstance(first, torch.Tensor):
        return torch.stack(leaves)
    if isinstance(first, dict):
        return {k: _stack([leaf[k] for leaf in leaves]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack(list(col)) for col in zip(*leaves)))
    return torch.tensor(leaves)


def batch_solve(solve, batched):
    """``solve`` over the leading axis of every leaf in ``batched``.

    ``solve(batched_slice) -> SolveResult``. Each slice is solved in turn
    with its own early exit; the results are stacked leaf by leaf (tensors
    on their device; Python ints and bools become CPU tensors, so
    ``Counters`` is a ``Counters`` of (B,) tensors; records are (B, rows)
    columns padded with invalid rows to the longest slice's). The result's
    ``name`` (a string) is stripped, as under JAX's vmap, and must be
    attached by the caller per slice."""
    count = _length(batched)
    if not count:
        raise ValueError("batch_solve needs a leading axis of at least one slice")
    results = [solve(_slice(batched, i))._replace(name=None) for i in range(count)]
    return type(results[0])(*(_stack(list(leaves)) for leaves in zip(*results)))


def regularization_path(x0, *, f, lams, gamma, tol=1e-5, maxit=1000, history=False):
    """Solve min f(x) + lam * ||x||_1 for every lam in ``lams`` (AdaPGM from
    ``x0`` with the step ``gamma``). Returns a SolveResult whose leaves have
    a leading axis of len(lams); each slice equals its own
    ``adaptive_proxgrad`` solve."""
    lams = torch.as_tensor(np.asarray(lams) if not isinstance(lams, torch.Tensor) else lams,
                           dtype=x0.dtype, device=x0.device)

    def solve(lam):
        return adaptive_proxgrad(x0, f=f, g=L1Norm(lam=lam), rule=AdaPGMRule(gamma=gamma),
                                 tol=tol, maxit=maxit, history=history)

    return batch_solve(solve, lams)
