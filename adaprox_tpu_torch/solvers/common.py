"""Shared solver types: oracle counters, per-iteration records, results, and
the iteration driver (counterpart of ``adaprox_tpu/solvers/common.py``).

The loop runs on the host, so:

  * ``Counters`` are plain Python ints, bumped at exactly the call sites the
    reference meters (src/counting.jl).
  * ``Records`` rows are appended as 0-d device tensors and stacked once when
    the solve ends; nothing is copied to the host per row.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["Counters", "Records", "SolveResult", "l2sq", "run_loop"]


class Counters(NamedTuple):
    """Oracle-call meters (reference src/counting.jl fields)."""

    f_evals: int = 0
    grad_f_evals: int = 0
    prox_g_evals: int = 0
    prox_h_evals: int = 0
    A_evals: int = 0
    At_evals: int = 0

    @staticmethod
    def zeros():
        return Counters()

    def bump(self, **deltas):
        return self._replace(**{k: getattr(self, k) + v for k, v in deltas.items()})


class Records(NamedTuple):
    """Per-iteration history, one row per iteration that ran (all valid)."""

    it: torch.Tensor
    gamma: torch.Tensor
    sigma: torch.Tensor
    norm_res: torch.Tensor
    objective: torch.Tensor
    f_evals: torch.Tensor
    grad_f_evals: torch.Tensor
    prox_g_evals: torch.Tensor
    prox_h_evals: torch.Tensor
    A_evals: torch.Tensor
    At_evals: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def stack(rows, *, dtype, device):
        """Stack ``(it, gamma, sigma, norm_res, objective, counters)`` rows
        (0-d tensors and a ``Counters``) into columns, in one go."""
        def col(vals):
            return torch.stack(vals) if vals else torch.zeros(0, dtype=dtype, device=device)

        def ints(vals):
            return torch.tensor(vals, dtype=torch.int64, device=device)

        cols = list(zip(*rows)) if rows else [()] * 6
        its, gammas, sigmas, norms, objs, counters = (list(c) for c in cols)
        return Records(
            it=ints(its), gamma=col(gammas), sigma=col(sigmas), norm_res=col(norms),
            objective=col(objs),
            **{k: ints([getattr(c, k) for c in counters]) for k in Counters._fields},
            valid=torch.ones(len(its), dtype=torch.bool, device=device),
        )

    def numpy(self):
        """The columns as host numpy arrays (one copy each)."""
        return Records(*(np.asarray(v.detach().cpu()) for v in self))


class SolveResult(NamedTuple):
    """What every solver returns: the reference's ``(x, numit)`` plus the
    counters, records and failure diagnostics (``diag``)."""

    x: torch.Tensor
    y: Optional[torch.Tensor]
    numit: int
    norm_res: torch.Tensor
    counters: Counters
    records: Optional[Records] = None
    name: Optional[str] = None
    diag: Optional[dict] = None

    def with_name(self, name):
        return self._replace(name=name)


def l2sq(v):
    """||v||^2 for real dtypes."""
    return torch.sum(v * v)


def run_loop(carry0, step, maxit, history):
    """Drive a solver iteration on the host.

    ``step: carry -> (carry, record_row)`` must maintain ``carry.it`` (Python
    int, incremented once per iteration) and ``carry.done`` (Python bool,
    set when the stop criterion fires). The loop stops at ``maxit`` or once
    done, so it produces exactly the valid rows of the JAX package's
    scan-with-freeze, and its final carry is that scan's frozen carry.

    Returns ``(final_carry, rows)``; ``rows`` is None unless ``history``.
    """
    c = carry0
    rows = [] if history else None
    while c.it < maxit and not c.done:
        c, row = step(c)
        if history:
            rows.append(row)
    return c, rows
