"""Shared experiment harness (counterpart of
``adaprox_tpu/experiments/common.py``, record-solve subset).

A driver builds the problem, runs each method of its menu with
``history=True``, writes the reference-schema JSONL (utils.logging) and
echoes log-spaced rows to the console.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resident_bt import resident_agraal_records, resident_bt_records
from ..solvers.backtracking import backtracking_nesterov, backtracking_proxgrad
from ..utils import logging as tlog
from ..utils.jax_random import normal

__all__ = ["Sink", "group_rows", "plot_lines", "pad_tiles", "sync_wall", "run_timed",
           "run_menu", "BT_ROWS", "bt_menu", "bt_sweep_rows", "add_bt_rows", "companion_point",
           "add_agraal_row"]

# the backtracking rows of the lasso, sparse_logreg and cubic_sparse_logreg menus,
# in the reference order: (name, xi, nesterov)
BT_ROWS = tuple((f"PGM (backtracking)-(xi={xi})", xi, False) for xi in (1.0, 1.5, 2.0)) + (
    ("Nesterov (backtracking)", 1.0, True),)


def pad_tiles(a, b, m_mult=8, n_mult=128):
    """Zero-pad (A, b) to multiples of (m_mult, n_mult), as the JAX driver does
    for its TPU tiles, so the port's JSONL is comparable with it. Exact for
    least-squares + separable g with prox(0) = 0: padded rows have zero
    residual, padded columns get zero gradient and stay exactly 0."""
    m, n = a.shape
    mp = -(-m // m_mult) * m_mult
    np_ = -(-n // n_mult) * n_mult
    if (mp, np_) != (m, n):
        a = F.pad(a, (0, np_ - n, 0, mp - m))
        b = F.pad(b, (0, mp - m))
    return a, b


def sync_wall(fn):
    """Run ``fn`` and return ``(out, wall_seconds)``, synchronising the card
    (when one was used) before the clock stops: the shared timing primitive
    of the drivers' wall columns."""
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_timed(times, name, fn):
    """Run ``fn`` and record its wall time (``sync_wall``) under ``name``.
    Includes the first call's kernel build, if any: the wall column is what
    a user waits for."""
    res, secs = sync_wall(fn)
    times[name] = round(secs, 4)
    return res


def run_menu(sink, times, menu):
    """Run a method menu as ``history=True`` record solves. Each entry is
    ``(name, maxit, make)`` with ``make(maxit=..., history=...)`` returning a
    SolveResult. Returns the fast_path label for the driver's meta row."""
    for name, mx, make in menu:
        sink.add(run_timed(times, name, lambda mx=mx, make=make: make(
            maxit=mx, history=True)))
    return "default"


def bt_menu(rows, x0, gamma0, maxit, base):
    """Engine menu entries ``(name, maxit, make)`` of backtracking ``rows``
    ((name, xi, nesterov) each), all from ``gamma0``; ``base`` holds f, g and
    tol."""
    def make(name, xi, nesterov):
        if nesterov:
            return lambda **o: backtracking_nesterov(x0, gamma0=gamma0, name=name, **base, **o)
        return lambda **o: backtracking_proxgrad(x0, gamma0=gamma0, xi=xi, name=name, **base,
                                                 **o)

    return [(name, maxit, make(name, xi, nesterov)) for name, xi, nesterov in rows]


def bt_sweep_rows(rows, gamma0):
    """The (R, 3) table [gamma0, xi, nesterov_flag] of ``resident_bt_sweep``."""
    return np.asarray([[gamma0, xi, 1.0 if nesterov else 0.0] for _, xi, nesterov in rows])


def add_bt_rows(sink, rows, out, maxit, only=None):
    """Write the records of a ``resident_bt_sweep`` output ``out`` for
    ``rows`` ((name, xi, nesterov) each, in the table's order), or for the
    rows named in ``only``, in that order."""
    _, numit, _, _, _, hists = out
    index = {name: j for j, (name, _, _) in enumerate(rows)}
    for name in (only or index):
        j = index[name]
        sink.add(SimpleNamespace(records=resident_bt_records(
            numit[j], *(h[j] for h in hists), maxit=maxit, nesterov=rows[j][2]), name=name))


def companion_point(x0, n):
    """aGRAAL's companion point as the JAX drivers draw it: ``x0`` plus
    ``jax.random.normal(PRNGKey(0), (n,))`` on its first ``n`` coordinates
    (``utils.jax_random``), so zero-padded coordinates stay 0."""
    noise = normal(0, (n,), str(x0.dtype).removeprefix("torch."))
    x0p = x0.clone()
    x0p[:n] += torch.from_numpy(noise).to(x0.device)
    return x0p


def add_agraal_row(sink, out, maxit):
    """Write the aGRAAL row of a record-mode ``resident_agraal`` output."""
    numit, hists = out[1], out[4:7]
    sink.add(SimpleNamespace(records=resident_agraal_records(numit, *hists, maxit=maxit),
                             name="aGRAAL"))


class Sink:
    """JSONL sink + console echo for one experiment output file. ``keys``
    projects every record row onto those columns, as the reference's
    ``get_logger(path, keys)`` does (experiments/logging.jl:24-27)."""

    def __init__(self, path, keys=None):
        self.path = str(path)
        self.keys = keys
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        open(self.path, "w").close()  # truncate

    def emit_pseudo(self, row: dict):
        """A non-solver record (e.g. the known optimum, lasso runme.jl:79)."""
        tlog.write_jsonl(self.path, [row], keys=self.keys)

    def emit_meta(self, **meta):
        """An unprojected metadata row (e.g. the drivers' wall_s)."""
        tlog.write_jsonl(self.path, [dict(meta)])

    def add(self, result, primal_dual=None):
        """Write ``result``'s valid record rows; ``primal_dual`` picks the PD
        schema (inferred from the A_evals column when None)."""
        n, last = tlog.write_records_jsonl(self.path, result.records.numpy(), result.name,
                                           primal_dual=primal_dual, keys=self.keys)
        if last is not None:
            tlog.echo_logstep_rows([last])
        return n


def group_rows(rows):
    by = defaultdict(list)
    for r in rows:
        if r.get("method") is None:
            continue
        by[r["method"]].append(r)
    return by


def plot_lines(path, series, title, xlabel, ylabel):
    """Convergence plot: log-y lines per method. ``series`` is a list of
    (label, xs, ys). Returns None when matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for label, xs, ys in series:
        ys = np.maximum(np.asarray(ys, float), 1e-14)
        ax.semilogy(xs, ys, label=label, linewidth=1.2)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.legend(fontsize=7)
    fig.tight_layout()
    out = str(path) + ".pdf"
    fig.savefig(out)
    plt.close(fig)
    return out
