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

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import logging as tlog

__all__ = ["Sink", "group_rows", "plot_lines", "pad_tiles", "run_timed", "run_menu"]


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


def run_timed(times, name, fn):
    """Run ``fn`` and record its wall time under ``name``, synchronising the
    card (when one was used) before the clock stops. Includes the first
    call's kernel build, if any: the wall column is what a user waits for."""
    t0 = time.perf_counter()
    res = fn()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    times[name] = round(time.perf_counter() - t0, 4)
    return res


def run_menu(sink, times, menu):
    """Run a method menu as ``history=True`` record solves. Each entry is
    ``(name, maxit, make)`` with ``make(maxit=..., history=...)`` returning a
    SolveResult. Returns the fast_path label for the driver's meta row."""
    for name, mx, make in menu:
        sink.add(run_timed(times, name, lambda mx=mx, make=make: make(
            maxit=mx, history=True)))
    return "default"


class Sink:
    """JSONL sink + console echo for one experiment output file."""

    def __init__(self, path):
        self.path = str(path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        open(self.path, "w").close()  # truncate

    def emit_pseudo(self, row: dict):
        """A non-solver record (e.g. the known optimum, lasso runme.jl:79)."""
        tlog.write_jsonl(self.path, [row])

    def emit_meta(self, **meta):
        """A metadata row (e.g. the drivers' wall_s)."""
        tlog.write_jsonl(self.path, [dict(meta)])

    def add(self, result):
        n, last = tlog.write_records_jsonl(self.path, result.records.numpy(), result.name)
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
