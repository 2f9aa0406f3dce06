"""Telemetry: the reference's JSONL record schema (numpy only).

A copy of ``adaprox_tpu/utils/logging.py``'s writer half, without the JAX
package: that package imports jax, which the GPU machine does not have. The
tests hold the two copies to identical output.

Schema per row (src/AdaProx.jl record kwargs):

    {"method": name, "it": k, "gamma": ..., ["sigma": ...,] "norm_res": ...,
     "objective": ..., "grad_f_evals": n, "prox_g_evals": n,
     ["prox_h_evals": n, "A_evals": n, "At_evals": n,] "f_evals": n}

``records`` arguments are any object with the ``Records`` fields whose
columns ``np.asarray`` can read (the solvers' ``Records.numpy()``).
"""

from __future__ import annotations

import json
import math
import time
from typing import Iterable, Optional, Sequence

import numpy as np

__all__ = [
    "PG_KEYS",
    "PD_KEYS",
    "records_to_rows",
    "write_records_jsonl",
    "write_jsonl",
    "read_jsonl",
    "is_logstep",
    "echo_logstep_rows",
    "find_best",
]

PG_KEYS = ["method", "it", "gamma", "norm_res", "objective",
           "grad_f_evals", "prox_g_evals", "f_evals"]
PD_KEYS = ["method", "it", "gamma", "sigma", "norm_res", "objective",
           "grad_f_evals", "prox_g_evals", "prox_h_evals", "A_evals",
           "At_evals", "f_evals"]

_COUNT_KEYS = ("f_evals", "grad_f_evals", "prox_g_evals", "prox_h_evals",
               "A_evals", "At_evals")


def _row(r, i, keys, method):
    row = {}
    for k in keys:
        if k == "method":
            row[k] = method
        elif k in _COUNT_KEYS or k == "it":
            row[k] = int(r[k][i])
        else:
            row[k] = float(r[k][i])
    return row


def records_to_rows(records, method: Optional[str], *, primal_dual: Optional[bool] = None):
    """Materialize a solver's records into JSONL-ready dict rows.

    Only valid (pre-convergence) rows are emitted. ``primal_dual`` selects
    the PD schema (adds sigma / prox_h / A / At columns); by default it is
    inferred from whether any A_evals were metered.
    """
    r = {k: np.asarray(getattr(records, k)) for k in records._fields}
    valid = r["valid"].astype(bool)
    if primal_dual is None:
        primal_dual = bool(r["A_evals"][valid].max(initial=0) > 0)
    keys = PD_KEYS if primal_dual else PG_KEYS
    return [_row(r, i, keys, method) for i in np.nonzero(valid)[0]]


def write_records_jsonl(path, records, method: Optional[str], *,
                        primal_dual: Optional[bool] = None,
                        keys: Optional[Sequence[str]] = None):
    """Write a solver's records to JSONL (the Python writer; the JAX
    package's native C++ sink is not ported yet).

    Returns ``(n_rows_written, last_row_dict_or_None)``; the last row carries
    the full schema and feeds the log-spaced console echo.
    """
    r = {k: np.asarray(getattr(records, k)) for k in records._fields}
    valid = r["valid"].astype(bool)
    idx = np.nonzero(valid)[0]
    if idx.size == 0:
        return 0, None
    if primal_dual is None:
        primal_dual = bool(r["A_evals"][valid].max(initial=0) > 0)
    schema = PD_KEYS if primal_dual else PG_KEYS
    last_row = _row(r, idx[-1], [k for k in schema if k == "method" or k in r], method)
    rows = records_to_rows(records, method, primal_dual=primal_dual)
    write_jsonl(path, rows, keys=keys)
    return len(rows), last_row


def write_jsonl(path, rows: Iterable[dict], *, keys: Optional[Sequence[str]] = None,
                mode: str = "a"):
    """Write rows as JSON-lines; optional key projection like the reference's
    ``get_logger(path, keys)`` (experiments/logging.jl:24-27)."""
    with open(path, mode) as fh:
        for row in rows:
            if keys is not None:
                row = {k: row[k] for k in keys if k in row}
            fh.write(json.dumps(row) + "\n")


def read_jsonl(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def is_logstep(it: int, base: int = 10) -> bool:
    """True when ``it`` is a multiple of the current power of ``base``
    (experiments/logging.jl:13-17), used to decimate the console echo."""
    if it <= 0:
        return False
    scale = math.floor(math.log(it, base))
    step = base**scale
    return it % step == 0


def echo_logstep_rows(rows, base: int = 10, out=print):
    """Console echo of log-spaced rows with a timestamp, mirroring the
    reference's decimated ConsoleLogger (experiments/logging.jl:29-41)."""
    for row in rows:
        if is_logstep(int(row.get("it", 0)), base):
            stamp = time.strftime("%Y-%m-%d %H:%M:%S")
            out(f"[{stamp}] " + json.dumps(row))


def find_best(groups: dict, names, objective_key: str, objective_target: float, duration_key):
    """Pick the best hyperparameter variant of a method family
    (experiments/logging.jl:48-67): among the runs whose final
    ``objective_key`` reached ``objective_target``, the one with the smallest
    duration (the max of ``duration_key``, a column name or a callable on the
    rows); if none reached it, the one with the best final value. ``groups``
    maps name -> list of record rows (dicts)."""
    def duration(rows):
        if callable(duration_key):
            return max(duration_key(row) for row in rows)
        return max(row[duration_key] for row in rows)

    names = list(names)
    best_name, rest = names[0], names[1:]
    best_duration = -1.0
    best_val = groups[best_name][-1][objective_key]
    if best_val <= objective_target:
        best_duration = duration(groups[best_name])
    for name in rest:
        dur = duration(groups[name])
        val = groups[name][-1][objective_key]
        if val <= objective_target and (dur < best_duration or best_duration < 0):
            best_name = name
            best_duration = dur
        elif best_duration < 0 and val < best_val:
            best_name = name
            best_val = val
    return best_name
