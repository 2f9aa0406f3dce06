"""Timing on the card (counterpart of ``adaprox_tpu/utils/profiling.py``).

``timed(fn, reps)`` times ``fn()`` with CUDA events around each call and a
``torch.cuda.synchronize()`` after it, so the time is the device's, not the
enqueue's. It needs a card: a CPU time is not a device time.
"""

from __future__ import annotations

import torch

__all__ = ["timed"]


def timed(fn, reps: int = 3):
    """Best-of-``reps`` seconds of ``fn()`` on the card, after one untimed
    warm-up call. Returns ``(seconds, last_output)``."""
    if not torch.cuda.is_available():
        raise RuntimeError("timed() measures on a CUDA device and none is available")
    out = fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best, out
