"""Timing and device profiling on the card (counterpart of
``adaprox_tpu/utils/profiling.py``).

* ``timed(fn, reps)`` times ``fn()`` with CUDA events around each call and a
  ``torch.cuda.synchronize()`` after it, so the time is the device's, not the
  enqueue's. It needs a card: a CPU time is not a device time.
* ``trace(logdir)`` is a ``torch.profiler`` context that writes a Chrome trace
  of the enclosed block into ``logdir`` (CPU activity, and the card's where
  there is one).
* ``throughput_report(...)`` turns a time, an iteration count and the bytes an
  iteration moves into iterations/s, GB/s and the fraction of the card's
  data-sheet memory rate (``chip_bandwidth_gbps``).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["timed", "flushed_ms", "trace", "throughput_report", "HBM_GBPS",
           "chip_bandwidth_gbps"]

# flushed_ms's default buffer: 256 MiB, five times the H100's 50 MB L2
FLUSH_BYTES = 256 << 20
# the card's head start while the host queues flushed_ms's calls: some 10 ms at H100 clocks
_LEAD_CYCLES = 20_000_000

# Device-memory rates of NVIDIA's data sheets (SXM parts), GB/s, keyed by the
# start of torch.cuda.get_device_name (the longest match wins).
HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
    "NVIDIA H200": 4800.0,
}


def chip_bandwidth_gbps(device=None) -> float:
    """The data-sheet memory rate (GB/s) of ``device`` (default: the current
    CUDA device). NaN for the CPU, for a card not in ``HBM_GBPS``, or when no
    card is present: a made-up roof would make every fraction of it a
    made-up number, so throughput_report's fraction is NaN there too."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
        else torch.device("cpu"))
    if device.type != "cuda":
        return float("nan")
    name = torch.cuda.get_device_name(device)
    for key, gbps in sorted(HBM_GBPS.items(), key=lambda kv: -len(kv[0])):
        if name.startswith(key):
            return gbps
    return float("nan")


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


def flushed_ms(fn, reps: int = 20, flush_bytes: int = FLUSH_BYTES) -> float:
    """Mean CUDA-event ms of one call of ``fn()`` on the card, without the host's time:
    the card is held busy (``torch.cuda._sleep``) while the host queues all ``reps``
    calls, each between its own pair of events, so no call waits for its launch. With
    ``flush_bytes`` > 0 (cold) a buffer of that many bytes is written and then read
    before each call, outside the events: ``fn`` finds none of its inputs in the L2, and
    no dirty line of the buffer is left to be written back during the call (which a
    write alone would charge to it). ``flush_bytes`` 0: back to back (warm). After one
    untimed warm-up call."""
    if not torch.cuda.is_available():
        raise RuntimeError("flushed_ms() measures on a CUDA device and none is available")
    buf = torch.empty(max(flush_bytes // 4, 1), dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(_LEAD_CYCLES)
    for i, (start, end) in enumerate(events):
        if flush_bytes > 0:
            buf.fill_(float(i))
            buf.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / reps


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace of the enclosed block, written to
    ``logdir/trace_<pid>_<ns>.json`` (Chrome trace format: Perfetto or
    chrome://tracing). Records the card's activity too when CUDA is
    available. Yields the profiler (``key_averages()`` for sums by name)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.monotonic_ns()}.json"))


def throughput_report(seconds: float, iters: int, bytes_per_iter: float, device=None) -> dict:
    """Iterations/s, achieved GB/s and its fraction of the card's data-sheet
    rate (``chip_bandwidth_gbps(device)``; NaN where that is unknown)."""
    roofline = chip_bandwidth_gbps(device)
    ips = iters / seconds
    gbps = bytes_per_iter * ips / 1e9
    return {
        "iters_per_sec": ips,
        "achieved_gbps": gbps,
        "roofline_gbps": roofline,
        "frac_roofline": gbps / roofline,
    }
