"""Profiling and timing helpers (counterpart of
``pythtb_tpu.utils.profiling``).

``trace`` records a ``torch.profiler`` trace (Chrome / Perfetto JSON).
``timed`` and ``benchmark`` time on the device the package runs on
(:func:`pythtb_tpu_torch.config.device`): on the card with CUDA events
recorded behind a ``torch.cuda.synchronize`` -- the work queued before
is finished first, so the events' span is the block's own -- and on the
CPU with ``time.perf_counter``.  A time from the CPU is never a device
time.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .. import config

__all__ = ["trace", "timed", "benchmark"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (host and, on the
    card, device activity) into ``log_dir/trace.json`` for Perfetto or
    chrome://tracing.

    Example::

        with pythtb_tpu_torch.utils.profiling.trace("tb"):
            model.solve_all(kpts)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    on_card = config.device().type == "cuda"
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if on_card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _Clock:
    """Start and stop marks on the package's device: CUDA events behind a
    synchronize on the card, the host clock on the CPU."""

    def __init__(self):
        self.card = config.device().type == "cuda"

    def start(self, sync=True):
        if self.card:
            if sync:
                torch.cuda.synchronize()
            self.begin = torch.cuda.Event(enable_timing=True)
            self.begin.record()
        else:
            self.begin = time.perf_counter()

    def stop(self) -> float:
        """Seconds since :meth:`start`, the device's work included."""
        if self.card:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return self.begin.elapsed_time(end) / 1e3
        return time.perf_counter() - self.begin


@contextlib.contextmanager
def timed(label: str = "block", sync: bool = True, out: list = None):
    """Time a block in seconds: appended to ``out``, or printed.  On the
    card the span runs from a start event, which the device reaches once
    the work queued before the block is done, to an end event after it;
    ``sync`` also makes the host wait for the earlier work first."""
    clock = _Clock()
    clock.start(sync)
    yield
    dt = clock.stop()
    if out is not None:
        out.append(dt)
    else:
        print("[pythtb_tpu_torch] %s: %.4f s" % (label, dt))


def benchmark(fn, *args, warmup: int = 1, iters: int = 3):
    """Best-of-``iters`` steady time of ``fn(*args)`` in seconds, the
    device's work included, after ``warmup`` calls.  Returns (best_seconds,
    result)."""
    result = None
    clock = _Clock()
    for _ in range(max(warmup, 0)):
        clock.start()
        result = fn(*args)
        clock.stop()
    best = float("inf")
    for _ in range(max(iters, 1)):
        clock.start()
        result = fn(*args)
        best = min(best, clock.stop())
    return best, result
