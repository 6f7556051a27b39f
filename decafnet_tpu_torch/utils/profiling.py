"""Phase timing and tracing (port of decafnet_tpu/utils/profiling.py).

  * ``PhaseTimer``  accumulating wall-clock buckets (the reference's
                    prepare / forward / post_process / nms) and a summary
                    string; with ``sync`` a phase ends after the card has.
  * ``annotate``    a named region in a ``torch.profiler`` trace, and an
                    NVTX range when CUDA is in use.
  * ``trace``       a ``torch.profiler`` trace (CPU and CUDA activities) of
                    a block, written into a directory when one is given.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def _cuda_in_use():
    return torch.cuda.is_available() and torch.cuda.is_initialized()


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase. With ``sync`` each
    phase waits for the card (``torch.cuda.synchronize``) before it ends,
    when CUDA is in use, so queued device work counts in its phase."""

    def __init__(self, sync=False):
        self.buckets = defaultdict(list)
        self.sync = sync

    @contextlib.contextmanager
    def phase(self, name):
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and _cuda_in_use():
                torch.cuda.synchronize()
            self.buckets[name].append(time.perf_counter() - start)

    def add(self, name, seconds):
        self.buckets[name].append(seconds)

    def summary(self):
        parts = []
        for name, vals in self.buckets.items():
            parts.append(f"{name}: total {sum(vals):.3f}s "
                         f"mean {sum(vals) / max(len(vals), 1) * 1e3:.1f}ms "
                         f"(n={len(vals)})")
        return " | ".join(parts)

    def reset(self):
        self.buckets = defaultdict(list)


@contextlib.contextmanager
def annotate(name):
    """Named region: a ``record_function`` range in a ``torch.profiler``
    trace (cheap when no profiler runs) and an NVTX range when CUDA is in
    use."""
    nvtx = _cuda_in_use()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(trace_dir=None):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA when it is
    available) and write a trace into ``trace_dir``; without a directory,
    do nothing. Yields the profiler (None when not tracing)."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)) as prof:
        yield prof
