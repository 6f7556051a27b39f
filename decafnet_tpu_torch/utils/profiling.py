"""Spans, counters and tracing (port of decafnet_tpu/utils/profiling.py).

  * ``PhaseTimer``  the program's record of spans and counters: one list a
                    name, one entry an occurrence (a span's host seconds, or
                    a count), in the reference's buckets (prepare / forward
                    / post_process / nms) and the decode call's parts; with
                    ``sync`` a span ends after the card has. Its ``phase``
                    is the program's one span (see there for what it
                    records while a ``torch.profiler`` runs).
  * ``stage``       a span of the record active in this context
                    (:meth:`PhaseTimer.recording`), for code that holds no
                    record of its own: the model's stages.
  * ``SETUP``       the process-wide record of set-up: ``setup.service``
                    (a ``GroundingService`` built), ``setup.library`` (the
                    kernel library checked, built and loaded) and
                    ``setup.first_call`` (each decode shape's first call,
                    less a library load inside it).
  * ``annotate``    a named region in a ``torch.profiler`` trace, and an
                    NVTX range when CUDA is in use.
  * ``trace``       a ``torch.profiler`` trace (CPU and CUDA activities) of
                    a block, written into a directory when one is given.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from collections import defaultdict

import torch

# a range's name in the trace: the prefix and the span's name
SPAN_PREFIX = "decafnet."
# entries a name keeps; past it the oldest half is dropped
LIMIT = 65536

_ACTIVE = contextvars.ContextVar("decafnet_record", default=None)
_OFF = contextlib.nullcontext()


def _cuda_in_use():
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _profiler_on():
    return torch._C._autograd._profiler_enabled()


def _range(name):
    """A range ``name`` in the running ``torch.profiler``'s trace, opened
    as an operator's range (the one torch's generated graph code opens). A
    ``record_function`` range is a user annotation instead, and the
    profiler gives each such range that launches device work a device-side
    copy spanning that work, which a reader of the device timeline takes
    for device work."""
    return torch._C._profiler._RecordFunctionFast(name)


def is_count(name):
    """True for the names whose entries are counts, not seconds."""
    return name.endswith(("bytes", "rows"))


class PhaseTimer:
    """Per name, one entry per occurrence: a span's wall-clock seconds or a
    counter's count (``buckets``, a dict that stays the same object; at most
    ``LIMIT`` entries a name). With ``sync`` each span waits for the card
    (``torch.cuda.synchronize``) before it ends, when CUDA is in use, so
    queued device work counts in its span."""

    def __init__(self, sync=False):
        self.buckets = defaultdict(list)
        self.sync = sync
        self._stages = []    # (name, start, end) CUDA events of traced stages
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name, stream=False):
        """A span: its host seconds are appended under ``name``. While a
        ``torch.profiler`` records, it is also a range ``decafnet.<name>``
        in the trace (:func:`_range`), and with ``stream`` a pair of CUDA
        events on the current stream, whose interval :meth:`stream_times`
        appends under ``<name>.stream``. Otherwise that costs one check."""
        start = time.perf_counter()
        if not _profiler_on():
            try:
                yield
            finally:
                self._end(name, start)
            return
        with _range(SPAN_PREFIX + name):
            events = None
            if stream and _cuda_in_use():
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            try:
                yield
            finally:
                if events is not None:
                    events[1].record()
                    self._stages.append((name,) + events)
                self._end(name, start)

    def _end(self, name, start):
        if self.sync and _cuda_in_use():
            torch.cuda.synchronize()
        self.add(name, time.perf_counter() - start)

    def add(self, name, value):
        """Append one entry (seconds or a count) under ``name``."""
        with self._lock:
            v = self.buckets[name]
            v.append(value)
            if len(v) > LIMIT:
                del v[:LIMIT // 2]

    def total(self, name):
        return sum(self.buckets.get(name, ()))

    def stream_times(self):
        """Append each traced stage's stream seconds (its CUDA events'
        interval) under ``<name>.stream``; call once the stream has passed
        them (after a synchronising copy)."""
        for name, start, end in self._stages:
            end.synchronize()
            self.add(name + ".stream", start.elapsed_time(end) / 1e3)
        self._stages.clear()

    @contextlib.contextmanager
    def recording(self, call=None):
        """This record is the context's active one (:func:`stage` spans go
        into it). ``call``, a decode call's number, names a range
        ``decafnet.call.<n>`` around the block while a profiler records, so
        the call's ranges nest in one that carries its number."""
        token = _ACTIVE.set(self)
        try:
            if call is not None and _profiler_on():
                with _range(f"{SPAN_PREFIX}call.{call}"):
                    yield
            else:
                yield
        finally:
            _ACTIVE.reset(token)

    def summary(self):
        parts = []
        for name, vals in self.buckets.items():
            mean = sum(vals) / max(len(vals), 1)
            if is_count(name):
                parts.append(f"{name}: total {sum(vals)} mean {mean:.1f} "
                             f"(n={len(vals)})")
            else:
                parts.append(f"{name}: total {sum(vals):.3f}s "
                             f"mean {mean * 1e3:.1f}ms (n={len(vals)})")
        return " | ".join(parts)

    def reset(self):
        self.buckets.clear()
        self._stages.clear()


SETUP = PhaseTimer()


def stage(name):
    """A span with stream time (``PhaseTimer.phase(name, stream=True)``) of
    the record active in this context; with none, nothing."""
    record = _ACTIVE.get()
    return _OFF if record is None else record.phase(name, stream=True)


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
