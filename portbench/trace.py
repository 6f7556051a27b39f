"""Reading ``torch.profiler``'s trace of a traced window: the device's busy
time (union of its operations), each kernel's time, the operations that
took the most time, and the device's idle gaps labelled by what the host
was doing meanwhile (each gap cut at the benchmark spans' edges, each piece
named by the innermost span and host operation open at its middle).

Events come from the profiler's raw kineto results, which hold host
operations and device activity on one clock. The window is the host span
named ``WINDOW``; only device activity inside it counts.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "portbench.window"
SPAN_PREFIX = "portbench."


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list = field(default_factory=list)   # (name, seconds)
    device_ops: list = field(default_factory=list)  # top (name, seconds)
    idle_gaps: list = field(default_factory=list)   # top (label, seconds)

    def kernel_seconds(self, *needles):
        """Summed time of the kernels whose name holds any of ``needles``."""
        return sum(s for n, s in self.kernels if any(k in n for k in needles))


def _ns(ev, what):
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _raw(prof):
    """(name, on_device, kind, start_ns, end_ns, thread) of every event."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        on_device = str(ev.device_type()).split(".")[-1] != "CPU"
        kind = str(ev.activity_type()) if hasattr(ev, "activity_type") else ""
        out.append((ev.name(), on_device, kind.lower(), start, end,
                    ev.start_thread_id() if hasattr(ev, "start_thread_id")
                    else 0))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _open_at(events, p, lookback):
    """The innermost of the nested (start, end, name) ``events`` (sorted by
    start) open at ``p``: the latest-starting one that has not ended."""
    i = bisect.bisect_right(events, (p, float("inf")))
    for s, e, name in reversed(events[max(0, i - lookback):i]):
        if e >= p:
            return name
    return None


def _pieces(gaps, spans):
    """The idle gaps cut where a benchmark span starts or ends inside one,
    so each piece lies within one span (or none)."""
    edges = sorted({t for s, e, _ in spans for t in (s, e)})
    out = []
    for g0, g1 in gaps:
        cuts = edges[bisect.bisect_right(edges, g0):bisect.bisect_left(edges, g1)]
        bounds = [g0, *cuts, g1]
        out.extend(zip(bounds[:-1], bounds[1:]))
    return out


def _labels(host, pieces):
    """For each piece, "<innermost benchmark span>|<innermost host op>" of
    the host events ``host`` ((start, end, name), one thread) open at its
    middle."""
    spans = sorted((s, e, n[len(SPAN_PREFIX):]) for s, e, n in host
                   if n.startswith(SPAN_PREFIX))
    ops = sorted((s, e, n) for s, e, n in host
                 if not n.startswith(SPAN_PREFIX))
    mids = [(a + b) // 2 for a, b in pieces]
    return [f"{_open_at(spans, p, len(spans)) or '-'}|"
            f"{_open_at(ops, p, 256) or '-'}" for p in mids]


def read(prof, top=10):
    """The :class:`Trace` of the profiler ``prof`` over its ``WINDOW``."""
    events = _raw(prof)
    windows = [e for e in events if not e[1] and e[0] == WINDOW]
    if not windows:
        raise RuntimeError(f"no {WINDOW!r} span in the trace")
    w0, w1 = windows[0][3], windows[0][4]
    thread = windows[0][5]
    # the device side of a host span (a GPU user annotation) is no work
    device = [(max(s, w0), min(e, w1), name, kind)
              for name, dev, kind, s, e, _ in events
              if dev and e > w0 and s < w1 and "annotation" not in kind
              and not name.startswith(SPAN_PREFIX)]
    busy = _union([(s, e) for s, e, _, _ in device])
    kernels = [(name, (e - s) / 1e9) for s, e, name, kind in device
               if "memcpy" not in kind and "memset" not in kind
               and not name.startswith(("Memcpy", "Memset"))]
    by_name = defaultdict(float)
    for s, e, name, _ in device:
        by_name[name] += (e - s) / 1e9
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    host = [(s, e, name) for name, dev, _, s, e, th in events
            if not dev and th == thread and name != WINDOW
            and e > w0 and s < w1]
    pieces = _pieces(gaps, [h for h in host if h[2].startswith(SPAN_PREFIX)])
    by_label = defaultdict(float)
    for (s, e), label in zip(pieces, _labels(host, pieces)):
        by_label[label] += (e - s) / 1e9
    return Trace(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        kernels=kernels,
        device_ops=sorted(([n, s] for n, s in by_name.items()),
                          key=lambda r: -r[1])[:top],
        idle_gaps=sorted(([n, s] for n, s in by_label.items()),
                         key=lambda r: -r[1])[:top])
