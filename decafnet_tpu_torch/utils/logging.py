"""Logging and metering utilities (port of decafnet_tpu/utils/logging.py)."""

from __future__ import annotations

import time

import numpy as np


class Logger:
    """Print + append-to-file logger with retries."""

    def __init__(self, path=None, quiet=False):
        self.path = path
        self.quiet = quiet

    def write(self, msg):
        if not self.quiet:
            print(msg, flush=True)
        if self.path:
            for _ in range(10):
                try:
                    with open(self.path, "a") as f:
                        f.write(str(msg) + "\n")
                    break
                except OSError:
                    time.sleep(0.1)


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value, n=1):
        self.sum += value * n
        self.count += n

    def item(self):
        return self.sum / max(self.count, 1)


def time_str(seconds):
    """Compact h/m/s string."""
    seconds = float(seconds)
    if seconds < 60:
        return f"{seconds:.2f}s"
    m, s = divmod(seconds, 60)
    if m < 60:
        return f"{int(m)}m{s:.0f}s"
    h, m = divmod(m, 60)
    return f"{int(h)}h{int(m)}m{s:.0f}s"


def count_parameters(params, scale=1e6):
    """Total parameter count of a flax-layout params tree (nested dicts of
    arrays), in ``scale`` units."""
    return sum(count_parameters(v, 1) if isinstance(v, dict)
               else int(np.prod(np.shape(v))) for v in params.values()) / scale


def easy_reduce(scores, mode="mean", skip_nan=False):
    """Recursive mean/max/median over a list of nested metric containers."""
    assert isinstance(scores, list)
    if len(scores) == 0:
        return np.nan
    first = scores[0]
    if isinstance(first, (list, tuple)):
        agg = [easy_reduce([s[i] for s in scores], mode, skip_nan)
               for i in range(len(first))]
        return tuple(agg) if isinstance(first, tuple) else agg
    if isinstance(first, dict):
        return {k: easy_reduce([s[k] for s in scores], mode, skip_nan)
                for k in first}
    if isinstance(first, np.ndarray):
        return np.stack(scores, 0).mean(0)
    values = [float(x) for x in scores]
    if skip_nan:
        values = [x for x in values if not np.isnan(x)]
        if not values:
            return np.nan
    if mode == "mean":
        return float(np.mean(values))
    if mode == "max":
        return float(np.max(values))
    if mode == "median":
        return float(np.median(values))
    raise ValueError(mode)
