"""device_idle: percent of the profiler's traced window in which no device
operation (kernel, copy or fill) runs."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
