"""band_roofline: the band kernels' least time on the card for the traced
calls' shapes (``portbench.counts.band_bound``) over their summed device
time in the profiler's traced window (kernels named ``band_attention*``), in
percent."""

from portbench import counts


def read(ctx):
    if ctx.trace is None:
        return None
    seconds = ctx.trace.kernel_seconds("band_attention")
    if seconds <= 0:
        return None
    bound = sum(counts.band_bound(ctx.model, c, ctx.dtype)
                for c in ctx.traced_calls)
    return 100.0 * bound / seconds
