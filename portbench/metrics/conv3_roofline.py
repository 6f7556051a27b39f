"""conv3_roofline: the conv3 kernels' least time on the card for the traced
calls' shapes (``portbench.counts.conv3_bound``) over their summed device
time in the profiler's traced window (kernels named ``conv3_ln_act*``), in
percent."""

from portbench import counts


def read(ctx):
    if ctx.trace is None:
        return None
    seconds = ctx.trace.kernel_seconds("conv3_ln_act")
    if seconds <= 0:
        return None
    bound = sum(counts.conv3_bound(ctx.model, c, ctx.dtype)
                for c in ctx.traced_calls)
    return 100.0 * bound / seconds
