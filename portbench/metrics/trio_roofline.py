"""trio_roofline: the trio kernels' least time on the card for the traced
calls' shapes (``portbench.counts.trio_bound``) over their summed device
time in the profiler's traced window (kernels named ``qkv_depthwise_ln*``), in
percent."""

from portbench import counts


def read(ctx):
    if ctx.trace is None:
        return None
    seconds = ctx.trace.kernel_seconds("qkv_depthwise_ln")
    if seconds <= 0:
        return None
    bound = sum(counts.trio_bound(ctx.model, c, ctx.dtype)
                for c in ctx.traced_calls)
    return 100.0 * bound / seconds
