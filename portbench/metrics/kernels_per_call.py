"""kernels_per_call: device kernels in the profiler's traced window over
the decode calls made there (``Decoder.decode_calls``)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels or not ctx.traced_decodes:
        return None
    return len(ctx.trace.kernels) / ctx.traced_decodes
