"""h2d_ms: mean over the window of the program's "decode.h2d" span (one
entry per decode call: the staged arrays copied to the device, pageable),
in ms."""

from portbench import spans


def read(ctx):
    return spans.mean(ctx, "decode.h2d", 1e3)
