"""h2d_mb: mean over the window of the program's "decode.h2d_bytes"
counter (one entry per decode call: the bytes of every array it sends to
the device), in MB (1e6 bytes)."""

from portbench import spans


def read(ctx):
    return spans.mean(ctx, "decode.h2d_bytes", 1e-6)
