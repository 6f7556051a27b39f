"""d2h_wait_ms: mean over the window of the program's "decode.d2h" span
(one entry per decode call: the outputs copied to the host, where the host
waits for the device to finish the call's work), in ms."""

from portbench import spans


def read(ctx):
    return spans.mean(ctx, "decode.d2h", 1e3)
