"""dispatch_ms: mean over the window of the program's "decode.dispatch"
span (one entry per decode call: from the model's first launch to the
last launch of the select and NMS stage; the host waits here only where the
launch queue is full), in ms."""

from portbench import spans


def read(ctx):
    return spans.mean(ctx, "decode.dispatch", 1e3)
