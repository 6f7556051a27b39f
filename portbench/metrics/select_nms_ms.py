"""select_nms_ms: mean over the traced calls of the stream time of the
decode's "decode.select_nms" stage (score modulation, the top-k threshold
and the device SoftNMS; its CUDA events' interval on the current stream,
recorded while the profiler runs), in ms."""

from portbench import spans


def read(ctx):
    return spans.mean(ctx, "decode.select_nms.stream", 1e3)
