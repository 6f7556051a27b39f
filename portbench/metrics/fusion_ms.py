"""fusion_ms: mean over the traced calls of the stream time of the model's
"model.fusion" stage (its CUDA events' interval on the current stream,
recorded while the profiler runs), in ms."""

from portbench import spans


def read(ctx):
    return spans.mean(ctx, "model.fusion.stream", 1e3)
