"""fpn_ms: mean over the traced calls of the stream time of the model's
"model.fpn" stage (the video net's FPN; its CUDA events' interval on the current stream,
recorded while the profiler runs), in ms."""

from portbench import spans


def read(ctx):
    return spans.mean(ctx, "model.fpn.stream", 1e3)
