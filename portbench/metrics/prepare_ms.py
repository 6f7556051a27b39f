"""prepare_ms: mean over the window of the service's own "prepare" timer
(``Decoder.time_dict``, one entry per request: ``video_items`` ->
``batchify_eval``), in ms."""


def read(ctx):
    v = ctx.phases.get("prepare")
    return 1e3 * sum(v) / len(v) if v else None
