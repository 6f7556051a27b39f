"""post_ms: mean over the window of the service's "post_process" timer
(one entry per decode call: per-row slicing and grid-to-seconds on the
host), in ms."""


def read(ctx):
    v = ctx.phases.get("post_process")
    return 1e3 * sum(v) / len(v) if v else None
