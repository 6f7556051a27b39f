"""forward_ms: mean over the window of the service's "forward" timer (one
entry per decode call: the H2D copies, the forward, the device SoftNMS and
the D2H copy), in ms."""


def read(ctx):
    v = ctx.phases.get("forward")
    return 1e3 * sum(v) / len(v) if v else None
