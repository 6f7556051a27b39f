"""queries_per_s: real queries answered in the window over the window's
host-clock seconds (padded query rows and inert copies are not queries)."""


def read(ctx):
    return ctx.queries / ctx.window_s if ctx.window_s > 0 else None
