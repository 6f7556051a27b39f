"""request_p95_ms: the 95th percentile of the wall time of the window's
calls that ran outside the profiler, from the call to its host results
(``statistics.quantiles``, exclusive method); none with fewer than 200
such calls, so that at least ten lie beyond it."""

import statistics


def read(ctx):
    latencies = ctx.latencies[ctx.traced_n:]
    if len(latencies) < 200:
        return None
    return 1e3 * statistics.quantiles(latencies, n=20)[18]
