"""first_call_s: the program's "setup.first_call" span, summed over the
process: each decode shape's first call (the warm-up's first call here),
less the kernel library's load when that call loads it, in seconds."""

from portbench import spans


def read(ctx):
    return spans.setup_seconds("setup.first_call")
