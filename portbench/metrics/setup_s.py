"""setup_s: host-clock seconds from the process's start to the end of the
warm-up: imports, the CUDA context, the kernel library (built on a first
run in the checkout), weights and requests from the seed, the service, and
the warm-up calls of the cell's bucket."""


def read(ctx):
    return ctx.setup_s
