"""library_load_s: the program's "setup.library" span: the kernel
library checked, built when this checkout has none, and loaded, in seconds
of this process."""

from portbench import spans


def read(ctx):
    return spans.setup_seconds("setup.library")
