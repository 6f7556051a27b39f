"""service_init_s: the program's "setup.service" span: the grounding
service built (model, weights to the device, the decoder's point table),
in seconds of this process."""

from portbench import spans


def read(ctx):
    return spans.setup_seconds("setup.service")
