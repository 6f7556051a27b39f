"""What the readers of the program's own spans and counters share: the
window's entries of a name in the decoder's record (``ctx.phases``, one
entry a span or a counter's count) and the process's set-up record
(``decafnet_tpu_torch.utils.profiling.SETUP``). A program without the name
or the record gives None."""


def mean(ctx, name, scale=1.0):
    """The mean of the window's entries of ``name``, times ``scale``."""
    v = ctx.phases.get(name)
    return scale * sum(v) / len(v) if v else None


def setup_seconds(name):
    """The process's summed seconds of the set-up span ``name``."""
    from decafnet_tpu_torch.utils import profiling
    record = getattr(profiling, "SETUP", None)
    v = record.buckets.get(name) if record is not None else None
    return sum(v) if v else None
