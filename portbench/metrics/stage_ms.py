"""stage_ms: mean over the window of the program's "decode.stage" span
(one entry per decode call: the group's arrays joined on the host by
np.concatenate / np.repeat), in ms."""

from portbench import spans


def read(ctx):
    return spans.mean(ctx, "decode.stage", 1e3)
