"""decode_mfu: the model's FLOPs for the window's real queries at their
bucket length (``portbench.counts.model_flops``) over the window's
host-clock seconds, as a percent of the card's peak for the compute dtype
(495 TFLOP/s TF32 for f32, 989 bf16)."""

from portbench import counts


def read(ctx):
    flops = sum(counts.model_flops(ctx.model, c) for c in ctx.calls)
    return counts.mfu(flops, ctx.window_s, ctx.dtype) if flops else None
