"""Tensor ops of the port: masked primitives, delegation, the three kernel
ops (each with its plain version), the device NMS and the host C++ NMS."""

import torch

from .delegation import delegate, delegation_weights, saliency_correlation
from .fused_conv import (conv3_ln_act, conv3_ln_act_levels, conv3_ln_act_torch,
                         qkv_depthwise_ln, qkv_depthwise_ln_torch)
from .local_attention import band_attention, band_attention_torch
from .masked import (channel_layer_norm, interpolate_linear_1d,
                     interpolate_nearest_1d, masked_avg_pool1d,
                     masked_max_pool1d, max_pool1d, sinusoid_encoding)
from .nms import (batched_nms_device, batched_nms_host, hard_nms_topk,
                  nms_host, segment_voting_host, segment_voting_xy,
                  soft_nms_topk, softnms_host)

KERNEL_OPS = (conv3_ln_act, band_attention, qkv_depthwise_ln)


# each op's launch counters: the tuned kernels' (f32, bf16) and the general
# kernels' (the shapes the tuned ones are not built for)
COUNTERS = ("launches", "launches_bf16", "launches_general",
            "launches_general_bf16")


def reset_launch_counts():
    for op in KERNEL_OPS:
        for attr in COUNTERS:
            setattr(op, attr, 0)


def launch_counts(dtype=torch.float32, general=False):
    """Launches of each op's tuned kernel (``general``: its general kernel)
    for ``dtype`` activations (f32 or bf16) since the last
    :func:`reset_launch_counts`."""
    attr = ("launches" + ("_general" if general else "")
            + {torch.float32: "", torch.bfloat16: "_bf16"}[dtype])
    return {op.__name__: getattr(op, attr) for op in KERNEL_OPS}
