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


# the kernels of an op, by the route its wrapper picks from the shape: the
# tuned kernels, the wide ones (conv3 C_out 257 to 1024, band attention off
# the tuned shape, the trio C 257 to 4096), conv3's pass ones (1025 to 4096),
# and the general ones (the shapes the others are not built for); ops
# without a route's kernel count 0 there
ROUTES = ("tuned", "wide", "passes", "general")
# each op's launch counters: per route, f32 and bf16
COUNTERS = ("launches", "launches_bf16", "launches_general",
            "launches_general_bf16", "launches_wide", "launches_wide_bf16",
            "launches_passes", "launches_passes_bf16")


def reset_launch_counts():
    for op in KERNEL_OPS:
        for attr in COUNTERS:
            setattr(op, attr, 0)


def launch_counts(dtype=torch.float32, route="tuned"):
    """Launches of each op's kernel of ``route`` (one of ROUTES) for
    ``dtype`` activations (f32 or bf16) since the last
    :func:`reset_launch_counts`."""
    attr = ("launches" + {"tuned": "", "wide": "_wide", "passes": "_passes",
                          "general": "_general"}[route]
            + {torch.float32: "", torch.bfloat16: "_bf16"}[dtype])
    return {op.__name__: getattr(op, attr) for op in KERNEL_OPS}


reset_launch_counts()
