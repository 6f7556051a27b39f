"""Tensor ops of the port: masked primitives, delegation, the three kernel
ops (each with its plain version), the device NMS and the host C++ NMS."""

from .delegation import delegate, delegation_weights, saliency_correlation
from .fused_conv import (conv3_ln_act, conv3_ln_act_torch, qkv_depthwise_ln,
                         qkv_depthwise_ln_torch)
from .local_attention import band_attention, band_attention_torch
from .masked import (channel_layer_norm, interpolate_linear_1d,
                     interpolate_nearest_1d, masked_avg_pool1d,
                     masked_max_pool1d, max_pool1d, sinusoid_encoding)
from .nms import (batched_nms_device, batched_nms_host, hard_nms_topk,
                  nms_host, segment_voting_host, segment_voting_xy,
                  soft_nms_topk, softnms_host)

KERNEL_OPS = (conv3_ln_act, band_attention, qkv_depthwise_ln)


def reset_launch_counts():
    for op in KERNEL_OPS:
        op.launches = 0


def launch_counts():
    return {op.__name__: op.launches for op in KERNEL_OPS}
