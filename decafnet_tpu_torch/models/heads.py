"""Classification / regression heads shared across FPN levels (port of
decafnet_tpu/models/heads.py: ClsHead, RegHead). Every trunk layer is one
fused masked conv3 + LN + ReLU over all levels at once
(ops/fused_conv.py:conv3_ln_act_levels: one kernel launch per layer)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..nn.blocks import Conv1d, LayerNorm, MaskedConv1D, Scale
from ..ops.fused_conv import conv3_ln_act_levels


class _MaskedPriorConv(nn.Module):
    """conv(k3) -> 1 logit, bias -log((1-p)/p) for a prior p > 0."""

    def __init__(self, in_channels, prior_prob=0.0):
        super().__init__()
        fill = -math.log((1 - prior_prob) / prior_prob) if prior_prob > 0 else 0.0
        self.conv = Conv1d(in_channels, 1, 3, 1, 1, bias_fill=fill)

    def forward(self, x, mask):
        return self.conv(x * mask.to(x.dtype)), mask


def _trunk(fpn, fpn_masks, convs, norms):
    """The trunk layers, each over every level (the JAX heads loop over
    levels with the same weights, decafnet_tpu/models/heads.py:64-75)."""
    masks = [m[:, 0, :] for m in fpn_masks]
    for conv, norm in zip(convs, norms):
        fpn = conv3_ln_act_levels(fpn, masks, conv.conv.weight, conv.conv.bias,
                                  norm.weight, norm.bias, act="relu")
    return fpn


class ClsHead(nn.Module):
    """n_layers of masked conv(k3)+LN+ReLU then a 1-logit conv, shared over
    FPN levels."""

    def __init__(self, embd_dim, n_layers=2, prior_prob=0.0):
        super().__init__()
        self.convs = nn.ModuleList(
            MaskedConv1D(embd_dim, embd_dim, 3, 1, 1, bias=False)
            for _ in range(n_layers))
        self.norms = nn.ModuleList(LayerNorm(embd_dim) for _ in range(n_layers))
        self.cls_head = _MaskedPriorConv(embd_dim, prior_prob)

    def forward(self, fpn, fpn_masks):
        out_logits, out_masks = [], []
        feats = _trunk(fpn, fpn_masks, self.convs, self.norms)
        for x, mask in zip(feats, fpn_masks):
            logits, _ = self.cls_head(x, mask)
            out_logits.append(logits[:, 0, :])
            out_masks.append(mask[:, 0, :])
        return out_logits, out_masks


class RegHead(nn.Module):
    """Same trunk emitting 2 offsets through a per-level Scale then a ReLU;
    offsets are channel-first (bs, 2, p)."""

    def __init__(self, embd_dim, num_fpn_levels, n_layers=2):
        super().__init__()
        self.convs = nn.ModuleList(
            MaskedConv1D(embd_dim, embd_dim, 3, 1, 1, bias=False)
            for _ in range(n_layers))
        self.norms = nn.ModuleList(LayerNorm(embd_dim) for _ in range(n_layers))
        self.reg_head = MaskedConv1D(embd_dim, 2, 3, 1, 1)
        self.scales = nn.ModuleList(Scale() for _ in range(num_fpn_levels))

    def forward(self, fpn, fpn_masks):
        out_offsets, out_masks = [], []
        feats = _trunk(fpn, fpn_masks, self.convs, self.norms)
        for i, (x, mask) in enumerate(zip(feats, fpn_masks)):
            offsets, _ = self.reg_head(x, mask)
            out_offsets.append(torch.relu(self.scales[i](offsets)))
            out_masks.append(mask[:, 0, :])
        return out_offsets, out_masks
