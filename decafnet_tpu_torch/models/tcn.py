"""Dilated TCN for multi-scale temporal refinement (port of
decafnet_tpu/models/tcn.py)."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.blocks import Conv1d, TorchLayerNorm, dropout


class DilatedResidualLayer(nn.Module):
    """dilated conv(k3) -> ReLU -> 1x1 conv -> dropout (training) -> masked
    residual -> LayerNorm over channels."""

    def __init__(self, dilation, nchannels, pdrop=0.5):
        super().__init__()
        self.pdrop = pdrop
        self.conv_dilated = Conv1d(nchannels, nchannels, 3, padding=dilation,
                                   dilation=dilation, uniform_bias=True)
        self.conv_1x1 = Conv1d(nchannels, nchannels, 1, uniform_bias=True)
        self.norm = TorchLayerNorm(nchannels)

    def forward(self, x, mask, generator=None):
        out = self.conv_1x1(torch.relu(self.conv_dilated(x)))
        out = dropout(out, self.pdrop, generator, self.training)
        return self.norm((x + out) * mask[:, 0:1, :].to(x.dtype))


class TCN(nn.Module):
    """1x1 in-map -> dilated residual layers (dilation 2^i) -> 1x1 out-map,
    output gated by the mask (the refiner's configuration: in-map on,
    LayerNorm on, one group); dropout at ``pdrop`` in each layer."""

    def __init__(self, in_dim, hid_dim, out_dim, num_layers, pdrop=0.5):
        super().__init__()
        self.conv_1x1 = Conv1d(in_dim, hid_dim, 1, uniform_bias=True)
        self.layers = nn.ModuleList(
            DilatedResidualLayer(2 ** i, hid_dim, pdrop)
            for i in range(num_layers))
        self.conv_out = Conv1d(hid_dim, out_dim, 1, uniform_bias=True)

    def forward(self, x, mask, generator=None):
        out = self.conv_1x1(x)
        for layer in self.layers:
            out = layer(out, mask, generator=generator)
        return self.conv_out(out) * mask[:, 0:1, :].to(out.dtype)
