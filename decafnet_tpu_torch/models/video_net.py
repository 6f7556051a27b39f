"""Video FPN backbone (port of decafnet_tpu/models/video_net.py:
VideoTransformer)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..nn.blocks import LayerNorm, MaskedConv1D, TransformerEncoder
from ..ops.fused_conv import conv3_ln_act
from ..ops.masked import interpolate_linear_1d, sinusoid_encoding


class VideoTransformer(nn.Module):
    """conv embedding -> scaled sinusoid PE -> stem encoders -> branch
    encoders emitting the feature pyramid (stride 2 after the first
    branch)."""

    def __init__(self, in_dim, embd_dim, max_seq_len, n_heads, mha_win_size,
                 stride=1, arch=(2, 1, 6), use_abs_pe=False, attn_pdrop=0.0,
                 proj_pdrop=0.0, path_pdrop=0.0):
        super().__init__()
        assert len(arch) == 3
        assert stride & (stride - 1) == 0
        assert arch[0] >= int(math.log2(max(stride, 1)))
        self.max_seq_len, self.use_abs_pe = max_seq_len, use_abs_pe
        self.embd_fc = MaskedConv1D(in_dim, embd_dim, 1)
        convs, norms = [], []
        for _ in range(arch[0]):
            convs.append(MaskedConv1D(
                embd_dim, embd_dim, kernel_size=5 if stride > 1 else 3,
                stride=2 if stride > 1 else 1, padding=2 if stride > 1 else 1,
                bias=False))
            norms.append(LayerNorm(embd_dim))
            stride = max(stride // 2, 1)
        self.embd_convs = nn.ModuleList(convs)
        self.embd_norms = nn.ModuleList(norms)
        drops = dict(attn_pdrop=attn_pdrop, proj_pdrop=proj_pdrop,
                     path_pdrop=path_pdrop)
        self.stem = nn.ModuleList(
            TransformerEncoder(embd_dim, stride=1, n_heads=n_heads,
                               window_size=mha_win_size, **drops)
            for _ in range(arch[1]))
        self.branch = nn.ModuleList(
            TransformerEncoder(embd_dim, stride=2 if idx > 0 else 1,
                               n_heads=n_heads, window_size=mha_win_size,
                               **drops)
            for idx in range(arch[2]))
        pe = torch.from_numpy(sinusoid_encoding(max_seq_len, embd_dim // 2))
        self.register_buffer("pe", pe / (embd_dim ** 0.5), persistent=False)

    def forward(self, x, mask, pe_interp=None, generator=None):
        """``pe_interp``: optional (lo, hi, w) tensors of shape (t,) or
        (B, t): linear-interpolation plans of the PE table onto the
        reference's padded length (data/batching.py:pe_interp_arrays).
        In training an input longer than the PE table raises."""
        if mask.ndim == 2:
            mask = mask[:, None, :]
        x, _ = self.embd_fc(x, mask)
        for conv, norm in zip(self.embd_convs, self.embd_norms):
            if conv.conv.kernel_size == 3 and conv.stride == 1:
                x = conv3_ln_act(x, mask[:, 0, :], conv.conv.weight,
                                 conv.conv.bias, norm.weight, norm.bias,
                                 act="relu")
            else:
                x, mask = conv(x, mask)
                x = torch.relu(norm(x))

        if self.use_abs_pe:
            t = x.shape[-1]
            pe = self.pe
            if pe_interp is not None:
                lo, hi, w = pe_interp
                if lo.ndim == 2:      # per-row plans -> (B, C, t)
                    pe = (pe[:, lo].permute(1, 0, 2) * (1.0 - w[:, None, :])
                          + pe[:, hi].permute(1, 0, 2) * w[:, None, :])
                else:
                    pe = pe[:, lo] * (1.0 - w[None, :]) + pe[:, hi] * w[None, :]
            elif self.training and t > self.max_seq_len:
                raise ValueError(f"training video of {t} steps is longer than "
                                 f"the PE table ({self.max_seq_len})")
            elif t > self.max_seq_len:
                pe = interpolate_linear_1d(pe, t, align_corners=True)
            x = x + pe[..., :t].to(x.dtype) * mask.to(x.dtype)

        for block in self.stem:
            x, mask = block(x, mask, generator=generator)
        fpn, fpn_masks = [], []
        for block in self.branch:
            x, mask = block(x, mask, generator=generator)
            fpn.append(x)
            fpn_masks.append(mask)
        return fpn, fpn_masks
