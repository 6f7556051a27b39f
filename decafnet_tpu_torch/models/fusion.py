"""Query-video cross-attention fusion (port of
decafnet_tpu/models/fusion.py: XAttNFusion)."""

from __future__ import annotations

import torch.nn as nn

from ..nn.blocks import LayerNorm, TransformerDecoder


class XAttNFusion(nn.Module):
    """Stack of cross-attention decoders + output LayerNorm. Takes one
    (vid, mask) pair, or lists of FPN levels: then the same layers fuse
    each level with the text and lists come back."""

    def __init__(self, vid_dim, text_dim, n_layers=2, n_heads=4,
                 xattn_mode="adaln", attn_pdrop=0.0, proj_pdrop=0.0,
                 path_pdrop=0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerDecoder(vid_dim, text_dim, n_heads=n_heads,
                               xattn_mode=xattn_mode, attn_pdrop=attn_pdrop,
                               proj_pdrop=proj_pdrop, path_pdrop=path_pdrop)
            for _ in range(n_layers))
        self.ln_out = LayerNorm(vid_dim)

    def forward(self, vid, vid_masks, text, text_mask, generator=None):
        if isinstance(vid, (list, tuple)):
            pairs = [self(x, m, text, text_mask, generator=generator)
                     for x, m in zip(vid, vid_masks, strict=True)]
            return [x for x, _ in pairs], [m for _, m in pairs]
        for layer in self.layers:
            vid, vid_masks = layer(vid, vid_masks, text, text_mask,
                                   generator=generator)
        return self.ln_out(vid), vid_masks
