"""Text backbones (port of decafnet_tpu/models/text_net.py: TextTransformer,
TextIdentity)."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.blocks import AttNPool1D, MaskedConv1D, TransformerEncoder
from ..ops.masked import interpolate_linear_1d, sinusoid_encoding
from ..ops.params import cast


def add_pe(x, mask, max_seq_len, training=False):
    """Scaled sinusoid PE, linearly interpolated past ``max_seq_len`` at
    eval; in training a longer input raises (JAX asserts)."""
    c, t = x.shape[-2], x.shape[-1]
    pe = torch.from_numpy(sinusoid_encoding(max_seq_len, c // 2)).to(x.device)
    pe = pe / (c ** 0.5)
    if training and t > max_seq_len:
        raise ValueError(f"training text of {t} tokens is longer than the "
                         f"PE table ({max_seq_len})")
    if t > max_seq_len:
        pe = interpolate_linear_1d(pe, t, align_corners=True)
    return x + pe[..., :t].to(x.dtype) * mask.to(x.dtype)


class TextTransformer(nn.Module):
    """Embedding projection -> (optional PE) -> optional learnable background
    token prepended -> global-attention encoders."""

    def __init__(self, in_dim, embd_dim, n_heads, max_seq_len, n_layers=5,
                 use_abs_pe=True, use_bkgd_token=True, attn_pdrop=0.0,
                 proj_pdrop=0.0, path_pdrop=0.0):
        super().__init__()
        self.max_seq_len, self.use_abs_pe = max_seq_len, use_abs_pe
        self.out_dim = embd_dim
        self.embd_fc = MaskedConv1D(in_dim, embd_dim, 1)
        if use_bkgd_token:
            self.bkgd_token = nn.Parameter(torch.zeros(embd_dim, 1))
        else:
            self.bkgd_token = None
        self.transformer = nn.ModuleList(
            TransformerEncoder(embd_dim, stride=0, n_heads=n_heads,
                               attn_pdrop=attn_pdrop, proj_pdrop=proj_pdrop,
                               path_pdrop=path_pdrop)
            for _ in range(n_layers))

    def reset_parameters(self, generator):
        """bkgd_token ~ 0.02 * N(0, 1) truncated at +-2."""
        if self.bkgd_token is not None:
            z = torch.randn(self.bkgd_token.shape, generator=generator)
            with torch.no_grad():
                self.bkgd_token.copy_(0.02 * torch.clamp(z, -2.0, 2.0))

    def forward(self, x, mask, generator=None):
        if mask.ndim == 2:
            mask = mask[:, None, :]
        x, _ = self.embd_fc(x, mask)
        if self.use_abs_pe:
            x = add_pe(x, mask, self.max_seq_len, self.training)
        if self.bkgd_token is not None:
            bkgd = cast(self.bkgd_token, x.dtype)[None].expand(x.shape[0], -1, -1)
            x = torch.cat([bkgd, x], dim=-1)
            mask = torch.cat([mask[..., :1], mask], dim=-1)
        for layer in self.transformer:
            x, _ = layer(x, mask, generator=generator)
        return x, mask


class TextIdentity(nn.Module):
    """Pass-through text encoder: an optional 1x1 projection (when
    ``embd_dim`` is set; else the text keeps ``in_dim`` channels), optional
    PE, and attention pooling that prepends a pooled token when
    ``use_bkgd_token``."""

    def __init__(self, in_dim, embd_dim=None, max_seq_len=24, n_heads=4,
                 use_abs_pe=False, use_bkgd_token=True):
        super().__init__()
        self.max_seq_len, self.use_abs_pe = max_seq_len, use_abs_pe
        self.out_dim = embd_dim or in_dim
        self.embd_fc = (MaskedConv1D(in_dim, embd_dim, 1)
                        if embd_dim is not None else None)
        self.attn_pool = (AttNPool1D(self.out_dim, n_heads=n_heads)
                          if use_bkgd_token else None)

    def forward(self, x, mask, generator=None):
        if mask.ndim == 2:
            mask = mask[:, None, :]
        if self.embd_fc is not None:
            x, _ = self.embd_fc(x, mask)
        if self.use_abs_pe:
            x = add_pe(x, mask, self.max_seq_len, self.training)
        if self.attn_pool is not None:
            x, mask = self.attn_pool(x, mask, generator=generator)
        return x, mask


def make_text_net(tn):
    """The text net a ``model.text_net`` config names, with the JAX
    registry's defaults for the keys it leaves out."""
    drops = {k: tn.get(k, 0.0) for k in ("attn_pdrop", "proj_pdrop", "path_pdrop")}
    if tn["name"] == "transformer":
        return TextTransformer(
            tn["in_dim"], tn["embd_dim"], tn["n_heads"], tn["max_seq_len"],
            n_layers=tn.get("n_layers", 5), use_abs_pe=tn.get("use_abs_pe", True),
            use_bkgd_token=tn.get("use_bkgd_token", True), **drops)
    if tn["name"] == "identity":
        return TextIdentity(
            tn["in_dim"], tn.get("embd_dim"), tn.get("max_seq_len", 24),
            tn.get("n_heads", 4), use_abs_pe=tn.get("use_abs_pe", False),
            use_bkgd_token=tn.get("use_bkgd_token", True))
    raise ValueError(f"unknown text net: {tn['name']!r}")
