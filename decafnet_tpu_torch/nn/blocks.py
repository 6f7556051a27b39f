"""Primitive NN blocks, channel-first (bs, c, t) (port of
decafnet_tpu/nn/blocks.py).

Module and parameter names follow the reference's torch module tree and
conv kernels keep the (out, in, k) layout, so a flax params tree of the JAX
package and a released ``.pth`` load through one key mapping
(models/import_torch.py). Parameters are created empty and filled by a
loaded state dict or by :func:`reset_parameters` from a ``torch.Generator``.

Dropout and stochastic depth act in training mode (``module.train()``) only,
and draw their masks from the ``torch.Generator`` passed down each forward
as ``generator`` (never from the global RNG), as the JAX modules draw from
the ``dropout`` rng stream; in eval mode, or at rate 0, they are the
identity.

Compute dtype: the activations' dtype is the compute dtype (f32, or bf16
under ``tpu.compute_dtype: bfloat16``); parameters stay f32 and are cast to
it at each use (:func:`ops.params.cast`, a copy cached per weight), as the
JAX modules cast theirs (``param.astype(x.dtype)``); LayerNorm statistics
and attention scores and softmax stay f32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_conv import qkv_depthwise_ln
from ..ops.local_attention import band_attention
from ..ops.masked import (channel_layer_norm, interpolate_nearest_1d,
                          masked_avg_pool1d, masked_max_pool1d)
from ..ops.params import cast
from ..parallel import seq


def _uniform_(t, bound, generator):
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=generator) * (2 * bound) - bound)


def _uniform_like(x, shape, generator, time_axis=None):
    """A uniform draw of ``shape``. Time-sharded (:func:`parallel.seq.active`)
    with a ``time_axis``, the draw is of the global shape and this rank's
    block is kept, so every rank draws what one process draws."""
    if generator is None:
        raise ValueError("dropout in training mode draws from a "
                         "torch.Generator: pass generator=")
    shard = seq.active() if time_axis is not None else None
    if shard is None:
        return torch.rand(shape, generator=generator, device=x.device,
                          dtype=x.dtype)
    shape = list(shape)
    shape[time_axis] *= shard.size
    u = torch.rand(shape, generator=generator, device=x.device, dtype=x.dtype)
    return shard.shard(u, time_axis)


def dropout(x, p, generator, training, shape=None, time_axis=-1):
    """Inverted dropout as flax's ``nn.Dropout``: in training each entry of
    a uniform draw of ``shape`` (default ``x.shape``; a shape with 1s
    broadcasts the mask, as ``broadcast_dims`` does) keeps ``x`` scaled by
    1 / (1 - p) where it is below 1 - p, and zeroes it elsewhere.
    ``time_axis`` is the draw's video-time axis (None: it has none), where a
    time-sharded run draws globally (:func:`_uniform_like`)."""
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    kept = _uniform_like(x, shape or x.shape, generator, time_axis) < keep
    return torch.where(kept, x / keep, torch.zeros_like(x))


def drop_path(x, p, generator, training):
    """Stochastic depth as the JAX ``LayerScale`` (nn/blocks.py:242-247): in
    training one gate per sample, ``floor(keep + U)`` with keep = 1 - p, and
    ``x / keep * gate``."""
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    u = _uniform_like(x, (x.shape[0],) + (1,) * (x.ndim - 1), generator)
    return x / keep * torch.floor(keep + u)


class Conv1d(nn.Module):
    """1D convolution with an (out, in/groups, k) weight. Random init as the
    JAX package's: U(+-1/sqrt(fan_in)) weight; bias zero, ``bias_fill``, or
    U(+-1/sqrt(fan_in)) when ``uniform_bias``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, groups=1, dilation=1, bias=True,
                 uniform_bias=False, bias_fill=0.0):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.groups, self.dilation = groups, dilation
        self.uniform_bias, self.bias_fill = uniform_bias, bias_fill
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator):
        bound = 1.0 / math.sqrt(self.weight.shape[1] * self.kernel_size)
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            if self.uniform_bias:
                _uniform_(self.bias, bound, generator)
            else:
                nn.init.constant_(self.bias, self.bias_fill)

    def forward(self, x):
        # time-sharded, a conv wider than one tap reads the neighbours'
        # columns (zeros past the video's ends: the conv's padding) and
        # keeps the outputs of this rank's block (blocks start on columns
        # that are multiples of the stride)
        pad, shard = self.padding, seq.active()
        halo = shard is not None and self.kernel_size > 1
        if halo:
            t = x.shape[-1]
            reach = self.dilation * (self.kernel_size - 1)
            x, = shard.halo(x, left=pad,
                            right=max(0, reach - pad - self.stride + 1))
            pad = 0
        # the bias is added to the conv's output in its dtype, as the JAX
        # Conv1d adds it (in bf16 the conv output is rounded first)
        y = F.conv1d(x, cast(self.weight, x.dtype), None, self.stride,
                     pad, self.dilation, self.groups)
        if halo and y.shape[-1] != t // self.stride:
            y = y[..., :t // self.stride]
        if self.bias is None:
            return y
        return y + cast(self.bias, y.dtype)[:, None]


class MaskedConv1D(nn.Module):
    """Convolution over zero-filled masked inputs; the mask is nearest-
    downsampled when stride > 1."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, groups=1, bias=True):
        super().__init__()
        self.stride = stride
        self.conv = Conv1d(in_channels, out_channels, kernel_size,
                           stride=stride, padding=padding, groups=groups,
                           bias=bias)

    def forward(self, x, mask):
        x = self.conv(x * mask.to(x.dtype))
        if self.stride > 1:
            mask = interpolate_nearest_1d(mask.float(), x.shape[-1]).bool()
        return x, mask


class LayerNorm(nn.Module):
    """Channel-first LayerNorm over (bs, c, t); affine params are (c, 1),
    cast to x's dtype and applied in f32 (JAX nn/blocks.py:198-214)."""

    def __init__(self, n_channels, affine=True, eps=1e-5):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(n_channels, 1))
            self.bias = nn.Parameter(torch.zeros(n_channels, 1))
        else:
            self.weight = self.bias = None

    def reset_parameters(self, generator):
        if self.weight is not None:
            nn.init.ones_(self.weight)
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return channel_layer_norm(x, cast(self.weight, x.dtype),
                                  cast(self.bias, x.dtype), self.eps)


class TorchLayerNorm(nn.Module):
    """torch.nn.LayerNorm over the channel axis of (bs, c, t) tensors, as the
    TCN refiner uses it; weights are (c,)."""

    def __init__(self, n_channels, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n_channels))
        self.bias = nn.Parameter(torch.zeros(n_channels))

    def reset_parameters(self, generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return channel_layer_norm(x, cast(self.weight, x.dtype),
                                  cast(self.bias, x.dtype), self.eps)


class Scale(nn.Module):
    """Learnable scalar multiplier (shape ())."""

    def __init__(self, init=1.0):
        super().__init__()
        self.init = init
        self.scale = nn.Parameter(torch.tensor(float(init)))

    def reset_parameters(self, generator):
        nn.init.constant_(self.scale, self.init)

    def forward(self, x):
        return x * cast(self.scale, x.dtype)


class LayerScale(nn.Module):
    """Per-channel residual scaling (1, c, 1), init 1e-4, then stochastic
    depth at rate ``pdrop`` in training."""

    def __init__(self, n_channels, pdrop=0.0, init_scale=1e-4):
        super().__init__()
        self.pdrop, self.init_scale = pdrop, init_scale
        self.scale = nn.Parameter(torch.full((1, n_channels, 1), init_scale))

    def reset_parameters(self, generator):
        nn.init.constant_(self.scale, self.init_scale)

    def forward(self, x, generator=None):
        return drop_path(cast(self.scale, x.dtype) * x, self.pdrop, generator,
                         self.training)


class MaskedMHA(nn.Module):
    """Multi-head attention with masking; global, or banded local when
    ``window_size`` > 0. q and k are both scaled by 1/sqrt(sqrt(d)); the
    global softmax gives zeros, not NaN, for fully masked rows. The global
    scores accumulate in f32 and the softmax runs in f32; the weights are
    rounded to v's dtype for the second product, which accumulates in f32
    (JAX nn/blocks.py:314-329). In training,
    dropout at ``attn_pdrop`` on the global attention weights (the banded
    path has none, as in the JAX module) and at ``proj_pdrop`` on the
    output projection.

    ``gather_keys``: the keys lie on the queries' time axis (a video's
    self-attention). Time-sharded (:func:`parallel.seq.active`), the global
    attention then gathers the projected keys, values and key mask of every
    rank (one differentiable ``TimeShard.gather``) and keeps the rank's
    queries; the banded one exchanges halos instead (``band_attention``).
    Off (a cross-attention to the replicated text), nothing is gathered."""

    def __init__(self, embd_dim, q_dim=None, kv_dim=None, out_dim=None,
                 n_heads=4, window_size=0, attn_pdrop=0.0, proj_pdrop=0.0,
                 gather_keys=False):
        super().__init__()
        assert embd_dim % n_heads == 0
        q_dim = q_dim or embd_dim
        kv_dim = kv_dim or embd_dim
        out_dim = out_dim or q_dim
        self.embd_dim, self.n_heads, self.window_size = embd_dim, n_heads, window_size
        self.attn_pdrop, self.proj_pdrop = attn_pdrop, proj_pdrop
        self.gather_keys = gather_keys
        self.query = Conv1d(q_dim, embd_dim, 1)
        self.key = Conv1d(kv_dim, embd_dim, 1)
        self.value = Conv1d(kv_dim, embd_dim, 1)
        self.proj = Conv1d(embd_dim, out_dim, 1)

    def forward(self, q, k=None, v=None, kv_mask=None, generator=None):
        if k is None:
            k = q
        if v is None:
            v = k
        if kv_mask is None:
            kv_mask = torch.ones_like(k[:, :1], dtype=torch.bool)
        bs, h = q.shape[0], self.n_heads
        d = self.embd_dim // h
        scale = float(1.0 / np.sqrt(np.sqrt(d)))

        def to_heads(x):  # (bs, c, t) -> (bs, h, t, d), a strided view
            return x.reshape(bs, h, d, x.shape[-1]).transpose(2, 3)

        kp, vp = self.key(k), self.value(v)
        shard = seq.active()
        if shard is not None and self.gather_keys and self.window_size <= 0:
            # every rank's keys, after the projections: no rank projects
            # another's
            kp, vp, kv_mask = shard.gather(kp, vp, kv_mask)
        qh = to_heads(self.query(q)) * scale
        kh = to_heads(kp) * scale
        vh = to_heads(vp)
        mask2d = kv_mask[:, 0, :]

        if self.window_size > 0:
            out = band_attention(qh, kh, vh, mask2d, self.window_size)
        else:
            acc = torch.promote_types(q.dtype, torch.float32)
            scores = torch.einsum("bhid,bhjd->bhij", qh.to(acc), kh.to(acc))
            kv_valid = mask2d[:, None, None, :]
            scores = scores.masked_fill(~kv_valid, -float("inf"))
            smax = torch.amax(scores, dim=-1, keepdim=True)
            smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
            attn = torch.exp(scores - smax)
            attn = torch.where(kv_valid, attn, torch.zeros_like(attn))
            denom = torch.sum(attn, dim=-1, keepdim=True)
            attn = attn / torch.clamp_min(denom, torch.finfo(attn.dtype).tiny)
            attn = dropout(attn, self.attn_pdrop, generator, self.training,
                           time_axis=-2)
            out = torch.einsum("bhij,bhjd->bhid", attn.to(vh.dtype).to(acc),
                               vh.to(acc)).to(q.dtype)

        out = out.transpose(2, 3).reshape(bs, h * d, -1)
        return dropout(self.proj(out), self.proj_pdrop, generator,
                       self.training)


class AttNPool1D(nn.Module):
    """Attention pooling: the masked mean token is prepended to the
    sequence, one global attention over it pools the pooled token, and that
    token is prepended to ``x`` (the mask extended by its first column)."""

    def __init__(self, embd_dim, n_heads=4):
        super().__init__()
        self.attn = MaskedMHA(embd_dim, n_heads=n_heads)

    def forward(self, x, mask, generator=None):
        h = torch.cat([masked_avg_pool1d(x, mask), x], dim=-1)
        mask = torch.cat([mask[..., :1], mask], dim=-1)
        pool = self.attn(h, kv_mask=mask, generator=generator)[..., :1]
        return torch.cat([pool, x], dim=-1), mask


class ConvAttNLayer(nn.Module):
    """Optional depthwise convs (with per-branch LN) feeding self-attention.
    stride 0 disables the convs; stride 1 runs the fused q/k/v trio; stride 2
    downsamples queries and the mask through plain depthwise convs."""

    def __init__(self, embd_dim, out_dim=None, stride=1, n_heads=4,
                 window_size=0, attn_pdrop=0.0, proj_pdrop=0.0):
        super().__init__()
        self.stride = stride
        if stride > 0:
            assert stride == 1 or stride % 2 == 0

            def mk():
                return MaskedConv1D(embd_dim, embd_dim, 3, stride, 1,
                                    groups=embd_dim, bias=False)
            self.q_conv, self.k_conv, self.v_conv = mk(), mk(), mk()
            self.q_norm = LayerNorm(embd_dim)
            self.k_norm = LayerNorm(embd_dim)
            self.v_norm = LayerNorm(embd_dim)
        # self-attention: its keys are its own time axis
        self.attn = MaskedMHA(embd_dim, out_dim=out_dim or embd_dim,
                              n_heads=n_heads, window_size=window_size,
                              attn_pdrop=attn_pdrop, proj_pdrop=proj_pdrop,
                              gather_keys=True)

    def forward(self, x, mask, generator=None):
        if self.stride == 1:
            q, k, v = qkv_depthwise_ln(
                x, mask[:, 0, :],
                (self.q_conv.conv.weight, self.k_conv.conv.weight,
                 self.v_conv.conv.weight),
                (self.q_norm.weight, self.k_norm.weight, self.v_norm.weight),
                (self.q_norm.bias, self.k_norm.bias, self.v_norm.bias))
        elif self.stride > 1:
            k, _ = self.k_conv(x, mask)
            v, _ = self.v_conv(x, mask)
            q, mask = self.q_conv(x, mask)
            q, k, v = self.q_norm(q), self.k_norm(k), self.v_norm(v)
        else:
            q = k = v = x
        return self.attn(q, k, v, mask, generator=generator), mask


class ConvXAttNLayer(nn.Module):
    """Optional depthwise query conv feeding cross-attention."""

    def __init__(self, embd_dim, kv_dim, out_dim=None, stride=1, n_heads=4,
                 attn_pdrop=0.0, proj_pdrop=0.0):
        super().__init__()
        self.use_conv = stride > 0
        if self.use_conv:
            assert stride == 1 or stride % 2 == 0
            self.q_conv = MaskedConv1D(embd_dim, embd_dim, 3, stride, 1,
                                       groups=embd_dim, bias=False)
            self.q_norm = LayerNorm(embd_dim)
        self.xattn = MaskedMHA(embd_dim, kv_dim=kv_dim,
                               out_dim=out_dim or embd_dim, n_heads=n_heads,
                               attn_pdrop=attn_pdrop, proj_pdrop=proj_pdrop)

    def forward(self, q, q_mask, kv, kv_mask, generator=None):
        if self.use_conv:
            q, q_mask = self.q_conv(q, q_mask)
            q = self.q_norm(q)
        return self.xattn(q, kv, None, kv_mask, generator=generator), q_mask


class FFN(nn.Module):
    """Conv1x1 -> exact GELU -> Conv1x1, in training with dropout at
    ``pdrop`` after the GELU and after the projection."""

    def __init__(self, channels, expansion=4, pdrop=0.0):
        super().__init__()
        self.pdrop = pdrop
        self.fc = Conv1d(channels, channels * expansion, 1)
        self.proj = Conv1d(channels * expansion, channels, 1)

    def forward(self, x, generator=None):
        x = dropout(F.gelu(self.fc(x)), self.pdrop, generator, self.training)
        return dropout(self.proj(x), self.pdrop, generator, self.training)


class TransformerEncoder(nn.Module):
    """Pre-LN encoder: (optional depthwise conv ->) local or global
    self-attention -> FFN, LayerScale'd residuals, masked max-pool skip when
    downsampling."""

    def __init__(self, embd_dim, stride=1, n_heads=4, window_size=0,
                 expansion=4, attn_pdrop=0.0, proj_pdrop=0.0, path_pdrop=0.0):
        super().__init__()
        self.stride = stride
        self.attn = ConvAttNLayer(embd_dim, stride=stride, n_heads=n_heads,
                                  window_size=window_size,
                                  attn_pdrop=attn_pdrop, proj_pdrop=proj_pdrop)
        self.ln_attn = LayerNorm(embd_dim)
        self.drop_path_attn = LayerScale(embd_dim, path_pdrop)
        self.ffn = FFN(embd_dim, expansion, proj_pdrop)
        self.ln_ffn = LayerNorm(embd_dim)
        self.drop_path_ffn = LayerScale(embd_dim, path_pdrop)

    def forward(self, x, mask, generator=None):
        x = x * mask.to(x.dtype)
        if self.stride > 1:
            skip = masked_max_pool1d(x, mask, 3, self.stride)[0]
        else:
            skip = x
        h, mask = self.attn(self.ln_attn(x), mask, generator=generator)
        x = skip * mask.to(x.dtype) + self.drop_path_attn(h, generator)
        h = self.ffn(self.ln_ffn(x), generator) * mask.to(x.dtype)
        return x + self.drop_path_ffn(h, generator), mask


class TransformerDecoder(nn.Module):
    """Cross-attention decoder without self-attention; in 'adaln' mode the
    cross-attention emits 2x channels that modulate a parameter-free LN of
    the query as (scale, shift)."""

    def __init__(self, embd_dim, kv_dim, n_heads=4, expansion=4,
                 xattn_mode="adaln", attn_pdrop=0.0, proj_pdrop=0.0,
                 path_pdrop=0.0):
        super().__init__()
        assert xattn_mode in ("affine", "adaln")
        self.xattn_mode = xattn_mode
        self.xattn = ConvXAttNLayer(embd_dim, kv_dim, embd_dim * 2, stride=1,
                                    n_heads=n_heads, attn_pdrop=attn_pdrop,
                                    proj_pdrop=proj_pdrop)
        self.ln_xattn_q = LayerNorm(embd_dim)
        self.ln_xattn_kv = LayerNorm(kv_dim)
        if xattn_mode == "adaln":
            self.adaln = LayerNorm(embd_dim, affine=False)
        self.ffn = FFN(embd_dim, expansion, proj_pdrop)
        self.ln_ffn = LayerNorm(embd_dim)
        self.drop_path_ffn = LayerScale(embd_dim, path_pdrop)

    def forward(self, q, q_mask, kv, kv_mask, generator=None):
        q = q * q_mask.to(q.dtype)
        h, q_mask = self.xattn(self.ln_xattn_q(q), q_mask,
                               self.ln_xattn_kv(kv), kv_mask,
                               generator=generator)
        q = q * q_mask.to(q.dtype)
        if self.xattn_mode == "adaln":
            q = self.adaln(q)
        scale, shift = torch.chunk(h, 2, dim=1)
        q = q * scale + shift
        h = self.ffn(self.ln_ffn(q), generator) * q_mask.to(q.dtype)
        return q + self.drop_path_ffn(h, generator), q_mask


def reset_parameters(module, generator):
    """Fill every parameter of ``module`` from ``generator`` with the JAX
    package's initializers (each block's own ``reset_parameters``)."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    return module
