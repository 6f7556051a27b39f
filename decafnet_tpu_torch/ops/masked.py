"""Masked 1D primitives, channel-first ``(..., c, t)``, as plain torch
functions (port of decafnet_tpu/ops/masked.py).

Masks are boolean ``(..., 1, t)`` or ``(..., t)`` with True = valid.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..parallel import seq


def masked_avg_pool1d(x, mask):
    """Global masked average over time: (..., c, t) -> (..., c, 1); an
    all-masked row gives 0."""
    mask = mask.to(x.dtype)
    x_sum = torch.sum(x * mask, dim=-1, keepdim=True)
    n = torch.sum(mask, dim=-1, keepdim=True)
    return x_sum / torch.clamp_min(n, 1.0)


def max_pool1d(x, kernel_size=3, stride=2, padding=None):
    """Max pooling over the last axis of a (B, C, T) tensor, -inf padded."""
    if padding is None:
        padding = (kernel_size - 1) // 2
    return F.max_pool1d(x, kernel_size, stride, padding)


def masked_max_pool1d(x, mask, kernel_size=3, stride=2):
    """Masked strided max pooling: invalid positions take the per-row
    minimum before pooling and the pooled mask gates the output; the
    minimum is a constant to autograd, as the JAX ``stop_gradient`` makes
    it. Returns (pooled_x, pooled_mask_bool).

    Time-sharded (:func:`parallel.seq.active`), the minimum is the row's
    over every rank, and the pools read the columns before this rank's
    block (-inf past the video's start, the pool's own padding)."""
    shard = seq.active()
    x_min = torch.amin(x.detach(), dim=-1, keepdim=True)
    if shard is not None:
        x_min = shard.all_reduce(x_min, dist.ReduceOp.MIN)
    mask_f = mask.to(x.dtype)
    x = x * mask_f + (1.0 - mask_f) * x_min
    if shard is None:
        x = max_pool1d(x, kernel_size, stride)
        mask_f = max_pool1d(mask_f, kernel_size, stride)
        return x * mask_f, mask_f.bool()
    t, pad = x.shape[-1], (kernel_size - 1) // 2
    x, mask_f = shard.halo(x, mask_f, left=pad,
                           right=max(0, kernel_size - pad - stride),
                           fill=-float("inf"))
    x = max_pool1d(x, kernel_size, stride, 0)[..., :t // stride]
    mask_f = max_pool1d(mask_f, kernel_size, stride, 0)[..., :t // stride]
    return x * mask_f, mask_f.bool()


def interpolate_nearest_1d(x, size):
    """F.interpolate(mode='nearest') over the last axis: source index
    floor(i * in_size / out_size) computed in f32. Integer downsamples and
    power-of-two upsamples, where that index math is exact, are a strided
    view and a repeat, with no index tensor to copy to the device."""
    in_size = x.shape[-1]
    if size == in_size:
        return x
    if in_size % size == 0:
        return x[..., ::in_size // size]
    r, rem = divmod(size, in_size)
    if rem == 0 and r & (r - 1) == 0:
        return torch.repeat_interleave(x, r, dim=-1)
    scale = np.float32(in_size) / np.float32(size)
    idx = np.floor(np.arange(size, dtype=np.float32) * scale).astype(np.int64)
    idx = np.clip(idx, 0, in_size - 1)
    return x[..., torch.from_numpy(idx).to(x.device)]


def interpolate_linear_1d(x, size, align_corners=True):
    """F.interpolate(mode='linear') over the last axis, positions in f64
    and only the lerp weight cast to f32."""
    in_size = x.shape[-1]
    if align_corners:
        if size == 1:
            pos = np.zeros((1,), np.float64)
        else:
            pos = np.arange(size, dtype=np.float64) * (in_size - 1) / (size - 1)
    else:
        scale = in_size / size
        pos = np.maximum((np.arange(size, dtype=np.float64) + 0.5) * scale - 0.5,
                         0.0)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    w = torch.from_numpy((pos - lo).astype(np.float32)).to(x.device, x.dtype)
    x_lo = x[..., torch.from_numpy(lo).to(x.device)]
    x_hi = x[..., torch.from_numpy(hi).to(x.device)]
    return x_lo * (1.0 - w) + x_hi * w


def sinusoid_encoding(seq_len, n_freqs, dtype=np.float32):
    """Sinusoid position encoding (2 * n_freqs, seq_len) as numpy: rows are
    all sines then all cosines, frequencies 10000 ** linspace(0, 1,
    n_freqs + 1)[:n_freqs]."""
    tics = np.arange(seq_len, dtype=np.float32)
    freqs = (10000.0 ** np.linspace(0, 1, n_freqs + 1,
                                    dtype=np.float32))[:n_freqs]
    x = tics[None, :] / freqs[:, None]
    pe = np.concatenate([np.sin(x), np.cos(x)], axis=0)
    return pe.astype(dtype)


def channel_layer_norm(x, weight=None, bias=None, eps=1e-5):
    """LayerNorm over the channel axis of (..., c, t): centred, divided by
    sqrt(biased variance + eps), statistics in f32 (in f64 for f64 input).
    ``weight``/``bias`` are (c, 1) or (c,)."""
    in_dtype = x.dtype
    stat = torch.promote_types(in_dtype, torch.float32)
    x = x.to(stat)
    x = x - torch.mean(x, dim=-2, keepdim=True)
    sigma = torch.mean(torch.square(x), dim=-2, keepdim=True)
    x = x * torch.rsqrt(sigma + eps)
    if weight is not None:
        w = weight.reshape(weight.shape[0], 1)
        b = bias.reshape(bias.shape[0], 1)
        x = x * w.to(stat) + b.to(stat)
    return x.to(in_dtype)
