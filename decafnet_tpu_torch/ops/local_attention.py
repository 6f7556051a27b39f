"""Banded (local-window) multi-head attention (port of
decafnet_tpu/ops/local_attention.py).

For query i and band offset r in [-w//2, w//2], key j = i + r takes part
when 0 <= j < T and kv_mask[j]; softmax over those keys, rows with an
invalid query (or no valid key) are zero. ``band_attention_torch`` is the
plain version (the per-diagonal form of the JAX ``band_attention_diag``);
``band_attention`` launches csrc/band_attention.cu for CUDA tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda


def _shift_time(x, r):
    """x_r[..., i, :] = x[..., i + r, :], zero outside [0, T) (time is
    axis -2)."""
    if r == 0:
        return x
    T = x.shape[-2]
    if r > 0:
        return F.pad(x, (0, 0, 0, r))[..., r:r + T, :]
    return F.pad(x, (0, 0, -r, 0))[..., :T, :]


def band_attention_torch(q, k, v, kv_mask, window_size):
    """Plain version. q, k, v (B, H, T, D) f32; kv_mask (B, T) bool (also the
    query mask); odd ``window_size``. Returns (B, H, T, D)."""
    assert window_size % 2 == 1 and window_size > 0
    halo = window_size // 2
    mask_f = kv_mask.float()[:, None, :, None]              # (B, 1, T, 1)
    neg = torch.tensor(-float("inf"), device=q.device)
    scores = []
    for r in range(-halo, halo + 1):
        s = torch.einsum("bhtd,bhtd->bht", q, _shift_time(k, r))
        m_r = _shift_time(mask_f, r)[..., 0]                # (B, 1, T)
        scores.append(torch.where(m_r > 0, s, neg))
    s = torch.stack(scores, dim=-1)                         # (B, H, T, w)

    smax = torch.amax(s, dim=-1, keepdim=True)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
    p = torch.exp(s - smax)
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    denom = torch.sum(p, dim=-1, keepdim=True)
    p = p / torch.clamp_min(denom, torch.finfo(p.dtype).tiny)

    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for i, r in enumerate(range(-halo, halo + 1)):
        out = out + p[..., i:i + 1] * _shift_time(v, r).float()
    return (out * mask_f).to(q.dtype)


# head widths csrc/band_attention.cu is instantiated for (embd 128 / 4 heads)
BAND_HEAD_DIMS = (32,)
BAND_MAX_TILE = 128


def band_attention_plan(B, H, T, sms):
    """Launch plan ``(tile, split)`` of csrc/band_attention.cu for (B, H, T)
    query views on a card of ``sms`` multiprocessors: each block owns
    ``tile`` time columns of one (b, h), and each query's D is split over
    ``split`` lanes of a warp (1, 2 or 4), the fewest that give the card
    1024 threads per multiprocessor. With fewer a launch does not fill the
    card, and a query's latency, not the bytes, sets its time. ``tile`` is a
    multiple of the queries per warp (32 // split) and of 4, at most
    BAND_MAX_TILE."""
    split = next((s for s in (1, 2) if B * H * T * s >= 1024 * sms), 4)
    return cuda.time_tile(T, 32 // split, BAND_MAX_TILE), split


def band_attention(q, k, v, kv_mask, window_size):
    """Banded attention (see :func:`band_attention_torch`).

    On CUDA this launches csrc/band_attention.cu, the counterpart of the TPU
    kernel decafnet_tpu/ops/local_attention.py:_band_attention_pallas_impl.
    q, k and v may be any strided (B, H, T, D) views that share their
    strides (the head view of a (B, C, T) projection is read in place); the
    result is a (B, H, T, D) view of a (B, H, D, T) contiguous buffer."""
    if not cuda.use_kernel(q):
        return band_attention_torch(q, k, v, kv_mask, window_size)
    B, H, T, _ = q.shape
    return launch_band_attention(
        q, k, v, kv_mask, window_size,
        band_attention_plan(B, H, T, cuda.sm_count(q.device)))


def launch_band_attention(q, k, v, kv_mask, window_size, plan):
    """Check the arguments and launch csrc/band_attention.cu on CUDA tensors
    with the launch plan ``(tile, split)`` (see :func:`band_attention_plan`;
    the plan study script passes others)."""
    name = "band_attention"
    B, H, T, D = q.shape
    halo = window_size // 2
    cuda.require(q.is_cuda, name, "the kernel takes CUDA tensors")
    cuda.require(window_size % 2 == 1 and 1 <= halo <= 4, name,
                 f"window_size {window_size} (odd, 3..9)")
    cuda.require(all(t.dtype == torch.float32 and t.device == q.device
                     for t in (q, k, v)), name, "f32 tensors on one device")
    cuda.require(k.shape == q.shape and v.shape == q.shape, name,
                 "q, k, v shapes differ")
    cuda.require(D in BAND_HEAD_DIMS, name,
                 f"head width {D}: the kernel is built for {BAND_HEAD_DIMS}")
    cuda.require(tuple(kv_mask.shape) == (B, T)
                 and kv_mask.dtype == torch.bool
                 and kv_mask.device == q.device, name,
                 "kv_mask must be (B, T) bool on q's device")
    if not (q.stride() == k.stride() == v.stride()):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    sb, sh, st, sd = q.stride()
    tile, split = plan
    out = torch.empty((B, H, D, T), dtype=torch.float32, device=q.device)
    m8 = cuda.as_bytes(kv_mask)
    err = cuda.library().decafnet_band_attention_f32(
        cuda.ptr(q), cuda.ptr(k), cuda.ptr(v), cuda.ptr(m8), cuda.ptr(out),
        B, H, T, D, sb, sh, st, sd, halo, tile, split, cuda.stream())
    cuda.check(err, name)
    band_attention.launches += 1
    return out.transpose(2, 3)


band_attention.launches = 0
