"""Banded (local-window) multi-head attention (port of
decafnet_tpu/ops/local_attention.py).

For query i and band offset r in [-w//2, w//2], key j = i + r takes part
when 0 <= j < T and kv_mask[j]; softmax over those keys, rows with an
invalid query (or no valid key) are zero. ``band_attention_torch`` is the
plain version (the per-diagonal form of the JAX ``band_attention_diag``);
``band_attention`` launches csrc/band_attention.cu for CUDA tensors, its f32
or its bf16 kernel after the inputs' dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import seq
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
    """Plain version. q, k, v (B, H, T, D) f32 or bf16 (f64 for gradient
    checks); kv_mask (B, T) bool (also the query mask); odd
    ``window_size``. Returns (B, H, T, D) in q's dtype.

    The scores, the softmax and the weighted sum of v accumulate in f32 (in
    f64 for f64), as ``band_attention_diag`` does with
    ``preferred_element_type=jnp.float32``: bf16 q and k are upcast before
    their products, which are exact in f32, so the scores are not rounded
    to bf16. JAX's ones-dot form for bf16 at T >= 4096
    (decafnet_tpu/ops/local_attention.py:183-198) is a TPU lowering that
    keeps the q * k products in bf16; the port keeps this exact-product form
    at every length."""
    assert window_size % 2 == 1 and window_size > 0
    halo = window_size // 2
    acc = torch.promote_types(q.dtype, torch.float32)   # f32, or f64 in f64
    mask_f = kv_mask.float()[:, None, :, None]              # (B, 1, T, 1)
    neg = torch.tensor(-float("inf"), device=q.device)
    qa, ka = q.to(acc), k.to(acc)
    scores = []
    for r in range(-halo, halo + 1):
        s = torch.einsum("bhtd,bhtd->bht", qa, _shift_time(ka, r))
        m_r = _shift_time(mask_f, r)[..., 0]                # (B, 1, T)
        scores.append(torch.where(m_r > 0, s, neg))
    s = torch.stack(scores, dim=-1)                         # (B, H, T, w)

    smax = torch.amax(s, dim=-1, keepdim=True)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
    p = torch.exp(s - smax)
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    denom = torch.sum(p, dim=-1, keepdim=True)
    p = p / torch.clamp_min(denom, torch.finfo(p.dtype).tiny)

    out = torch.zeros(q.shape, dtype=acc, device=q.device)
    for i, r in enumerate(range(-halo, halo + 1)):
        out = out + p[..., i:i + 1] * _shift_time(v, r).to(acc)
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
    kernel decafnet_tpu/ops/local_attention.py:_band_attention_pallas_impl:
    its f32 kernel for f32 inputs, its bf16 kernel (bf16 tiles, f32 scores,
    softmax and sums, a bf16 result) for bf16 ones; ``.launches`` counts the
    first, ``.launches_bf16`` the second. q, k and v may be any strided (B, H, T, D) views that share their
    strides (the head view of a (B, C, T) projection is read in place); the
    result is a (B, H, T, D) view of a (B, H, D, T) contiguous buffer.

    Under autograd (:func:`cuda.recording`) the same forward runs inside
    :class:`_BandAttention`, which saves q, k, v (not the result) and whose
    backward recomputes through :func:`band_attention_torch` and
    differentiates it: the counterpart of the JAX ``custom_vjp``, which
    recomputes through ``band_attention_xla``
    (decafnet_tpu/ops/local_attention.py:382-394). The mask gets no
    gradient.

    Time-sharded (:func:`parallel.seq.active`), k, v and the key mask are
    widened by ``window_size // 2`` columns of each neighbour (masked past
    the video's ends), q by as many zero columns, whose outputs are cropped:
    every query of the block sees the keys it sees in one process."""
    shard = seq.active()
    if shard is not None:
        h = window_size // 2
        kh, vh, mh = shard.halo(k, v, kv_mask[:, None, :, None], left=h,
                                right=h, axis=-2)
        qh = F.pad(q, (0, 0, h, h))
        with seq.replicated():
            out = band_attention(qh, kh, vh, mh[:, 0, :, 0], window_size)
        return out[..., h:out.shape[-2] - h, :]
    if cuda.recording(q, k, v):
        return _BandAttention.apply(q, k, v, kv_mask, window_size)
    return _band_attention(q, k, v, kv_mask, window_size)


class _BandAttention(torch.autograd.Function):
    """:func:`band_attention` with its backward by recompute."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, window_size):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.window_size = window_size
        return _band_attention(q, k, v, kv_mask, window_size)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, kv_mask = ctx.saved_tensors
        return cuda.recompute_vjp(
            lambda *qkv: band_attention_torch(*qkv, kv_mask, ctx.window_size),
            (q, k, v), ctx.needs_input_grad[:3], (grad,)) + (None, None)


def _band_attention(q, k, v, kv_mask, window_size):
    """The forward: the plain version for CPU tensors, the kernel for CUDA
    tensors."""
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
    cuda.require(q.dtype in (torch.float32, torch.bfloat16)
                 and all(t.dtype == q.dtype and t.device == q.device
                         for t in (k, v)), name,
                 "f32 or bf16 tensors of one dtype on one device")
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
    out = torch.empty((B, H, D, T), dtype=q.dtype, device=q.device)
    m8 = cuda.as_bytes(kv_mask)
    bf16 = q.dtype == torch.bfloat16
    entry = (cuda.library().decafnet_band_attention_bf16 if bf16
             else cuda.library().decafnet_band_attention_f32)
    err = entry(cuda.ptr(q), cuda.ptr(k), cuda.ptr(v), cuda.ptr(m8),
                cuda.ptr(out), B, H, T, D, sb, sh, st, sd, halo, tile, split,
                cuda.stream())
    cuda.check(err, name + ("_bf16" if bf16 else ""))
    if bf16:
        band_attention.launches_bf16 += 1
    else:
        band_attention.launches += 1
    return out.transpose(2, 3)


band_attention.launches = band_attention.launches_bf16 = 0
