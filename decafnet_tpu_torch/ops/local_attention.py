"""Banded (local-window) multi-head attention (port of
decafnet_tpu/ops/local_attention.py).

For query i and band offset r in [-w//2, w//2], key j = i + r takes part
when 0 <= j < T and kv_mask[j]; softmax over those keys, rows with an
invalid query (or no valid key) are zero. ``band_attention_torch`` is the
plain version (the per-diagonal form of the JAX ``band_attention_diag``);
``band_attention`` launches a kernel for CUDA tensors, after the shape
(``band_attention_route``) and the inputs' dtype: at the served shapes
(D = 32, windows 3..9) the tuned f32 or bf16 kernel of
csrc/band_attention.cu, each with its own launch plan
(``band_attention_plan``, ``band_attention_bf16_plan``); at the other D
that are multiples of 8 up to 256 and windows up to 33 the wide kernel of
csrc/band_attention_wide.cu (``band_attention_wide_plan``); at any other D
or odd window the general kernel of csrc/band_attention_general.cu.
"""

from __future__ import annotations

from collections import namedtuple

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


# head widths and halos (window // 2) the tuned kernels of
# csrc/band_attention.cu are instantiated for (embd 128 / 4 heads, windows
# 3..9); the wide kernel takes D a multiple of BAND_WIDE_DIMS up to
# BAND_WIDE_MAX_D at halos up to BAND_WIDE_MAX_HALO, the general kernel
# every other D and odd window
BAND_HEAD_DIMS = (32,)
BAND_HALOS = (1, 2, 3, 4)
BAND_WIDE_DIMS, BAND_WIDE_MAX_D, BAND_WIDE_MAX_HALO = 8, 256, 16


def band_attention_route(D, window_size):
    """The kernel a CUDA launch at head width ``D`` and ``window_size`` takes,
    in either dtype: "tuned" (csrc/band_attention.cu) at the shapes it is
    built for, "wide" (csrc/band_attention_wide.cu) at D a multiple of 8
    up to 256 and windows up to 33, else "general"
    (csrc/band_attention_general.cu)."""
    if D in BAND_HEAD_DIMS and window_size // 2 in BAND_HALOS:
        return "tuned"
    if band_wide_takes(D, window_size // 2):
        return "wide"
    return "general"


def band_wide_takes(D, halo):
    """Whether the wide kernel takes head width ``D`` at ``halo``."""
    return (D % BAND_WIDE_DIMS == 0 and BAND_WIDE_DIMS <= D <= BAND_WIDE_MAX_D
            and 0 <= halo <= BAND_WIDE_MAX_HALO)


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


# the bf16 kernel's work items: 128 columns of one (b, h) for its TMA
# pipeline (split 1), 16 for one warp of its direct path (split 4), whose
# blocks have 12 warps
BAND_BF16_TILE = 128
BAND_BF16_WARP_COLS = 16
BAND_BF16_WARPS = 12


def band_attention_bf16_plan(B, H, T, sms, pipelined=True):
    """Launch plan ``(split, grid)`` of the bf16 kernel of
    csrc/band_attention.cu for (B, H, T) query views on a card of ``sms``
    multiprocessors. A lane owns two adjacent queries and D / split of
    their head dims. ``split`` 1 runs the kernel's TMA pipeline: items of
    ``BAND_BF16_TILE`` columns, ``grid`` persistent blocks, one per
    multiprocessor (or per item where there are fewer). ``split`` 4 runs
    its direct path: warps over items of ``BAND_BF16_WARP_COLS`` columns,
    ``grid`` blocks of ``BAND_BF16_WARPS`` warps, a warp per item.
    ``split`` is 1 where the pipeline can read the views (``pipelined``, see
    :func:`band_bf16_pipelined`) and the queries number at least its
    consumer lanes (256 per multiprocessor), else 4 (the short levels:
    measured on an H100, the pipeline is the faster at T >= 144 with 64
    rows; scripts/torch_band_trio_plans.py)."""
    if pipelined and B * H * T >= 256 * sms:
        return 1, min(B * H * -(-T // BAND_BF16_TILE), sms)
    items = B * H * -(-T // BAND_BF16_WARP_COLS)
    return 4, -(-items // BAND_BF16_WARPS)


# the wide kernel's launch plan: each block has ``warps`` warps (at most
# BAND_WIDE_MAX_WARPS) over one tile of BAND_WIDE_PAIR_COLS // ``lanes``
# columns of one (b, h); each lane owns two adjacent queries, and a query's
# D is split over warps x lanes parts of BAND_WIDE_DIMS dims per step. Its
# shared memory (two stages, the warps' partial scores, the mask bytes) is
# at most a block's, SMEM_LIMIT bytes
BAND_WIDE_PAIR_COLS, BAND_WIDE_MAX_WARPS, BAND_WIDE_LANES = 64, 8, (1, 2, 4)
SMEM_LIMIT = 232448
# the warps of the plan's blocks: measured on an H100
# (scripts/torch_band_wide_variants.py), blocks of 4 warps with twice the
# steps ran the long served levels 10-25 % faster than blocks of 8 at D 64
# and 128 (more blocks per multiprocessor), within 4 % of them at D 256
BAND_WIDE_PLAN_WARPS = 4
BandWidePlan = namedtuple("BandWidePlan", "warps lanes tile grid smem")


def band_wide_halo_class(halo):
    """The halo the wide kernel is instantiated for that runs ``halo``
    (csrc/band_attention_wide.cu: halo_class): 0..5 as they are, 6..8 on
    8, 9..16 on 16, the offsets past ``halo`` masked."""
    return halo if halo <= 5 else 8 if halo <= 8 else 16


def band_wide_smem(dtype, warps, lanes, halo):
    """Shared memory bytes of a wide-kernel block (csrc/band_attention_wide.cu:
    wide_smem) at ``halo``'s class: two stages of q [dims][tile] and k or v
    [dims][tile + 2 HA] (HA the halo rounded up to a 16-byte copy), the
    warps' partial scores [warps][w][tile] in f32 (none at one warp), the
    staged mask bytes."""
    halo = band_wide_halo_class(halo)
    esz = 2 if dtype == torch.bfloat16 else 4
    vec = 16 // esz
    tile = BAND_WIDE_PAIR_COLS // lanes
    row = tile + 2 * (-(-halo // vec) * vec)
    dims = BAND_WIDE_DIMS * warps * lanes
    stage = -(-dims * (tile + row) * esz // 16) * 16
    scratch = warps * (2 * halo + 1) * tile * 4 if warps > 1 else 0
    return 2 * stage + scratch + -(-row // 16) * 16


def band_attention_wide_plan(dtype, B, H, T, D, halo, sms, warps=None,
                             lanes=None):
    """Launch plan of the wide kernel for (B, H, T, D) queries at ``halo`` on
    a card of ``sms`` multiprocessors, as a :class:`BandWidePlan`: ``warps``
    the most (up to BAND_WIDE_PLAN_WARPS) whose parts of 8 dims divide D;
    ``lanes`` 1 unless a launch would have fewer than 1024 threads per
    multiprocessor (the short levels, where a query's latency and not the
    bytes sets the time), then the fewest of 2 and 4 that reach them (or 4)
    among those the dims allow; ``tile`` the columns of a block, ``grid``
    its blocks, ``smem`` its shared memory. ``warps`` and ``lanes`` may be
    forced (the design study does). Raises ValueError outside the kernel's
    envelope."""
    cuda.require(band_wide_takes(D, halo), "band_attention_wide",
                 f"head width {D} at halo {halo}: the wide kernel takes D a "
                 f"multiple of {BAND_WIDE_DIMS} up to {BAND_WIDE_MAX_D}, halos "
                 f"up to {BAND_WIDE_MAX_HALO}")
    n = D // BAND_WIDE_DIMS
    if warps is None:
        warps = max(w for w in range(1, BAND_WIDE_PLAN_WARPS + 1) if n % w == 0)

    def grid(lanes):
        return B * H * -(-T // (BAND_WIDE_PAIR_COLS // lanes))

    if lanes is None:
        fits = [l for l in BAND_WIDE_LANES if n % (warps * l) == 0]
        lanes = next((l for l in fits if grid(l) * 32 * warps >= 1024 * sms),
                     fits[-1])
    cuda.require(1 <= warps <= BAND_WIDE_MAX_WARPS and lanes in BAND_WIDE_LANES
                 and n % (warps * lanes) == 0, "band_attention_wide",
                 f"plan of {warps} warps x {lanes} lanes at D {D}")
    smem = band_wide_smem(dtype, warps, lanes, halo)
    cuda.require(smem <= SMEM_LIMIT, "band_attention_wide",
                 f"plan of {warps} warps x {lanes} lanes at halo {halo}: "
                 f"{smem} bytes of shared memory")
    return BandWidePlan(warps, lanes, BAND_WIDE_PAIR_COLS // lanes,
                        grid(lanes), smem)


def band_bf16_pipelined(q, k, v):
    """Whether the bf16 kernel's pipeline (split 1) reads these views: by
    TMA or by 8-byte copies, so time-contiguous rows whose strides and
    bases are on 8 bytes, shared by q, k and v. Other views (odd T, a base
    2 bytes off, the (B, H, T, D) layout) take the direct path, which
    measured faster there than the pipeline's single-element copies
    (PERF.md)."""
    sb, sh, st, sd = q.stride()
    return (q.stride() == k.stride() == v.stride() and st == 1
            and sd % 4 == 0 and sh % 4 == 0 and sb % 4 == 0
            and all(t.data_ptr() % 8 == 0 for t in (q, k, v)))


def band_attention(q, k, v, kv_mask, window_size):
    """Banded attention (see :func:`band_attention_torch`).

    On CUDA this launches the counterpart of the TPU kernel
    decafnet_tpu/ops/local_attention.py:_band_attention_pallas_impl, picked
    by :func:`band_attention_route` from D and the window: at the shapes the
    tuned kernels of csrc/band_attention.cu are built for, its f32 kernel
    for f32 inputs, its bf16 kernel (bf16 tiles, f32 scores, softmax and
    sums, a bf16 result) for bf16 ones (``.launches``, ``.launches_bf16``
    count them); at D a multiple of 8 up to 256 and windows up to 33 the
    wide kernel of csrc/band_attention_wide.cu in the inputs' dtype
    (``.launches_wide``, ``.launches_wide_bf16``); at any other shape the
    general kernel of csrc/band_attention_general.cu
    (``.launches_general``, ``.launches_general_bf16``). q, k and v may be
    any strided (B, H, T, D) views that share their strides (the head view
    of a (B, C, T) projection is read in place); the result is a (B, H, T,
    D) view of a (B, H, D, T) contiguous buffer.

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
    every query of the block sees the keys it sees in one process. The
    widened q, k and v are built time-minor, (B, H, D, T) buffers, so the
    kernels read time-contiguous rows."""
    shard = seq.active()
    if shard is not None:
        h = window_size // 2
        kh, vh, mh = shard.halo(k.transpose(2, 3), v.transpose(2, 3),
                                kv_mask[:, None, None, :], left=h, right=h,
                                axis=-1)
        qh = F.pad(q.transpose(2, 3), (h, h))
        with seq.replicated():
            out = band_attention(qh.transpose(2, 3), kh.transpose(2, 3),
                                 vh.transpose(2, 3), mh[:, 0, 0, :],
                                 window_size)
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
    B, H, T, D = q.shape
    route = band_attention_route(D, window_size)
    if route == "general":
        return launch_band_attention_general(q, k, v, kv_mask, window_size)
    if route == "wide":
        return launch_band_attention_wide(q, k, v, kv_mask, window_size)
    sms = cuda.sm_count(q.device)
    plan = (band_attention_bf16_plan(B, H, T, sms, band_bf16_pipelined(q, k, v))
            if q.dtype == torch.bfloat16 else band_attention_plan(B, H, T, sms))
    return launch_band_attention(q, k, v, kv_mask, window_size, plan)


def launch_band_attention(q, k, v, kv_mask, window_size, plan):
    """Check the arguments and launch csrc/band_attention.cu on CUDA tensors
    with a launch plan: ``(tile, split)`` for f32 (see
    :func:`band_attention_plan`), ``(split, grid)`` for bf16 (see
    :func:`band_attention_bf16_plan`); the plan study script passes others."""
    name = "band_attention"
    q, k, v = _checked(name, q, k, v, kv_mask, window_size)
    cuda.require(window_size // 2 in BAND_HALOS, name,
                 f"window_size {window_size}: the tuned kernels take 3..9")
    cuda.require(q.shape[-1] in BAND_HEAD_DIMS, name,
                 f"head width {q.shape[-1]}: the tuned kernels are built for "
                 f"{BAND_HEAD_DIMS}")
    bf16 = q.dtype == torch.bfloat16
    entry = (cuda.library().decafnet_band_attention_bf16 if bf16
             else cuda.library().decafnet_band_attention_f32)
    out = _launch(entry, name + ("_bf16" if bf16 else ""), q, k, v, kv_mask,
                  window_size, *plan)
    if bf16:
        band_attention.launches_bf16 += 1
    else:
        band_attention.launches += 1
    return out


def launch_band_attention_general(q, k, v, kv_mask, window_size):
    """Check the arguments and launch the general kernel of
    csrc/band_attention_general.cu (any D, any odd window; a thread per
    query, no launch plan) on CUDA tensors."""
    name = "band_attention_general"
    q, k, v = _checked(name, q, k, v, kv_mask, window_size)
    bf16 = q.dtype == torch.bfloat16
    entry = (cuda.library().decafnet_band_attention_general_bf16 if bf16
             else cuda.library().decafnet_band_attention_general_f32)
    out = _launch(entry, name + ("_bf16" if bf16 else ""), q, k, v, kv_mask,
                  window_size)
    if bf16:
        band_attention.launches_general_bf16 += 1
    else:
        band_attention.launches_general += 1
    return out


def launch_band_attention_wide(q, k, v, kv_mask, window_size, plan=None):
    """Check the arguments and launch the wide kernel of
    csrc/band_attention_wide.cu on CUDA tensors, with ``plan`` (a
    :class:`BandWidePlan`; by default :func:`band_attention_wide_plan`'s)."""
    name = "band_attention_wide"
    q, k, v = _checked(name, q, k, v, kv_mask, window_size)
    B, H, T, D = q.shape
    if plan is None:
        plan = band_attention_wide_plan(q.dtype, B, H, T, D, window_size // 2,
                                        cuda.sm_count(q.device))
    bf16 = q.dtype == torch.bfloat16
    entry = (cuda.library().decafnet_band_attention_wide_bf16 if bf16
             else cuda.library().decafnet_band_attention_wide_f32)
    out = _launch(entry, name + ("_bf16" if bf16 else ""), q, k, v, kv_mask,
                  window_size, plan.warps, plan.lanes)
    if bf16:
        band_attention.launches_wide_bf16 += 1
    else:
        band_attention.launches_wide += 1
    return out


def _checked(name, q, k, v, kv_mask, window_size):
    """The checks every band-attention kernel makes; q, k and v as one
    launch reads them (contiguous copies where their strides differ)."""
    B, H, T, D = q.shape
    cuda.require(q.is_cuda, name, "the kernel takes CUDA tensors")
    cuda.require(window_size % 2 == 1 and window_size > 0, name,
                 f"window_size {window_size} (odd)")
    cuda.require(q.dtype in (torch.float32, torch.bfloat16)
                 and all(t.dtype == q.dtype and t.device == q.device
                         for t in (k, v)), name,
                 "f32 or bf16 tensors of one dtype on one device")
    cuda.require(k.shape == q.shape and v.shape == q.shape, name,
                 "q, k, v shapes differ")
    cuda.require(tuple(kv_mask.shape) == (B, T)
                 and kv_mask.dtype == torch.bool
                 and kv_mask.device == q.device, name,
                 "kv_mask must be (B, T) bool on q's device")
    if not (q.stride() == k.stride() == v.stride()):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v


def _launch(entry, name, q, k, v, kv_mask, window_size, *plan):
    """One launch of a band-attention entry point into a (B, H, D, T)
    buffer; returns its (B, H, T, D) view."""
    B, H, T, D = q.shape
    sb, sh, st, sd = q.stride()
    out = torch.empty((B, H, D, T), dtype=q.dtype, device=q.device)
    m8 = cuda.as_bytes(kv_mask)
    err = entry(cuda.ptr(q), cuda.ptr(k), cuda.ptr(v), cuda.ptr(m8),
                cuda.ptr(out), B, H, T, D, sb, sh, st, sd, window_size // 2,
                *plan, cuda.stream())
    cuda.check(err, name)
    return out.transpose(2, 3)


band_attention.launches = band_attention.launches_bf16 = 0
band_attention.launches_general = band_attention.launches_general_bf16 = 0
band_attention.launches_wide = band_attention.launches_wide_bf16 = 0
