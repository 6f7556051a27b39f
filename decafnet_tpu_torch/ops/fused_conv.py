"""Fused masked conv3 + channel LayerNorm + activation, and the depthwise
q/k/v trio (port of decafnet_tpu/ops/fused_conv.py).

Each op has a plain PyTorch version (``*_torch``) and hand-written CUDA
kernels, each in f32 and bf16: tuned ones (csrc/conv3_ln_act.cu,
csrc/qkv_depthwise_ln.cu) up to 256 channels, wide ones (a cluster splits
the channels: csrc/conv3_ln_act_wide.cu, C_out up to 1024, and
csrc/qkv_depthwise_ln_wide.cu, C up to 4096), conv3 pass ones (one block
computes C_out up to 4096 in passes) and general ones for wider layers
(csrc/*_general.cu). The public op takes the plain version
for a tensor on the CPU and, for a CUDA tensor, launches the kernel that
its route rule (:func:`conv3_route`, :func:`qkv_route`) picks from the
width, in the input's dtype;
``.launches`` / ``.launches_bf16`` on the op count launches of the tuned
f32 / bf16 kernel, ``.launches_wide`` / ``.launches_wide_bf16`` of the wide
ones, ``.launches_passes`` / ``.launches_passes_bf16`` of conv3's pass
ones, ``.launches_general`` / ``.launches_general_bf16`` of the general
ones (for conv3, one launch covers up to CONV3_MAX_LEVELS levels of a
:func:`conv3_ln_act_levels` call). Under autograd each op's backward
recomputes through its plain version (the rule in ops/cuda.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..parallel import seq
from . import cuda
from .masked import channel_layer_norm
from .params import cached

# activation dtypes the kernels take
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def conv3_ln_act_torch(x, mask, w, bias, ln_w, ln_b, act="relu", eps=1e-5):
    """Plain version: ``act(LN_c(conv3(x * mask) + bias) * ln_w + ln_b)``, the
    JAX ``conv3_ln_act_xla`` composition (decafnet_tpu/ops/fused_conv.py:48-75).

    x (B, C_in, T) f32 or bf16; mask (B, T) bool; w (C_out, C_in, 3); bias
    (C_out,) or None; ln_w/ln_b (C_out,) or (C_out, 1), or None for no
    affine; act 'relu' | 'none'. The weight and bias are cast to x's dtype:
    in bf16 the conv accumulates in f32 and rounds its output to bf16, the
    bias is added in bf16, the LN (statistics and affine) runs in f32 on the
    f32 LN parameters, and the result is x's dtype."""
    xm = x * mask[:, None, :].to(x.dtype)
    y = F.conv1d(xm, w.to(x.dtype), padding=1)
    if bias is not None:
        y = y + bias.to(y.dtype)[None, :, None]
    y = channel_layer_norm(y, ln_w, ln_b, eps)
    return torch.relu(y) if act == "relu" else y


def tf32_split(a):
    """``(hi, lo)`` with ``hi = tf32(a)`` and ``lo = tf32(a - hi)``, each an f32
    tensor whose low 13 mantissa bits are zero. The rounding is to nearest
    with ties away from zero on the magnitude, as ``cvt.rna.tf32.f32`` does."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = rna(a)
    return hi, rna(a - hi)


# the output widths the kernels of csrc/conv3_ln_act.cu are built for (their
# wgmma N): C_out is padded to the first that holds it
CONV3_WIDTHS = (64, 128, 160, 256)


def conv3_weight_fragments(w, N=None):
    """The (C_out, C_in, 3) conv weight in f32 as the f32 kernel of
    csrc/conv3_ln_act.cu stages it: (ceil(C_in/8), 3, N, 8) with N = C_out
    padded to the first of CONV3_WIDTHS that holds it (or ``N``, as the
    wide kernel's slices take it), zero where padded.
    Entry [c, tap, n] is the 32-byte row ``w[n, 8c:8c + 8, tap]`` (the
    K-major B operand of TF32 wgmma) with its two 16-byte pieces k moved to
    k ^ ((n // 4) % 2), the 32-byte swizzle the kernel's descriptor names."""
    C_out, C_in, _ = w.shape
    N = N or next(n for n in CONV3_WIDTHS if C_out <= n)
    nc = -(-C_in // 8)
    wp = w.new_zeros(N, 8 * nc, 3, dtype=torch.float32)
    wp[:C_out, :C_in] = w
    # (n, c, k, e, tap) -> (c, tap, n, k, e), then piece k' of row n holds
    # the logical piece k' ^ ((n // 4) % 2)
    img = wp.view(N, nc, 2, 4, 3).permute(1, 4, 0, 2, 3)
    n = torch.arange(N, device=w.device)
    k = torch.arange(2, device=w.device)
    return (img[:, :, n[:, None], k[None, :] ^ ((n[:, None] >> 2) & 1)]
            .reshape(nc, 3, N, 8).contiguous())


def conv3_weight_operands(w):
    """The f32 kernel's weight operand: the TF32 halves of
    :func:`conv3_weight_fragments`, (ceil(C_in/8), 2, 3, N, 8) with hi at
    [:, 0] and lo at [:, 1] (:func:`tf32_split`), so one chunk of 8 input
    channels is one bulk copy. Built once per weight and kept on the tensor
    itself against its ``_version`` and storage (:func:`ops.params.cached`),
    so an in-place update (``add_``, ``load_state_dict``) or a new ``.data``
    builds a fresh one. Inference tensors carry no version counter and are
    not cached."""
    return cached(w, "tf32_operands",
                  lambda w: torch.stack(tf32_split(conv3_weight_fragments(w)), 1))


def conv3_bf16_fragments(w, N=None):
    """The (C_out, C_in, 3) conv weight rounded to bf16 as the bf16 kernel of
    csrc/conv3_ln_act.cu stages it: (ceil(C_in/32), 3, N, 32) with N = C_out
    padded to the first of CONV3_WIDTHS that holds it (or ``N``), zero where
    padded. Entry [c, tap, n] is the 64-byte row ``w[n, 32c:32c + 32, tap]``
    (the K-major B operand of wgmma) with its four 16-byte pieces k moved to
    k ^ ((n // 2) % 4), the 64-byte swizzle the kernel's descriptor names;
    one chunk c is one bulk copy into shared memory."""
    C_out, C_in, _ = w.shape
    N = N or next(n for n in CONV3_WIDTHS if C_out <= n)
    nc = -(-C_in // 32)
    wp = w.new_zeros(N, 32 * nc, 3, dtype=torch.bfloat16)
    wp[:C_out, :C_in] = w
    # (n, c, k, e, tap) -> (c, tap, n, k, e), then piece k' of row n holds
    # the logical piece k' ^ ((n // 2) % 4)
    img = wp.view(N, nc, 4, 8, 3).permute(1, 4, 0, 2, 3)
    n = torch.arange(N, device=w.device)
    k = torch.arange(4, device=w.device)
    return (img[:, :, n[:, None], k[None, :] ^ ((n[:, None] >> 1) & 3)]
            .reshape(nc, 3, N, 32).contiguous())


def conv3_bf16_operands(w):
    """:func:`conv3_bf16_fragments` of ``w``, cached against its version as
    :func:`conv3_weight_operands` is."""
    return cached(w, "bf16_fragments", conv3_bf16_fragments)


# the wide kernels of csrc/conv3_ln_act_wide.cu, per dtype: a cluster of up
# to CONV3_WIDE_MAX_CLUSTER blocks, each one slice of one of
# CONV3_WIDE_SLICES output channels; C_out up to CONV3_WIDE_MAX_C
CONV3_WIDE_SLICES = {torch.float32: (144, 192, 256), torch.bfloat16: (128, 144)}
CONV3_WIDE_MAX_CLUSTER = {torch.float32: 4, torch.bfloat16: 8}
CONV3_WIDE_MAX_C = 1024
# shared memory one block may take on an H100 (SMEM_LIMIT in the source)
SMEM_LIMIT = 232448


class Conv3WidePlan(NamedTuple):
    """A launch plan of the wide conv3 kernels: output channels per block,
    blocks per cluster, stages of the ring, dynamic shared memory bytes of a
    block and time columns per work item."""
    slice: int
    cluster: int
    stages: int
    smem: int
    tile: int


def conv3_wide_plan(dtype, C_out):
    """The plan of the ``dtype`` wide kernel at ``C_out`` (1 to
    CONV3_WIDE_MAX_C), as csrc/conv3_ln_act_wide.cu computes it (wide_plan,
    TfWide, BfWide; the C query decafnet_conv3_ln_act_wide_plan answers the
    same): ceil(C_out / 256) blocks in f32, ceil(C_out / 144) in bf16, each
    a slice of the narrowest of CONV3_WIDE_SLICES[dtype] that holds
    ceil(C_out / cluster); a block's shared memory is its ring of stages (as
    many as fit, at most 4) beside the LN exchange (8 KB), the slice's bias,
    ln_w and ln_b, the barriers, and in bf16 the staged outputs. An f32
    slice is split over the block's two warpgroups, items of 64 columns; a
    bf16 block takes items of 128."""
    if not 1 <= C_out <= CONV3_WIDE_MAX_C:
        raise ValueError(f"conv3_ln_act_wide: C_out {C_out} outside 1.."
                         f"{CONV3_WIDE_MAX_C}")
    bf16 = dtype == torch.bfloat16
    slices = CONV3_WIDE_SLICES[torch.bfloat16 if bf16 else torch.float32]
    cluster = -(-C_out // slices[-1])
    ns = next(n for n in slices if -(-C_out // cluster) <= n)
    exchange, params = 2 * 8 * 128 * 4, 3 * ns * 4
    if bf16:
        tile, out = 128, 2 * ns * (2 * 64 + 16)
        stage = 4 * 32 * 64 * 2 + 3 * ns * 32 * 2
    else:
        tile, out = 64, 0
        stage = (tile // 32 + 2) * 8 * 32 * 4 + 2 * 3 * ns * 8 * 4

    def fixed(stages):
        return out + exchange + params + (2 * stages + 2) * 8 + 1024

    stages = min(4, (SMEM_LIMIT - fixed(4)) // stage)
    return Conv3WidePlan(ns, cluster, stages, stages * stage + fixed(stages), tile)


def conv3_wide_source_plan(dtype, C_out):
    """The plan csrc/conv3_ln_act_wide.cu computes at ``C_out`` (its C query
    decafnet_conv3_ln_act_wide_plan), to hold :func:`conv3_wide_plan`
    against on the card."""
    out = (ctypes.c_int * 5)()
    err = cuda.library().decafnet_conv3_ln_act_wide_plan(
        C_out, int(dtype == torch.bfloat16), out)
    if err:
        raise ValueError(f"conv3_ln_act_wide: C_out {C_out} outside the "
                         "kernels' plans")
    return Conv3WidePlan(*out)


def conv3_wide_operands(w, dtype=torch.float32):
    """The ``dtype`` wide kernel's weight operand: ``w`` zero-padded to
    cluster x slice output channels (:func:`conv3_wide_plan`), each slice's
    image as the tuned kernel of that dtype stages it at N = slice, the
    slices one after the other: f32 (cluster, ceil(C_in/8), 2, 3, slice, 8)
    TF32 halves (:func:`conv3_weight_operands`), bf16 (cluster,
    ceil(C_in/32), 3, slice, 32) (:func:`conv3_bf16_fragments`). Cached
    against the weight's version, as those are."""
    def build(w):
        plan = conv3_wide_plan(dtype, w.shape[0])
        return _slice_images(w, dtype, plan.cluster, plan.slice)
    key = "wide_bf16" if dtype == torch.bfloat16 else "wide_tf32"
    return cached(w, key, build)


def _slice_images(w, dtype, n, width):
    """``w`` zero-padded to ``n`` x ``width`` output channels, each slice of
    ``width`` channels laid out as the tuned kernel of ``dtype`` stages it
    at N = ``width``, the slices one after the other: f32 (n, ceil(C_in/8),
    2, 3, width, 8) TF32 halves, bf16 (n, ceil(C_in/32), 3, width, 32)."""
    C_out, C_in, _ = w.shape
    wp = w.new_zeros(n * width, C_in, 3, dtype=torch.float32)
    wp[:C_out] = w
    if dtype == torch.bfloat16:
        return torch.stack([conv3_bf16_fragments(s, width) for s in wp.split(width)])
    return torch.stack([torch.stack(tf32_split(conv3_weight_fragments(s, width)), 1)
                        for s in wp.split(width)])


# the pass kernels of csrc/conv3_ln_act_passes.cu, both dtypes: one block per
# item of CONV3_PASSES_TILE columns computes C_out in passes of one of
# CONV3_PASSES_SLICES channels, up to CONV3_PASSES_MAX_C
CONV3_PASSES_SLICES = (128, 160)
CONV3_PASSES_MAX_C = 4096
CONV3_PASSES_TILE = 128
CONV3_PASSES_MAX_STAGES = 6


class Conv3PassesPlan(NamedTuple):
    """A launch plan of the pass conv3 kernels: output channels a pass,
    passes, stages of the ring, dynamic shared memory bytes of a block and
    time columns per work item."""
    slice: int
    passes: int
    stages: int
    smem: int
    tile: int


def conv3_passes_plan(dtype, C_out):
    """The plan of the ``dtype`` pass kernel at ``C_out`` (1 to
    CONV3_PASSES_MAX_C), as csrc/conv3_ln_act_passes.cu computes it
    (passes_plan, Plan; its C query decafnet_conv3_ln_act_passes_plan
    answers the same): passes of 160 channels where they pad C_out no more
    than passes of 128, else of 128; a stage is one chunk of input channels
    (8 in f32, 32 in bf16) of one pass, its x boxes (6 of 32 columns in
    f32, 4 of 64 in bf16) and weights (192 bytes a channel), as many stages
    as fit a block's shared memory beside the barriers, at most
    CONV3_PASSES_MAX_STAGES; items of CONV3_PASSES_TILE columns."""
    if not 1 <= C_out <= CONV3_PASSES_MAX_C:
        raise ValueError(f"conv3_ln_act_passes: C_out {C_out} outside 1.."
                         f"{CONV3_PASSES_MAX_C}")
    narrow, wide = CONV3_PASSES_SLICES
    ns = wide if wide * -(-C_out // wide) <= narrow * -(-C_out // narrow) else narrow
    if dtype == torch.bfloat16:
        x_bytes = (CONV3_PASSES_TILE // 64 + 2) * 32 * 64 * 2
    else:
        x_bytes = (CONV3_PASSES_TILE // 32 + 2) * 8 * 32 * 4
    stage = x_bytes + 192 * ns
    bars = 2 * 8
    stages = min(CONV3_PASSES_MAX_STAGES,
                 (SMEM_LIMIT - bars * CONV3_PASSES_MAX_STAGES - 1024) // stage)
    return Conv3PassesPlan(ns, -(-C_out // ns), stages,
                           stages * stage + bars * stages + 1024, CONV3_PASSES_TILE)


def conv3_passes_source_plan(dtype, C_out):
    """The plan csrc/conv3_ln_act_passes.cu computes at ``C_out`` (its C
    query decafnet_conv3_ln_act_passes_plan), to hold
    :func:`conv3_passes_plan` against on the card."""
    out = (ctypes.c_int * 5)()
    err = cuda.library().decafnet_conv3_ln_act_passes_plan(
        C_out, int(dtype == torch.bfloat16), out)
    if err:
        raise ValueError(f"conv3_ln_act_passes: C_out {C_out} outside the "
                         "kernels' plans")
    return Conv3PassesPlan(*out)


def conv3_passes_operands(w, dtype=torch.float32):
    """The ``dtype`` pass kernel's weight operand: ``w`` zero-padded to
    passes x slice output channels (:func:`conv3_passes_plan`), each pass's
    image as the tuned kernel of that dtype stages it at N = slice, the
    passes one after the other (the layout of :func:`conv3_wide_operands`
    with passes for blocks). Cached against the weight's version."""
    def build(w):
        plan = conv3_passes_plan(dtype, w.shape[0])
        return _slice_images(w, dtype, plan.passes, plan.slice)
    key = "passes_bf16" if dtype == torch.bfloat16 else "passes_tf32"
    return cached(w, key, build)


# time columns per work item of the kernels of csrc/conv3_ln_act.cu: two
# consumer warpgroups of WM = 64 columns; the f32 kernel's items are 64
# columns for C_out above 160, where its warpgroups split the channels
# (TfPlan there)
CONV3_TILE_T = 128


def conv3_tile(dtype, C_out):
    """Time columns per work item of the ``dtype`` kernel at ``C_out``."""
    return CONV3_TILE_T // 2 if dtype == torch.float32 and C_out > 160 else CONV3_TILE_T

# FPN levels one launch takes (MAX_LEVELS in both conv3 sources): a longer
# level list is split into launches of at most this many levels
CONV3_MAX_LEVELS = 8


def conv3_route(C_out):
    """The kernel a CUDA launch at ``C_out`` output channels takes, in either
    dtype: "tuned" (the wgmma kernels of csrc/conv3_ln_act.cu, built for N
    up to CONV3_WIDTHS[-1]), "wide" (the wgmma kernels of
    csrc/conv3_ln_act_wide.cu, a cluster of blocks splitting C_out up to
    CONV3_WIDE_MAX_C), "passes" (the wgmma kernels of
    csrc/conv3_ln_act_passes.cu, one block computing C_out up to
    CONV3_PASSES_MAX_C in passes) or "general"
    (csrc/conv3_ln_act_general.cu). A rule of the shape, decided before the
    launch."""
    if C_out <= CONV3_WIDTHS[-1]:
        return "tuned"
    if C_out <= CONV3_WIDE_MAX_C:
        return "wide"
    return "passes" if C_out <= CONV3_PASSES_MAX_C else "general"


def conv3_general_tile(C_out):
    """Time columns per work item of the general conv3 kernel at ``C_out``:
    the widest of 32, 16, 8 and 4 whose block's shared memory fits the
    card's, as csrc/conv3_ln_act_general.cu lays it out (32 up to C_out
    ~1,600, 4 up to ~8,000; the C query decafnet_conv3_ln_act_general_tile).
    Wider C_out raises: the TPU kernel holds three (C_in, C_out) f32 weight
    tiles in VMEM, 128 MiB at most, so it takes no C_out above ~3,300
    either."""
    tile = cuda.library().decafnet_conv3_ln_act_general_tile(C_out)
    if tile <= 0:
        raise ValueError(f"conv3_ln_act: C_out {C_out} exceeds the shared "
                         "memory of one block of the general kernel")
    return tile


def conv3_work_table(shapes, tile=CONV3_TILE_T):
    """The work items of one launch over levels of (B, T) ``shapes``: an
    (n, 3) int32 tensor of (level, row, first column), each column tile of
    ``tile`` columns of each row of each level once, level by level (the
    longest first, as the FPN lists them), rows in order, tiles in order."""
    items = [(lvl, b, t0) for lvl, (B, T) in enumerate(shapes)
             for b in range(B) for t0 in range(0, T, tile)]
    return torch.tensor(items, dtype=torch.int32).reshape(-1, 3)


@functools.lru_cache(maxsize=64)
def _device_work_table(shapes, tile, device):
    """:func:`conv3_work_table` on ``device``, built once per level list."""
    return conv3_work_table(shapes, tile).to(device)


class _Level(ctypes.Structure):
    """One level of a launch (``Conv3Level`` in csrc/conv3_ln_act.cu)."""
    _fields_ = [("x", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("B", ctypes.c_int),
                ("T", ctypes.c_int)]


def conv3_ln_act(x, mask, w, bias=None, ln_w=None, ln_b=None, act="relu",
                 eps=1e-5):
    """Fused masked conv3 + channel LN + activation (see
    :func:`conv3_ln_act_torch` for the arguments): the one-level case of
    :func:`conv3_ln_act_levels`."""
    return conv3_ln_act_levels([x], [mask], w, bias, ln_w, ln_b, act, eps)[0]


def conv3_ln_act_levels(xs, masks, w, bias=None, ln_w=None, ln_b=None,
                        act="relu", eps=1e-5):
    """:func:`conv3_ln_act_torch` of each (x, mask) of the lists ``xs`` and
    ``masks`` (the FPN levels of one head layer: the same C_in and weights,
    any B and T each), as a list.

    On CUDA this is one launch (per CONV3_MAX_LEVELS levels) of the
    counterpart of the TPU kernel
    decafnet_tpu/ops/fused_conv.py:_conv3_ln_act_pallas_impl, over a table
    of (level, row, column tile) work items (:func:`conv3_work_table`): the
    short levels' tiles fill the card beside the long ones' instead of
    taking launches of their own. Up to C_out 256 (:func:`conv3_route`) the
    tuned kernels of csrc/conv3_ln_act.cu run on ``wgmma``, x brought by TMA
    and the weights laid out once per weight: for f32 x in three TF32
    passes (f32 accuracy; :func:`conv3_weight_operands`), for bf16 x in one
    bf16 pass with f32 accumulation (:func:`conv3_bf16_operands`), the
    function of the bf16 plain version. Up to CONV3_WIDE_MAX_C the wide
    kernels of csrc/conv3_ln_act_wide.cu do the same with a thread-block
    cluster whose blocks split C_out (:func:`conv3_wide_plan`,
    :func:`conv3_wide_operands`); up to CONV3_PASSES_MAX_C the pass kernels
    of csrc/conv3_ln_act_passes.cu, one block computing C_out in passes
    whose pre-LN sums wait in the output (:func:`conv3_passes_plan`,
    :func:`conv3_passes_operands`); wider layers take the general kernel of
    csrc/conv3_ln_act_general.cu, which reads the plain weight and
    multiplies on the CUDA cores. The outputs have x's dtype.

    Under autograd (:func:`cuda.recording`) the same forward runs inside
    :class:`_Conv3LnAct`, whose backward recomputes each level through
    :func:`conv3_ln_act_torch` and differentiates it: the counterpart of the
    JAX ``custom_vjp``, which recomputes through ``conv3_ln_act_xla``
    (decafnet_tpu/ops/fused_conv.py:209-234). The masks get no gradient, nor
    does an absent bias or LN affine.

    Time-sharded (:func:`parallel.seq.active`), each level is widened by one
    column of each neighbour (x and mask, zeros and False past the video's
    ends; one exchange per level), the launch runs over the widened blocks,
    and each result is cropped back to its block."""
    xs, masks = list(xs), list(masks)
    shard = seq.active()
    if shard is not None:
        wide = [shard.halo(x, m, left=1, right=1) for x, m in zip(xs, masks)]
        with seq.replicated():
            ys = conv3_ln_act_levels([x for x, _ in wide], [m for _, m in wide],
                                     w, bias, ln_w, ln_b, act, eps)
        return [seq.crop(y, 1, 1) for y in ys]
    if cuda.recording(*xs, w, bias, ln_w, ln_b):
        return list(_Conv3LnAct.apply(len(xs), act, eps, w, bias, ln_w, ln_b,
                                      *xs, *masks))
    return _conv3_ln_act_levels(xs, masks, w, bias, ln_w, ln_b, act, eps)


class _Conv3LnAct(torch.autograd.Function):
    """:func:`conv3_ln_act_levels` with its backward by recompute; the levels
    come flat (``*xs, *masks``) so autograd tracks each x."""

    @staticmethod
    def forward(ctx, n, act, eps, w, bias, ln_w, ln_b, *xs_masks):
        xs, masks = xs_masks[:n], xs_masks[n:]
        ctx.save_for_backward(w, bias, ln_w, ln_b, *xs_masks)
        ctx.options = (n, act, eps)
        return tuple(_conv3_ln_act_levels(xs, masks, w, bias, ln_w, ln_b, act,
                                          eps))

    @staticmethod
    def backward(ctx, *grads):
        n, act, eps = ctx.options
        w, bias, ln_w, ln_b, *xs_masks = ctx.saved_tensors
        masks = xs_masks[n:]
        needs = ctx.needs_input_grad
        gp = cuda.recompute_vjp(
            lambda w_, b_, lw_, lb_, *xs: tuple(
                conv3_ln_act_torch(x, m, w_, b_, lw_, lb_, act=act, eps=eps)
                for x, m in zip(xs, masks)),
            (w, bias, ln_w, ln_b, *xs_masks[:n]), needs[3:7 + n], grads)
        return (None, None, None, *gp, *(None,) * n)


def _conv3_ln_act_levels(xs, masks, w, bias, ln_w, ln_b, act, eps):
    """The forward: the plain version for CPU tensors, for CUDA tensors the
    kernel :func:`conv3_route` picks, one launch per CONV3_MAX_LEVELS
    levels."""
    if not cuda.use_kernel(xs[0]):
        return [conv3_ln_act_torch(x, m, w, bias, ln_w, ln_b, act=act, eps=eps)
                for x, m in zip(xs, masks)]
    launch = {"tuned": launch_conv3_ln_act_levels,
              "wide": launch_conv3_ln_act_wide,
              "passes": launch_conv3_ln_act_passes,
              "general": launch_conv3_ln_act_general}[conv3_route(w.shape[0])]
    return [y for i, j in conv3_launch_groups(len(xs))
            for y in launch(xs[i:j], masks[i:j], w, bias, ln_w, ln_b, act, eps)]


def conv3_launch_groups(n_levels):
    """The launches of a list of ``n_levels`` levels on the card, as
    ``(first, end)`` level ranges of at most CONV3_MAX_LEVELS, in order."""
    n = CONV3_MAX_LEVELS
    return [(i, min(i + n, n_levels)) for i in range(0, n_levels, n)]


def _conv3_launch_args(name, xs, masks, w, bias, ln_w, ln_b, act, tile):
    """The checks every conv3 kernel makes, then what a launch over up to
    CONV3_MAX_LEVELS levels of CUDA tensors passes first: (levels, n_levels,
    work table, n_work) at ``tile`` columns per work item (a function of
    C_out), the f32 bias, ln_w and ln_b, and the output buffers."""
    x0 = xs[0]
    C_out, C_in = w.shape[0], x0.shape[1]
    cuda.require(x0.is_cuda, name, "the kernel takes CUDA tensors")
    cuda.require(x0.dtype in KERNEL_DTYPES, name, "f32 or bf16 x")
    cuda.require(1 <= len(xs) == len(masks) <= CONV3_MAX_LEVELS, name,
                 f"1 to {CONV3_MAX_LEVELS} levels, a mask each")
    for x, mask in zip(xs, masks):
        B, c, T = x.shape
        cuda.require(x.dtype == x0.dtype and x.device == x0.device and c == C_in,
                     name, "levels of one dtype, device and C_in")
        cuda.require(x.is_contiguous(), name, "x must be contiguous")
        cuda.require(tuple(mask.shape) == (B, T) and mask.dtype == torch.bool
                     and mask.device == x.device, name,
                     "mask must be (B, T) bool on x's device")
        cuda.require(B > 0 and T > 0, name, "empty level")
    p_dtypes = KERNEL_DTYPES if x0.dtype == torch.bfloat16 else (torch.float32,)
    cuda.require(all(t.dtype in p_dtypes and t.device == x0.device
                     for t in (w, bias, ln_w, ln_b) if t is not None), name,
                 "parameters on x's device, f32 (or bf16 for bf16 x)")
    cuda.require(tuple(w.shape) == (C_out, C_in, 3), name, f"w shape {w.shape}")
    cuda.require(all(p.numel() == C_out for p in (bias, ln_w, ln_b)
                     if p is not None), name, "per-channel params of C_out")
    cuda.require(act in ("relu", "none"), name, f"act {act!r}")
    cuda.require((ln_w is None) == (ln_b is None), name,
                 "ln_w and ln_b both or neither")
    tile = tile(C_out)
    vec = lambda p: None if p is None else p.reshape(-1).float().contiguous()  # noqa: E731
    m8s = [cuda.as_bytes(m) for m in masks]
    outs = [torch.empty((x.shape[0], C_out, x.shape[2]), dtype=x.dtype,
                        device=x.device) for x in xs]
    shapes = tuple((x.shape[0], x.shape[2]) for x in xs)
    levels = (_Level * len(xs))(*(
        _Level(x.data_ptr(), m.data_ptr(), o.data_ptr(), B, T)
        for x, m, o, (B, T) in zip(xs, m8s, outs, shapes)))
    work = _device_work_table(shapes, tile, x0.device)
    # m8s and work stay alive through the launch in the caller's frame
    return ((levels, len(xs), cuda.ptr(work), work.shape[0]),
            (vec(bias), vec(ln_w), vec(ln_b)), outs, (m8s, work, tile))


def launch_conv3_ln_act_levels(xs, masks, w, bias, ln_w, ln_b, act, eps):
    """Check the arguments and make one launch of the tuned kernels of
    csrc/conv3_ln_act.cu (C_out up to CONV3_WIDTHS[-1]) over up to
    CONV3_MAX_LEVELS levels of CUDA tensors."""
    name = "conv3_ln_act"
    C_out, C_in = w.shape[0], xs[0].shape[1]
    cuda.require(conv3_route(C_out) == "tuned", name,
                 f"C_out {C_out}: the tuned kernels take up to {CONV3_WIDTHS[-1]}")
    bf16 = xs[0].dtype == torch.bfloat16
    head, (bias, ln_w, ln_b), outs, _keep = _conv3_launch_args(
        name, xs, masks, w, bias, ln_w, ln_b, act,
        lambda C_out: conv3_tile(xs[0].dtype, C_out))
    tail = (cuda.ptr(bias), cuda.ptr(ln_w), cuda.ptr(ln_b), C_in, C_out,
            float(eps), int(act == "relu"), cuda.stream())
    if bf16:
        err = cuda.library().decafnet_conv3_ln_act_bf16(
            *head, cuda.ptr(conv3_bf16_operands(w)), *tail)
        cuda.check(err, name + "_bf16")
        conv3_ln_act.launches_bf16 += 1
        return outs
    err = cuda.library().decafnet_conv3_ln_act_f32(
        *head, cuda.ptr(conv3_weight_operands(w)), *tail)
    cuda.check(err, name)
    conv3_ln_act.launches += 1
    return outs


def launch_conv3_ln_act_wide(xs, masks, w, bias, ln_w, ln_b, act, eps):
    """Check the arguments and make one launch of the wide kernels of
    csrc/conv3_ln_act_wide.cu (C_out up to CONV3_WIDE_MAX_C; the card checks
    hold them at narrower widths too, one block a cluster) over up to
    CONV3_MAX_LEVELS levels of CUDA tensors."""
    name = "conv3_ln_act_wide"
    C_out, C_in = w.shape[0], xs[0].shape[1]
    cuda.require(1 <= C_out <= CONV3_WIDE_MAX_C, name,
                 f"C_out {C_out}: the wide kernels take up to {CONV3_WIDE_MAX_C}")
    dtype = xs[0].dtype
    bf16 = dtype == torch.bfloat16
    head, (bias, ln_w, ln_b), outs, _keep = _conv3_launch_args(
        name, xs, masks, w, bias, ln_w, ln_b, act,
        lambda C_out: conv3_wide_plan(dtype, C_out).tile)
    plan = conv3_wide_plan(dtype, C_out)
    entry = (cuda.library().decafnet_conv3_ln_act_wide_bf16 if bf16
             else cuda.library().decafnet_conv3_ln_act_wide_f32)
    err = entry(*head, cuda.ptr(conv3_wide_operands(w, dtype)), cuda.ptr(bias),
                cuda.ptr(ln_w), cuda.ptr(ln_b), C_in, C_out, plan.slice,
                plan.cluster, float(eps), int(act == "relu"), cuda.stream())
    cuda.check(err, name + ("_bf16" if bf16 else ""))
    if bf16:
        conv3_ln_act.launches_wide_bf16 += 1
    else:
        conv3_ln_act.launches_wide += 1
    return outs


def launch_conv3_ln_act_passes(xs, masks, w, bias, ln_w, ln_b, act, eps):
    """Check the arguments and make one launch of the pass kernels of
    csrc/conv3_ln_act_passes.cu (C_out up to CONV3_PASSES_MAX_C; the card
    checks hold them at narrower widths too, one pass or a few) over up to
    CONV3_MAX_LEVELS levels of CUDA tensors."""
    name = "conv3_ln_act_passes"
    C_out, C_in = w.shape[0], xs[0].shape[1]
    cuda.require(1 <= C_out <= CONV3_PASSES_MAX_C, name,
                 f"C_out {C_out}: the pass kernels take up to {CONV3_PASSES_MAX_C}")
    dtype = xs[0].dtype
    bf16 = dtype == torch.bfloat16
    head, (bias, ln_w, ln_b), outs, _keep = _conv3_launch_args(
        name, xs, masks, w, bias, ln_w, ln_b, act,
        lambda C_out: conv3_passes_plan(dtype, C_out).tile)
    plan = conv3_passes_plan(dtype, C_out)
    entry = (cuda.library().decafnet_conv3_ln_act_passes_bf16 if bf16
             else cuda.library().decafnet_conv3_ln_act_passes_f32)
    err = entry(*head, cuda.ptr(conv3_passes_operands(w, dtype)), cuda.ptr(bias),
                cuda.ptr(ln_w), cuda.ptr(ln_b), C_in, C_out, plan.slice,
                plan.passes, float(eps), int(act == "relu"), cuda.stream())
    cuda.check(err, name + ("_bf16" if bf16 else ""))
    if bf16:
        conv3_ln_act.launches_passes_bf16 += 1
    else:
        conv3_ln_act.launches_passes += 1
    return outs


def launch_conv3_ln_act_general(xs, masks, w, bias, ln_w, ln_b, act, eps):
    """Check the arguments and make one launch of the general kernel of
    csrc/conv3_ln_act_general.cu (any C_out; the card checks hold it at
    small widths too) over up to CONV3_MAX_LEVELS levels of CUDA tensors."""
    name = "conv3_ln_act_general"
    C_out, C_in = w.shape[0], xs[0].shape[1]
    bf16 = xs[0].dtype == torch.bfloat16
    head, (bias, ln_w, ln_b), outs, (_m8s, _work, tile) = _conv3_launch_args(
        name, xs, masks, w, bias, ln_w, ln_b, act, conv3_general_tile)
    # the plain (C_out, C_in, 3) weight in f32; the bf16 kernel rounds it to
    # bf16 as the plain version's cast does
    wf = w.float().contiguous()
    entry = (cuda.library().decafnet_conv3_ln_act_general_bf16 if bf16
             else cuda.library().decafnet_conv3_ln_act_general_f32)
    err = entry(*head, cuda.ptr(wf), cuda.ptr(bias), cuda.ptr(ln_w),
                cuda.ptr(ln_b), C_in, C_out, tile, float(eps),
                int(act == "relu"), cuda.stream())
    cuda.check(err, name + ("_bf16" if bf16 else ""))
    if bf16:
        conv3_ln_act.launches_general_bf16 += 1
    else:
        conv3_ln_act.launches_general += 1
    return outs


conv3_ln_act.launches = conv3_ln_act.launches_bf16 = 0
conv3_ln_act.launches_wide = conv3_ln_act.launches_wide_bf16 = 0
conv3_ln_act.launches_passes = conv3_ln_act.launches_passes_bf16 = 0
conv3_ln_act.launches_general = conv3_ln_act.launches_general_bf16 = 0


def qkv_depthwise_ln_torch(x, mask, ws, ln_ws, ln_bs, eps=1e-5):
    """Plain version: for each branch i, ``LN(depthwise_conv3(x * mask))``,
    the JAX ``qkv_depthwise_ln_xla`` composition
    (decafnet_tpu/ops/fused_conv.py:255-292).

    x (B, C, T) f32 or bf16; mask (B, T) bool; ws three (C, 1, 3) depthwise
    kernels, cast to x's dtype (in bf16 the 3-tap sums accumulate in f32 and
    round to bf16); ln_ws/ln_bs three (C,)/(C, 1) affine LN params, applied
    in f32 with f32 statistics. Returns (q, k, v) in x's dtype."""
    xm = x * mask[:, None, :].to(x.dtype)
    C = x.shape[-2]
    return tuple(
        channel_layer_norm(F.conv1d(xm, w.to(x.dtype), padding=1, groups=C),
                           lw, lb, eps)
        for w, lw, lb in zip(ws, ln_ws, ln_bs))


# the widest tile in either dtype: at the served level 0 on an H100, 64 is
# the fastest in f32 and within 1 % of the fastest (128) in bf16, two
# columns per lane (scripts/torch_band_trio_plans.py)
QKV_MAX_TILE = 64
# lanes that share a time column (bf16: a column pair) in
# csrc/qkv_depthwise_ln.cu (its CS)
QKV_LANES = 4


# the widest C the tuned trio kernels take
QKV_MAX_C = 256
# the wide trio kernels of csrc/qkv_depthwise_ln_wide.cu: C up to
# QKV_WIDE_MAX_C, a cluster of up to QKV_WIDE_MAX_CLUSTER blocks of up to
# QKV_WIDE_MAX_THREADS threads. The plan stages at most QKV_WIDE_CHANNELS
# channels a block at once, on the tuned kernel's tiles: at C 512 and 1024,
# 64 rows x T = 2304 on an H100, the fastest of every plan in f32 and within
# 2 % of it in bf16 (scripts/torch_trio_wide_variants.py, PERF.md)
QKV_WIDE_MAX_C = 4096
QKV_WIDE_MAX_CLUSTER = 8
QKV_WIDE_MAX_THREADS = 256
QKV_WIDE_CHANNELS = 128


def qkv_route(C):
    """The kernel a CUDA launch at ``C`` channels takes, in either dtype:
    "tuned" (csrc/qkv_depthwise_ln.cu, which stages all C channels of a
    tile in shared memory and is built for C up to QKV_MAX_C), "wide"
    (csrc/qkv_depthwise_ln_wide.cu, the channels split over a cluster, up to
    QKV_WIDE_MAX_C) or "general" (csrc/qkv_depthwise_ln_general.cu)."""
    if C <= QKV_MAX_C:
        return "tuned"
    return "wide" if C <= QKV_WIDE_MAX_C else "general"


class QkvWidePlan(NamedTuple):
    """A launch plan of the wide trio kernels: blocks per cluster (they
    split the channels, ceil(C / cluster) each), time columns per block,
    channels staged at once (a block's channels, or fewer: the block then
    stages its chunks again from L2 for the outputs) and dynamic shared
    memory bytes of a block."""
    cluster: int
    tile: int
    chunk: int
    smem: int


def qkv_wide_row(dtype, tile):
    """Row stride, in elements, of a staged row of the wide trio kernel
    (csrc/cp_async.cuh: row_stride): ``tile`` columns, 16 bytes of halo room
    each side, padded so the QKV_LANES lanes of a column read distinct
    banks."""
    esz = 2 if dtype == torch.bfloat16 else 4
    per_word, vec = 4 // esz, 16 // esz
    r = tile + 2 * vec
    while (r // per_word) % 32 != 32 // QKV_LANES:
        r += vec
    return r


def qkv_wide_smem(dtype, tile, chunk):
    """Shared memory bytes of a wide trio block (csrc/qkv_depthwise_ln_wide.cu:
    wide_smem): ``chunk`` staged rows, their taps (float4) and LN vectors
    (float2) per branch, the tile's mask columns and the cluster's exchange
    of (mean, M2) per branch and column."""
    esz = 2 if dtype == torch.bfloat16 else 4
    return (esz * chunk * qkv_wide_row(dtype, tile) + (3 * 16 + 3 * 8) * chunk
            + 4 * (tile + 2) + 3 * 8 * tile)


def qkv_wide_plan(C, T, dtype=torch.float32, cluster=None, tile=None, chunk=None):
    """The plan of the wide trio kernel at ``C`` channels and ``T`` columns,
    as a :class:`QkvWidePlan`: ``tile`` the tuned kernel's
    (:func:`qkv_depthwise_ln_plan`); ``cluster`` the fewest blocks (up to
    QKV_WIDE_MAX_CLUSTER) whose share of the channels is at most
    QKV_WIDE_CHANNELS; ``chunk`` the block's share, or QKV_WIDE_CHANNELS
    where that is less (above 1024 channels). Each may be forced (the
    design study does). Raises ValueError outside the kernel's envelope."""
    name = "qkv_depthwise_ln_wide"
    cuda.require(1 <= C <= QKV_WIDE_MAX_C, name,
                 f"C {C}: the wide kernel takes up to {QKV_WIDE_MAX_C}")
    cols = 2 if dtype == torch.bfloat16 else 1   # columns per lane
    per_warp = 32 // QKV_LANES * cols
    tile = tile or qkv_depthwise_ln_plan(T, dtype)
    cluster = cluster or min(QKV_WIDE_MAX_CLUSTER, -(-C // QKV_WIDE_CHANNELS))
    share = -(-C // cluster)
    chunk = chunk or min(share, QKV_WIDE_CHANNELS)
    threads = QKV_LANES * tile // cols
    cuda.require(1 <= cluster <= QKV_WIDE_MAX_CLUSTER
                 and (cluster - 1) * share < C and 1 <= chunk <= share, name,
                 f"cluster {cluster}, chunk {chunk} at C {C}")
    cuda.require(tile % per_warp == 0 and threads <= QKV_WIDE_MAX_THREADS, name,
                 f"tile {tile}")
    smem = qkv_wide_smem(dtype, tile, chunk)
    cuda.require(smem <= SMEM_LIMIT, name,
                 f"tile {tile}, chunk {chunk}: {smem} bytes of shared memory")
    return QkvWidePlan(cluster, tile, chunk, smem)


def qkv_depthwise_ln_plan(T, dtype=torch.float32):
    """Time columns per block of csrc/qkv_depthwise_ln.cu: each block owns
    ``tile`` columns of one batch row, each column's channels (in bf16, each
    pair of adjacent columns') split over QKV_LANES lanes of a warp. ``tile``
    is a multiple of the columns per warp (32 // QKV_LANES in f32, twice that
    in bf16) and of 4, at most QKV_MAX_TILE."""
    per_warp = 32 // QKV_LANES * (2 if dtype == torch.bfloat16 else 1)
    return cuda.time_tile(T, per_warp, QKV_MAX_TILE)


def qkv_depthwise_ln(x, mask, ws, ln_ws, ln_bs, eps=1e-5):
    """Depthwise q/k/v trio: x read once, three depthwise conv3 + channel LN
    outputs (see :func:`qkv_depthwise_ln_torch` for the arguments).

    On CUDA this launches the counterpart of the TPU kernel
    decafnet_tpu/ops/fused_conv.py:_qkv_depthwise_ln_pallas_impl in x's
    dtype: up to QKV_MAX_C channels the tuned kernel of
    csrc/qkv_depthwise_ln.cu, up to QKV_WIDE_MAX_C the wide one of
    csrc/qkv_depthwise_ln_wide.cu, above that the general one of
    csrc/qkv_depthwise_ln_general.cu (:func:`qkv_route`).
    Under autograd the same forward runs inside :class:`_QkvDepthwiseLn`,
    whose backward recomputes through :func:`qkv_depthwise_ln_torch`, as the
    JAX ``custom_vjp`` recomputes through ``qkv_depthwise_ln_xla``
    (decafnet_tpu/ops/fused_conv.py:396-407).

    Time-sharded, the op runs on the block widened by one column of each
    neighbour and crops the three outputs, as :func:`conv3_ln_act` does."""
    shard = seq.active()
    if shard is not None:
        xh, mh = shard.halo(x, mask, left=1, right=1)
        with seq.replicated():
            outs = qkv_depthwise_ln(xh, mh, ws, ln_ws, ln_bs, eps)
        return tuple(seq.crop(o, 1, 1) for o in outs)
    params = (*ws, *ln_ws, *ln_bs)
    if cuda.recording(x, *params):
        return _QkvDepthwiseLn.apply(x, mask, eps, *params)
    return _qkv_depthwise_ln(x, mask, ws, ln_ws, ln_bs, eps)


class _QkvDepthwiseLn(torch.autograd.Function):
    """:func:`qkv_depthwise_ln` with its backward by recompute; the nine
    parameters come flat (``*ws, *ln_ws, *ln_bs``) so autograd tracks each."""

    @staticmethod
    def forward(ctx, x, mask, eps, *params):
        ctx.save_for_backward(x, mask, *params)
        ctx.eps = eps
        return _qkv_depthwise_ln(x, mask, params[0:3], params[3:6],
                                 params[6:9], eps)

    @staticmethod
    def backward(ctx, *grads):
        x, mask, *params = ctx.saved_tensors
        needs = ctx.needs_input_grad
        gx, *gp = cuda.recompute_vjp(
            lambda x_, *p: qkv_depthwise_ln_torch(
                x_, mask, p[0:3], p[3:6], p[6:9], eps=ctx.eps),
            (x, *params), (needs[0], *needs[3:]), grads)
        return (gx, None, None, *gp)


def _qkv_depthwise_ln(x, mask, ws, ln_ws, ln_bs, eps):
    """The forward: the plain version for CPU tensors, the kernel for CUDA
    tensors."""
    if not cuda.use_kernel(x):
        return qkv_depthwise_ln_torch(x, mask, ws, ln_ws, ln_bs, eps=eps)
    _, C, T = x.shape
    route = qkv_route(C)
    if route == "general":
        return launch_qkv_depthwise_ln_general(x, mask, ws, ln_ws, ln_bs, eps)
    if route == "wide":
        return launch_qkv_depthwise_ln_wide(x, mask, ws, ln_ws, ln_bs, eps,
                                            qkv_wide_plan(C, T, x.dtype))
    return launch_qkv_depthwise_ln(x, mask, ws, ln_ws, ln_bs, eps,
                                   qkv_depthwise_ln_plan(T, x.dtype))


def launch_qkv_depthwise_ln(x, mask, ws, ln_ws, ln_bs, eps, tile):
    """Check the arguments and launch the tuned kernel of
    csrc/qkv_depthwise_ln.cu (C up to QKV_MAX_C) on CUDA tensors with
    ``tile`` time columns per block (see :func:`qkv_depthwise_ln_plan`; the
    plan study script passes others)."""
    name = "qkv_depthwise_ln"
    C = x.shape[1]
    cuda.require(C <= QKV_MAX_C, name,
                 f"C {C}: the tuned kernel takes up to {QKV_MAX_C}")
    bf16 = x.dtype == torch.bfloat16
    outs = _launch_trio(name, x, mask, ws, ln_ws, ln_bs, eps, tile)
    if bf16:
        qkv_depthwise_ln.launches_bf16 += 1
    else:
        qkv_depthwise_ln.launches += 1
    return outs


def launch_qkv_depthwise_ln_wide(x, mask, ws, ln_ws, ln_bs, eps, plan):
    """Check the arguments and launch the wide kernel of
    csrc/qkv_depthwise_ln_wide.cu (C up to QKV_WIDE_MAX_C) on CUDA tensors
    with the launch ``plan`` (see :func:`qkv_wide_plan`; the design study
    passes others)."""
    name = "qkv_depthwise_ln_wide"
    C = x.shape[1]
    cuda.require(C <= QKV_WIDE_MAX_C, name,
                 f"C {C}: the wide kernel takes up to {QKV_WIDE_MAX_C}")
    bf16 = x.dtype == torch.bfloat16
    outs = _launch_trio(name, x, mask, ws, ln_ws, ln_bs, eps, plan.cluster,
                        plan.tile, plan.chunk)
    if bf16:
        qkv_depthwise_ln.launches_wide_bf16 += 1
    else:
        qkv_depthwise_ln.launches_wide += 1
    return outs


def launch_qkv_depthwise_ln_general(x, mask, ws, ln_ws, ln_bs, eps):
    """Check the arguments and launch the general kernel of
    csrc/qkv_depthwise_ln_general.cu (any C, no launch plan) on CUDA
    tensors."""
    name = "qkv_depthwise_ln_general"
    bf16 = x.dtype == torch.bfloat16
    outs = _launch_trio(name, x, mask, ws, ln_ws, ln_bs, eps)
    if bf16:
        qkv_depthwise_ln.launches_general_bf16 += 1
    else:
        qkv_depthwise_ln.launches_general += 1
    return outs


def _launch_trio(name, x, mask, ws, ln_ws, ln_bs, eps, *plan):
    """The checks every trio kernel makes, then one launch of the entry
    point of kernel ``name`` in x's dtype with the launch ``plan`` (the
    tuned kernel's tile, the wide one's cluster, tile and chunk, or
    nothing)."""
    B, C, T = x.shape
    params = list(ws) + list(ln_ws) + list(ln_bs)
    cuda.require(x.is_cuda, name, "the kernel takes CUDA tensors")
    cuda.require(len(ws) == len(ln_ws) == len(ln_bs) == 3, name,
                 "three branches")
    bf16 = x.dtype == torch.bfloat16
    cuda.require(x.dtype in KERNEL_DTYPES, name, "f32 or bf16 x")
    p_dtypes = KERNEL_DTYPES if bf16 else (torch.float32,)
    cuda.require(all(t.dtype in p_dtypes and t.device == x.device
                     for t in params), name,
                 "parameters on x's device, f32 (or bf16 for bf16 x)")
    cuda.require(x.is_contiguous(), name, "x must be contiguous")
    cuda.require(all(tuple(w.shape) == (C, 1, 3) for w in ws), name,
                 "depthwise weights must be (C, 1, 3)")
    cuda.require(all(p.numel() == C for p in list(ln_ws) + list(ln_bs)), name,
                 "LN params of C")
    cuda.require(tuple(mask.shape) == (B, T) and mask.dtype == torch.bool
                 and mask.device == x.device,
                 name, "mask must be (B, T) bool on x's device")
    # the kernels read f32 taps and LN params; the bf16 kernels round the
    # taps to bf16, as the plain version's cast does
    flat = [p.reshape(-1).float().contiguous() for p in params]
    outs = [torch.empty((B, C, T), dtype=x.dtype, device=x.device)
            for _ in range(3)]
    m8 = cuda.as_bytes(mask)
    wq, wk, wv, lwq, lwk, lwv, lbq, lbk, lbv = flat
    entry = getattr(cuda.library(),
                    f"decafnet_{name}_{'bf16' if bf16 else 'f32'}")
    err = entry(
        cuda.ptr(x), cuda.ptr(m8), cuda.ptr(wq), cuda.ptr(wk), cuda.ptr(wv),
        cuda.ptr(lwq), cuda.ptr(lbq), cuda.ptr(lwk), cuda.ptr(lbk),
        cuda.ptr(lwv), cuda.ptr(lbv), *map(cuda.ptr, outs), B, C, T,
        float(eps), *plan, cuda.stream())
    cuda.check(err, name + ("_bf16" if bf16 else ""))
    return tuple(outs)


qkv_depthwise_ln.launches = qkv_depthwise_ln.launches_bf16 = 0
qkv_depthwise_ln.launches_wide = qkv_depthwise_ln.launches_wide_bf16 = 0
qkv_depthwise_ln.launches_general = qkv_depthwise_ln.launches_general_bf16 = 0
