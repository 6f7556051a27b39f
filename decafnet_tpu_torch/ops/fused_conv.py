"""Fused masked conv3 + channel LayerNorm + activation, and the depthwise
q/k/v trio (port of decafnet_tpu/ops/fused_conv.py).

Each op has a plain PyTorch version (``*_torch``) and hand-written CUDA
kernels (csrc/conv3_ln_act.cu, csrc/qkv_depthwise_ln.cu), one for f32 and
one for bf16 activations. The public op takes the plain version for a
tensor on the CPU and launches the kernel of the input's dtype for a CUDA
tensor; ``.launches`` on the op counts launches of the f32 kernel,
``.launches_bf16`` of the bf16 one. Under autograd each op's backward
recomputes through its plain version (the rule in ops/cuda.py).
"""

from __future__ import annotations

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


def conv3_weight_fragments(w):
    """The (C_out, C_in, 3) conv weight as csrc/conv3_ln_act.cu reads it:
    (ceil(C_in/8), 3, M/16, 32, 4) with M = C_out padded to a multiple of 32,
    zero where padded. For input-channel chunk c8, tap, m16 tile mt and lane
    (g = lane // 4, q = lane % 4), entry 2k + h is
    ``w[16 mt + g + 8 h, 8 c8 + q + 4 k, tap]``: the A fragment of
    ``mma.sync.m16n8k8`` (rows = output channels, k = input channels)."""
    C_out, C_in, _ = w.shape
    mt, nc8 = 2 * -(-C_out // 32), -(-C_in // 8)
    wp = w.new_zeros(16 * mt, 8 * nc8, 3, dtype=torch.float32)
    wp[:C_out, :C_in] = w
    # (mt, h, g, c8, k, q, tap) -> (c8, tap, mt, g, q, k, h)
    return (wp.view(mt, 2, 8, nc8, 2, 4, 3).permute(3, 6, 0, 2, 5, 4, 1)
            .reshape(nc8, 3, mt, 32, 4).contiguous())


def conv3_weight_operands(w):
    """``tf32_split(conv3_weight_fragments(w))``, built once per weight and
    kept on the tensor itself against its ``_version`` and storage
    (:func:`ops.params.cached`), so an in-place update (``add_``,
    ``load_state_dict``) or a new ``.data`` builds a fresh pair. Inference
    tensors carry no version counter and are not cached."""
    return cached(w, "tf32_operands",
                  lambda w: tf32_split(conv3_weight_fragments(w)))


def conv3_bf16_fragments(w):
    """The (C_out, C_in, 3) conv weight rounded to bf16 as the bf16 kernel of
    csrc/conv3_ln_act.cu reads it: (ceil(C_in/16), 3, M/16, 32, 8) with M =
    C_out padded to a multiple of 32, zero where padded. For input-channel
    chunk c16, tap, m16 tile mt and lane (g = lane // 4, q = lane % 4),
    entry 4 kh + 2 h + j is ``w[16 mt + g + 8 h, 16 c16 + 8 kh + 2 q + j,
    tap]``: the A fragment of ``mma.sync.m16n8k16`` (rows = output
    channels, k = input channels), four registers of two bf16 each."""
    C_out, C_in, _ = w.shape
    mt, nc16 = 2 * -(-C_out // 32), -(-C_in // 16)
    wp = w.new_zeros(16 * mt, 16 * nc16, 3, dtype=torch.bfloat16)
    wp[:C_out, :C_in] = w
    # (mt, h, g, c16, kh, q, j, tap) -> (c16, tap, mt, g, q, kh, h, j)
    return (wp.view(mt, 2, 8, nc16, 2, 4, 2, 3)
            .permute(3, 7, 0, 2, 5, 4, 1, 6)
            .reshape(nc16, 3, mt, 32, 8).contiguous())


def conv3_bf16_operands(w):
    """:func:`conv3_bf16_fragments` of ``w``, cached against its version as
    :func:`conv3_weight_operands` is."""
    return cached(w, "bf16_fragments", conv3_bf16_fragments)


def conv3_ln_act(x, mask, w, bias=None, ln_w=None, ln_b=None, act="relu",
                 eps=1e-5):
    """Fused masked conv3 + channel LN + activation (see
    :func:`conv3_ln_act_torch` for the arguments).

    On CUDA this launches csrc/conv3_ln_act.cu, the counterpart of the TPU
    kernel decafnet_tpu/ops/fused_conv.py:_conv3_ln_act_pallas_impl. For f32
    x the products run on the tensor cores in three TF32 passes (f32
    accuracy), on weight operands built once per weight
    (:func:`conv3_weight_operands`); for bf16 x in one bf16 pass with f32
    accumulation (:func:`conv3_bf16_operands`), the function of the bf16
    plain version. The output has x's dtype.

    Under autograd (:func:`cuda.recording`) the same forward runs inside
    :class:`_Conv3LnAct`, whose backward recomputes the forward through
    :func:`conv3_ln_act_torch` and differentiates it: the counterpart of the
    JAX ``custom_vjp``, which recomputes through ``conv3_ln_act_xla``
    (decafnet_tpu/ops/fused_conv.py:209-234). The mask gets no gradient,
    nor does an absent bias or LN affine.

    Time-sharded (:func:`parallel.seq.active`), the op runs on this rank's
    block widened by one column of each neighbour (x and mask, zeros and
    False past the video's ends) and crops the result back to the block."""
    shard = seq.active()
    if shard is not None:
        xh, mh = shard.halo(x, mask, left=1, right=1)
        with seq.replicated():
            y = conv3_ln_act(xh, mh, w, bias, ln_w, ln_b, act, eps)
        return seq.crop(y, 1, 1)
    if cuda.recording(x, w, bias, ln_w, ln_b):
        return _Conv3LnAct.apply(x, mask, w, bias, ln_w, ln_b, act, eps)
    return _conv3_ln_act(x, mask, w, bias, ln_w, ln_b, act, eps)


class _Conv3LnAct(torch.autograd.Function):
    """:func:`conv3_ln_act` with its backward by recompute."""

    @staticmethod
    def forward(ctx, x, mask, w, bias, ln_w, ln_b, act, eps):
        ctx.save_for_backward(x, mask, w, bias, ln_w, ln_b)
        ctx.options = (act, eps)
        return _conv3_ln_act(x, mask, w, bias, ln_w, ln_b, act, eps)

    @staticmethod
    def backward(ctx, grad):
        act, eps = ctx.options
        return cuda.recompute_vjp(
            lambda *a: conv3_ln_act_torch(*a, act=act, eps=eps),
            ctx.saved_tensors, ctx.needs_input_grad[:6], (grad,)) + (None, None)


def _conv3_ln_act(x, mask, w, bias, ln_w, ln_b, act, eps):
    """The forward: the plain version for CPU tensors, the kernel for CUDA
    tensors."""
    if not cuda.use_kernel(x):
        return conv3_ln_act_torch(x, mask, w, bias, ln_w, ln_b, act=act, eps=eps)
    name = "conv3_ln_act"
    B, C_in, T = x.shape
    C_out = w.shape[0]
    bf16 = x.dtype == torch.bfloat16
    cuda.require(x.dtype in KERNEL_DTYPES, name, "f32 or bf16 x")
    p_dtypes = KERNEL_DTYPES if bf16 else (torch.float32,)
    cuda.require(all(t.dtype in p_dtypes and t.device == x.device
                     for t in (w, bias, ln_w, ln_b) if t is not None), name,
                 "parameters on x's device, f32 (or bf16 for bf16 x)")
    cuda.require(x.is_contiguous(), name, "x must be contiguous")
    cuda.require(tuple(w.shape) == (C_out, C_in, 3), name, f"w shape {w.shape}")
    cuda.require(tuple(mask.shape) == (B, T) and mask.dtype == torch.bool,
                 name, "mask must be (B, T) bool")
    cuda.require(all(p.numel() == C_out for p in (bias, ln_w, ln_b)
                     if p is not None), name, "per-channel params of C_out")
    cuda.require(C_out <= 256, name, "C_out > 256 is not supported")
    cuda.require(act in ("relu", "none"), name, f"act {act!r}")
    vec = lambda p: None if p is None else p.reshape(-1).float().contiguous()  # noqa: E731
    bias, ln_w, ln_b = vec(bias), vec(ln_w), vec(ln_b)
    m8 = cuda.as_bytes(mask)
    out = torch.empty((B, C_out, T), dtype=x.dtype, device=x.device)
    if bf16:
        err = cuda.library().decafnet_conv3_ln_act_bf16(
            cuda.ptr(x), cuda.ptr(m8), cuda.ptr(conv3_bf16_operands(w)),
            cuda.ptr(bias), cuda.ptr(ln_w), cuda.ptr(ln_b), cuda.ptr(out),
            B, C_in, C_out, T, float(eps), int(act == "relu"), cuda.stream())
        cuda.check(err, name + "_bf16")
        conv3_ln_act.launches_bf16 += 1
        return out
    w_hi, w_lo = conv3_weight_operands(w)
    err = cuda.library().decafnet_conv3_ln_act_f32(
        cuda.ptr(x), cuda.ptr(m8), cuda.ptr(w_hi), cuda.ptr(w_lo),
        cuda.ptr(bias), cuda.ptr(ln_w), cuda.ptr(ln_b), cuda.ptr(out),
        B, C_in, C_out, T, float(eps), int(act == "relu"), cuda.stream())
    cuda.check(err, name)
    conv3_ln_act.launches += 1
    return out


conv3_ln_act.launches = conv3_ln_act.launches_bf16 = 0


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

    On CUDA this launches csrc/qkv_depthwise_ln.cu (its f32 or bf16 kernel,
    after x's dtype), the counterpart of the TPU kernel
    decafnet_tpu/ops/fused_conv.py:_qkv_depthwise_ln_pallas_impl.
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
    return launch_qkv_depthwise_ln(x, mask, ws, ln_ws, ln_bs, eps,
                                   qkv_depthwise_ln_plan(x.shape[-1], x.dtype))


def launch_qkv_depthwise_ln(x, mask, ws, ln_ws, ln_bs, eps, tile):
    """Check the arguments and launch csrc/qkv_depthwise_ln.cu on CUDA
    tensors with ``tile`` time columns per block (see
    :func:`qkv_depthwise_ln_plan`; the plan study script passes others)."""
    name = "qkv_depthwise_ln"
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
    cuda.require(C <= 256, name, "C > 256 is not supported")
    # the kernels read f32 taps and LN params; the bf16 kernel rounds the
    # taps to bf16, as the plain version's cast does
    flat = [p.reshape(-1).float().contiguous() for p in params]
    outs = [torch.empty((B, C, T), dtype=x.dtype, device=x.device)
            for _ in range(3)]
    m8 = cuda.as_bytes(mask)
    wq, wk, wv, lwq, lwk, lwv, lbq, lbk, lbv = flat
    entry = (cuda.library().decafnet_qkv_depthwise_ln_bf16 if bf16
             else cuda.library().decafnet_qkv_depthwise_ln_f32)
    err = entry(
        cuda.ptr(x), cuda.ptr(m8), cuda.ptr(wq), cuda.ptr(wk), cuda.ptr(wv),
        cuda.ptr(lwq), cuda.ptr(lbq), cuda.ptr(lwk), cuda.ptr(lbk),
        cuda.ptr(lwv), cuda.ptr(lbv), *map(cuda.ptr, outs), B, C, T,
        float(eps), tile, cuda.stream())
    cuda.check(err, name + ("_bf16" if bf16 else ""))
    if bf16:
        qkv_depthwise_ln.launches_bf16 += 1
    else:
        qkv_depthwise_ln.launches += 1
    return tuple(outs)


qkv_depthwise_ln.launches = qkv_depthwise_ln.launches_bf16 = 0
