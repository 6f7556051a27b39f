"""Fused masked conv3 + channel LayerNorm + activation, and the depthwise
q/k/v trio (port of decafnet_tpu/ops/fused_conv.py).

Each op has a plain PyTorch version (``*_torch``) and a hand-written CUDA
kernel (csrc/conv3_ln_act.cu, csrc/qkv_depthwise_ln.cu). The public op
takes the plain version for a tensor on the CPU and launches the kernel for
a CUDA tensor; ``.launches`` on the op counts kernel launches. Under
autograd each op's backward recomputes through its plain version (the rule
in ops/cuda.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda
from .masked import channel_layer_norm


def conv3_ln_act_torch(x, mask, w, bias, ln_w, ln_b, act="relu", eps=1e-5):
    """Plain version: ``act(LN_c(conv3(x * mask) + bias) * ln_w + ln_b)``.

    x (B, C_in, T) f32; mask (B, T) bool; w (C_out, C_in, 3); bias (C_out,)
    or None; ln_w/ln_b (C_out,) or (C_out, 1), or None for no affine;
    act 'relu' | 'none'."""
    xm = x * mask[:, None, :].to(x.dtype)
    y = F.conv1d(xm, w.to(x.dtype), None if bias is None else bias.to(x.dtype),
                 padding=1)
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
    kept on the tensor itself against its ``_version`` and storage, so an
    in-place update (``add_``, ``load_state_dict``) or a new ``.data``
    builds a fresh pair. Inference tensors carry no version counter and are
    not cached."""
    stamp = (None if torch.is_inference(w)
             else (w._version, w.data_ptr(), w.device, tuple(w.shape)))
    hit = getattr(w, "_tf32_operands", None)
    if stamp is not None and hit is not None and hit[0] == stamp:
        return hit[1]
    with torch.no_grad():
        ops = tf32_split(conv3_weight_fragments(w.detach()))
    if stamp is not None:
        w._tf32_operands = (stamp, ops)
    return ops


def conv3_ln_act(x, mask, w, bias=None, ln_w=None, ln_b=None, act="relu",
                 eps=1e-5):
    """Fused masked conv3 + channel LN + activation (see
    :func:`conv3_ln_act_torch` for the arguments).

    On CUDA this launches csrc/conv3_ln_act.cu, the counterpart of the TPU
    kernel decafnet_tpu/ops/fused_conv.py:_conv3_ln_act_pallas_impl: the
    products run on the tensor cores in three TF32 passes (f32 accuracy),
    on weight operands built once per weight (:func:`conv3_weight_operands`).

    Under autograd (:func:`cuda.recording`) the same forward runs inside
    :class:`_Conv3LnAct`, whose backward recomputes the forward through
    :func:`conv3_ln_act_torch` and differentiates it: the counterpart of the
    JAX ``custom_vjp``, which recomputes through ``conv3_ln_act_xla``
    (decafnet_tpu/ops/fused_conv.py:209-234). The mask gets no gradient,
    nor does an absent bias or LN affine."""
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
    params = [p for p in (w, bias, ln_w, ln_b) if p is not None]
    cuda.require(all(t.dtype == torch.float32 and t.device == x.device
                     for t in [x] + params), name, "f32 tensors on one device")
    cuda.require(x.is_contiguous(), name, "x must be contiguous")
    cuda.require(tuple(w.shape) == (C_out, C_in, 3), name, f"w shape {w.shape}")
    cuda.require(tuple(mask.shape) == (B, T) and mask.dtype == torch.bool,
                 name, "mask must be (B, T) bool")
    cuda.require(all(p.numel() == C_out for p in (bias, ln_w, ln_b)
                     if p is not None), name, "per-channel params of C_out")
    cuda.require(C_out <= 256, name, "C_out > 256 is not supported")
    cuda.require(act in ("relu", "none"), name, f"act {act!r}")
    w_hi, w_lo = conv3_weight_operands(w)
    vec = lambda p: None if p is None else p.reshape(-1).contiguous()  # noqa: E731
    bias, ln_w, ln_b = vec(bias), vec(ln_w), vec(ln_b)
    m8 = cuda.as_bytes(mask)
    out = torch.empty((B, C_out, T), dtype=torch.float32, device=x.device)
    err = cuda.library().decafnet_conv3_ln_act_f32(
        cuda.ptr(x), cuda.ptr(m8), cuda.ptr(w_hi), cuda.ptr(w_lo),
        cuda.ptr(bias), cuda.ptr(ln_w), cuda.ptr(ln_b), cuda.ptr(out),
        B, C_in, C_out, T, float(eps), int(act == "relu"), cuda.stream())
    cuda.check(err, name)
    conv3_ln_act.launches += 1
    return out


conv3_ln_act.launches = 0


def qkv_depthwise_ln_torch(x, mask, ws, ln_ws, ln_bs, eps=1e-5):
    """Plain version: for each branch i, ``LN(depthwise_conv3(x * mask))``.

    x (B, C, T); mask (B, T) bool; ws three (C, 1, 3) depthwise kernels;
    ln_ws/ln_bs three (C,)/(C, 1) affine LN params. Returns (q, k, v)."""
    xm = x * mask[:, None, :].to(x.dtype)
    C = x.shape[-2]
    return tuple(
        channel_layer_norm(F.conv1d(xm, w.to(x.dtype), padding=1, groups=C),
                           lw, lb, eps)
        for w, lw, lb in zip(ws, ln_ws, ln_bs))


QKV_MAX_TILE = 64
# lanes that share a time column in csrc/qkv_depthwise_ln.cu (its CS)
QKV_LANES = 4


def qkv_depthwise_ln_plan(T):
    """Time columns per block of csrc/qkv_depthwise_ln.cu: each block owns
    ``tile`` columns of one batch row, each column's channels split over
    QKV_LANES lanes of a warp. ``tile`` is a multiple of the columns per
    warp (32 // QKV_LANES) and of 4, at most QKV_MAX_TILE."""
    return cuda.time_tile(T, 32 // QKV_LANES, QKV_MAX_TILE)


def qkv_depthwise_ln(x, mask, ws, ln_ws, ln_bs, eps=1e-5):
    """Depthwise q/k/v trio: x read once, three depthwise conv3 + channel LN
    outputs (see :func:`qkv_depthwise_ln_torch` for the arguments).

    On CUDA this launches csrc/qkv_depthwise_ln.cu, the counterpart of the
    TPU kernel decafnet_tpu/ops/fused_conv.py:_qkv_depthwise_ln_pallas_impl.
    Under autograd the same forward runs inside :class:`_QkvDepthwiseLn`,
    whose backward recomputes through :func:`qkv_depthwise_ln_torch`, as the
    JAX ``custom_vjp`` recomputes through ``qkv_depthwise_ln_xla``
    (decafnet_tpu/ops/fused_conv.py:396-407)."""
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
                                   qkv_depthwise_ln_plan(x.shape[-1]))


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
    cuda.require(all(t.dtype == torch.float32 and t.device == x.device
                     for t in [x] + params), name, "f32 tensors on one device")
    cuda.require(x.is_contiguous(), name, "x must be contiguous")
    cuda.require(all(tuple(w.shape) == (C, 1, 3) for w in ws), name,
                 "depthwise weights must be (C, 1, 3)")
    cuda.require(all(p.numel() == C for p in list(ln_ws) + list(ln_bs)), name,
                 "LN params of C")
    cuda.require(tuple(mask.shape) == (B, T) and mask.dtype == torch.bool
                 and mask.device == x.device,
                 name, "mask must be (B, T) bool on x's device")
    cuda.require(C <= 256, name, "C > 256 is not supported")
    flat = [p.reshape(-1).contiguous() for p in params]
    outs = [torch.empty((B, C, T), dtype=torch.float32, device=x.device)
            for _ in range(3)]
    m8 = cuda.as_bytes(mask)
    wq, wk, wv, lwq, lwk, lwv, lbq, lbk, lbv = flat
    err = cuda.library().decafnet_qkv_depthwise_ln_f32(
        cuda.ptr(x), cuda.ptr(m8), cuda.ptr(wq), cuda.ptr(wk), cuda.ptr(wv),
        cuda.ptr(lwq), cuda.ptr(lbq), cuda.ptr(lwk), cuda.ptr(lbk),
        cuda.ptr(lwv), cuda.ptr(lbv), *map(cuda.ptr, outs), B, C, T,
        float(eps), tile, cuda.stream())
    cuda.check(err, name)
    qkv_depthwise_ln.launches += 1
    return tuple(outs)


qkv_depthwise_ln.launches = 0
