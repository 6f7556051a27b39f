"""Factorized clip encoder and its runner (port of
decafnet_tpu/encode/encoder.py): the sidekick that encodes every clip, and
the runner that encodes a video's clips on its device.

``ClipEncoder`` is a divided space-time transformer over patch tokens:
temporal attention per patch location, spatial attention per frame, an
MLP, then the mean over frames and patches and a linear head. Its parts
carry flax's defaults: LayerNorm eps 1e-6 and the tanh approximation of
GELU (the expert ``SpaceTimeViT`` uses torch's eps 1e-5 and exact GELU).
Parameter names are the flax module names, so a flax params tree loads by
transposing Dense kernels and renaming LayerNorm ``scale``
(:func:`.import_vit.clip_encoder_params_to_state_dict`).

Compute dtype: ``ClipEncoder(dtype=torch.bfloat16)`` rounds where the flax
module with ``dtype=jnp.bfloat16`` rounds (decafnet_tpu/encode/encoder.py):
parameters stay f32 and are cast at each use (:func:`ops.params.cast`);
each Dense rounds its product to bf16 before adding the bf16 bias; the
embedding sum is f32 and then rounded, so the residual stream is bf16; the
LayerNorms take f32 statistics and emit bf16, but the final ``norm`` has no
dtype in flax and emits f32; attention logits and softmax are f32, the
weights rounded to v's dtype for the second product; the mean is f32, the
head a bf16 Dense, the output f32. The helpers :func:`dense` and
:func:`layer_norm` serve the expert ViT too.
"""

from __future__ import annotations

import inspect
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.params import cast

FLAX_LN_EPS = 1e-6

# the compute dtypes an encoder takes (None: f32), by the names the JAX
# options and the port use
ENCODER_DTYPES = {None: None, "float32": None, torch.float32: None,
                  np.float32: None, "bfloat16": torch.bfloat16,
                  "bf16": torch.bfloat16, torch.bfloat16: torch.bfloat16}


def dense(x, layer):
    """``layer`` (an ``nn.Linear``) applied in x's dtype, as flax's Dense with
    a ``dtype`` and the JAX ViT's ``TorchLinear`` apply theirs: the f32
    parameters cast to x's dtype, and below f32 the product rounded to x's
    dtype before the bias is added (two XLA ops)."""
    if x.dtype == torch.float32:
        return F.linear(x, layer.weight, layer.bias)
    return F.linear(x, cast(layer.weight, x.dtype)) + cast(layer.bias, x.dtype)


def layer_norm(x, norm, dtype=None):
    """``norm`` (an ``nn.LayerNorm``) with f32 statistics and f32 affine,
    the result in ``dtype`` (default x's dtype): flax's LayerNorm and the JAX
    ViT's ``TorchLayerNorm`` compute in f32 whatever x's dtype."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                     norm.eps)
    return y.to(dtype or x.dtype)


@torch.no_grad()
def seeded_init(model, generator, embeddings):
    """Seeded random weights with the JAX package's initializers: LeCun
    normal products (fan-in over all but the output axis), zero biases and
    CLS token, N(0, 0.02) for the parameters named in ``embeddings``,
    LayerNorm weights 1. Returns ``model``."""
    for name, p in model.named_parameters():
        if name in embeddings:
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        elif p.dim() > 1:
            p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(p[0].numel()))
        elif name.endswith("weight"):                       # LayerNorm
            p.fill_(1.0)
        else:
            p.zero_()
    return model


class MHA(nn.Module):
    """Self-attention over axis -2 of (..., n, dim)."""

    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        h = self.heads
        d = x.shape[-1] // h
        q, k, v = (t.unflatten(-1, (h, d)).transpose(-2, -3)
                   for t in dense(x, self.qkv).chunk(3, dim=-1))
        # f32 logits of bf16 q and k (their products are exact in f32)
        logits = torch.matmul(q.float(), k.float().transpose(-2, -1)) / math.sqrt(d)
        out = torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)
        return dense(out.transpose(-2, -3).flatten(-2), self.proj)


class Block(nn.Module):
    """One divided space-time block over (B, F, N, dim): temporal attention
    (over frames, per patch location), spatial attention (over patches, per
    frame), MLP."""

    def __init__(self, dim, heads, mlp_ratio=4.0):
        super().__init__()
        self.norm_t = nn.LayerNorm(dim, eps=FLAX_LN_EPS)
        self.attn_t = MHA(dim, heads)
        self.norm_s = nn.LayerNorm(dim, eps=FLAX_LN_EPS)
        self.attn_s = MHA(dim, heads)
        self.norm_m = nn.LayerNorm(dim, eps=FLAX_LN_EPS)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        x = x + self.attn_t(layer_norm(x, self.norm_t).transpose(1, 2)).transpose(1, 2)
        x = x + self.attn_s(layer_norm(x, self.norm_s))
        y = F.gelu(dense(layer_norm(x, self.norm_m), self.fc1), approximate="tanh")
        return x + dense(y, self.fc2)


class ClipEncoder(nn.Module):
    """Frames of one clip -> one feature vector: (B, F, H, W, 3) normalized
    frames in, (B, out_dim) f32 out. The patch and frame counts follow the
    input (``frames`` and ``img_size`` size the embeddings). ``dtype`` is the
    compute dtype (None: f32, or ``torch.bfloat16``; see the module
    docstring); the output is f32 either way."""

    def __init__(self, patch_size=16, dim=384, depth=6, heads=6, out_dim=256,
                 frames=4, img_size=224, dtype=None):
        super().__init__()
        if dtype not in ENCODER_DTYPES:
            raise ValueError(f"dtype={dtype!r}: the port's encoders compute in "
                             f"float32 or bfloat16 (bf16)")
        self.dtype = ENCODER_DTYPES[dtype]
        self.patch_size = patch_size
        self.depth = depth
        n = (img_size // patch_size) ** 2
        self.patch_embed = nn.Linear(patch_size * patch_size * 3, dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, 1, n, dim))
        self.time_embed = nn.Parameter(torch.zeros(1, frames, 1, dim))
        for i in range(depth):
            self.add_module(f"block{i}", Block(dim, heads))
        self.norm = nn.LayerNorm(dim, eps=FLAX_LN_EPS)
        self.head = nn.Linear(dim, out_dim)

    def reset_parameters(self, generator):
        return seeded_init(self, generator, ("pos_embed", "time_embed"))

    def forward(self, frames):
        B, Fr, H, W, C = frames.shape
        p = self.patch_size
        assert H % p == 0 and W % p == 0, (H, W, p)
        nh, nw = H // p, W // p
        # flax's Dense without a dtype computes in the promoted input dtype
        dt = self.dtype or torch.promote_types(frames.dtype, torch.float32)
        x = frames.reshape(B, Fr, nh, p, nw, p, C).permute(0, 1, 2, 4, 3, 5, 6)
        x = dense(x.reshape(B, Fr, nh * nw, p * p * C).to(dt), self.patch_embed)
        x = (x.float() + self.pos_embed + self.time_embed).to(dt)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        x = layer_norm(x, self.norm, torch.float32).mean(dim=(1, 2))  # frame + patch pooling
        return dense(x.to(dt), self.head).float()


def make_clip_encoder(opt):
    """``ClipEncoder`` from an options dict (keys it does not take are
    ignored, as the JAX factory does). ``dtype`` is f32 (None, "float32") or
    bf16 ("bfloat16", "bf16", ``torch.bfloat16``); any other raises."""
    fields = set(inspect.signature(ClipEncoder).parameters)
    return ClipEncoder(**{k: v for k, v in opt.items() if k in fields})


class ClipEncoderRunner:
    """Encodes a video's clips on the device of ``encoder`` (an eval-mode
    module holding its weights), at most ``max_clips`` clips per forward so
    that a long video's activations fit; clips are independent, so the cap
    changes no feature. 128 clips of the full-width expert ViT (785 tokens,
    MLP width 3072) take ~1.2 GB per MLP activation in f32, whatever the
    video's length (32768 clips at MAD scale are 256 forwards); frames may
    stay on the host, and move to the device a forward's worth at a time."""

    def __init__(self, encoder, max_clips=128):
        self.encoder = encoder.eval()
        self.max_clips = max_clips
        self.device = next(encoder.parameters()).device

    @torch.no_grad()
    def encode(self, frames):
        """(T, F, H, W, 3) float tensor on any device -> (out_dim, T) on the
        runner's device, in the encoder's output dtype for the frames' dtype
        (as the JAX runner passes its array through): f32 from a
        ``ClipEncoder``, bf16 from a ``SpaceTimeViT`` given bf16 frames."""
        feats = [self.encoder(frames[i:i + self.max_clips].to(self.device))
                 for i in range(0, frames.shape[0], self.max_clips)]
        return torch.cat(feats).T.contiguous()

    def __call__(self, frames):
        """(T, F, H, W, 3) numpy frames -> (out_dim, T) f32 numpy features."""
        feats = self.encode(torch.from_numpy(np.asarray(frames, np.float32)))
        return feats.cpu().numpy()


def encode_video(expert_runner, sidekick_runner, frames, sidekick_frames=None):
    """The two-stream encode stage: the sidekick sees every clip, the expert
    output feeds delegation downstream. Returns (expert, sidekick) (C, T)
    numpy arrays."""
    expert = expert_runner(frames)
    sidekick = sidekick_runner(frames if sidekick_frames is None else sidekick_frames)
    return expert, sidekick
