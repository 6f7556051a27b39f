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
"""

from __future__ import annotations

import inspect
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FLAX_LN_EPS = 1e-6


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
                   for t in self.qkv(x).chunk(3, dim=-1))
        logits = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(d)
        out = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.proj(out.transpose(-2, -3).flatten(-2))


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
        x = x + self.attn_t(self.norm_t(x).transpose(1, 2)).transpose(1, 2)
        x = x + self.attn_s(self.norm_s(x))
        y = F.gelu(self.fc1(self.norm_m(x)), approximate="tanh")
        return x + self.fc2(y)


class ClipEncoder(nn.Module):
    """Frames of one clip -> one feature vector: (B, F, H, W, 3) normalized
    frames in, (B, out_dim) f32 out. The patch and frame counts follow the
    input (``frames`` and ``img_size`` size the embeddings)."""

    def __init__(self, patch_size=16, dim=384, depth=6, heads=6, out_dim=256,
                 frames=4, img_size=224):
        super().__init__()
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
        x = frames.reshape(B, Fr, nh, p, nw, p, C).permute(0, 1, 2, 4, 3, 5, 6)
        x = self.patch_embed(x.reshape(B, Fr, nh * nw, p * p * C))
        x = x + self.pos_embed + self.time_embed
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        x = self.norm(x).mean(dim=(1, 2))               # frame + patch pooling
        return self.head(x).float()


def make_clip_encoder(opt):
    """``ClipEncoder`` from an options dict (keys it does not take are
    ignored, as the JAX factory does). The port computes in f32: a bf16
    ``dtype`` raises (ROADMAP item 12)."""
    dtype = opt.get("dtype")
    if dtype not in (None, "float32", torch.float32, np.float32):
        raise ValueError(f"dtype={dtype!r}: the port's encoders compute in "
                         f"f32; a bf16 mode is ROADMAP item 12")
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
        """(T, F, H, W, 3) float tensor on any device -> (out_dim, T) f32 on
        the runner's device."""
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
