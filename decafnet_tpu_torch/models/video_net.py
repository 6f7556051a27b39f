"""Video FPN backbone (port of decafnet_tpu/models/video_net.py:
VideoTransformer), with optional activation checkpointing of its encoders
(``remat``) for long-sequence training."""

from __future__ import annotations

import functools
import math

import torch
import torch.nn as nn
from torch.utils import checkpoint as ckpt

from ..nn.blocks import LayerNorm, MaskedConv1D, TransformerEncoder
from ..ops.fused_conv import conv3_ln_act
from ..ops.masked import interpolate_linear_1d, sinusoid_encoding


# what a "dots" checkpoint saves: the outputs of matrix products and
# convolutions (the JAX ``dots_saveable`` policy); the rest is recomputed
_DOTS = (torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
         torch.ops.aten.convolution)


def _dots_policy(ctx, op, *args, **kwargs):
    if op.overloadpacket in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


REMAT_CONTEXTS = {
    "nothing": ckpt.noop_context_fn,
    "dots": functools.partial(ckpt.create_selective_checkpoint_contexts,
                              _dots_policy),
}


def replay_generator(generator, state):
    """A new generator on ``generator``'s device, set to ``state``."""
    replay = torch.Generator(device=generator.device)
    replay.set_state(state)
    return replay


def checkpointed(block, x, mask, generator, policy):
    """``block(x, mask, generator=generator)`` under non-reentrant activation
    checkpointing: its activations are recomputed in the backward (all of
    them for policy "nothing"; all but the product and convolution outputs
    for "dots"). The block's dropouts draw from ``generator``, which
    ``preserve_rng_state`` does not cover: the first run draws from it, and
    the recompute from a replay of its state before that run, so the
    recompute draws the same masks and ``generator`` advances as without
    checkpointing."""
    state = None if generator is None else generator.get_state()
    runs = []

    def run(x, mask):
        gen = generator
        if runs and generator is not None:
            gen = replay_generator(generator, state)
        runs.append(1)
        return block(x, mask, generator=gen)

    return ckpt.checkpoint(run, x, mask, use_reentrant=False,
                           context_fn=REMAT_CONTEXTS[policy])


class VideoTransformer(nn.Module):
    """conv embedding -> scaled sinusoid PE -> stem encoders -> branch
    encoders emitting the feature pyramid (stride 2 after the first
    branch). With ``pool_only`` each branch is a depthwise conv3 (stride 2
    after the first) in place of an encoder. With ``remat`` the stem and
    branch encoders run under :func:`checkpointed` in training
    (``remat_policy`` "nothing" or "dots")."""

    def __init__(self, in_dim, embd_dim, max_seq_len, n_heads, mha_win_size,
                 stride=1, arch=(2, 1, 6), use_abs_pe=False, attn_pdrop=0.0,
                 proj_pdrop=0.0, path_pdrop=0.0, pool_only=False, remat=False,
                 remat_policy="nothing"):
        super().__init__()
        assert len(arch) == 3
        assert stride & (stride - 1) == 0
        assert arch[0] >= int(math.log2(max(stride, 1)))
        if remat_policy not in REMAT_CONTEXTS:
            raise ValueError(f"remat_policy={remat_policy!r}: one of "
                             f"{sorted(REMAT_CONTEXTS)}")
        self.max_seq_len, self.use_abs_pe = max_seq_len, use_abs_pe
        self.remat, self.remat_policy = remat, remat_policy
        self.embd_fc = MaskedConv1D(in_dim, embd_dim, 1)
        convs, norms = [], []
        for _ in range(arch[0]):
            convs.append(MaskedConv1D(
                embd_dim, embd_dim, kernel_size=5 if stride > 1 else 3,
                stride=2 if stride > 1 else 1, padding=2 if stride > 1 else 1,
                bias=False))
            norms.append(LayerNorm(embd_dim))
            stride = max(stride // 2, 1)
        self.embd_convs = nn.ModuleList(convs)
        self.embd_norms = nn.ModuleList(norms)
        drops = dict(attn_pdrop=attn_pdrop, proj_pdrop=proj_pdrop,
                     path_pdrop=path_pdrop)
        self.stem = nn.ModuleList(
            TransformerEncoder(embd_dim, stride=1, n_heads=n_heads,
                               window_size=mha_win_size, **drops)
            for _ in range(arch[1]))
        if pool_only:
            self.branch = nn.ModuleList(
                MaskedConv1D(embd_dim, embd_dim, 3, 2 if idx > 0 else 1, 1,
                             groups=embd_dim, bias=False)
                for idx in range(arch[2]))
        else:
            self.branch = nn.ModuleList(
                TransformerEncoder(embd_dim, stride=2 if idx > 0 else 1,
                                   n_heads=n_heads, window_size=mha_win_size,
                                   **drops)
                for idx in range(arch[2]))
        pe = torch.from_numpy(sinusoid_encoding(max_seq_len, embd_dim // 2))
        self.register_buffer("pe", pe / (embd_dim ** 0.5), persistent=False)

    def forward(self, x, mask, pe_interp=None, generator=None):
        """``pe_interp``: optional (lo, hi, w) tensors of shape (t,) or
        (B, t): linear-interpolation plans of the PE table onto the
        reference's padded length (data/batching.py:pe_interp_arrays).
        In training an input longer than the PE table raises."""
        if mask.ndim == 2:
            mask = mask[:, None, :]
        x, _ = self.embd_fc(x, mask)
        for conv, norm in zip(self.embd_convs, self.embd_norms):
            if conv.conv.kernel_size == 3 and conv.stride == 1:
                x = conv3_ln_act(x, mask[:, 0, :], conv.conv.weight,
                                 conv.conv.bias, norm.weight, norm.bias,
                                 act="relu")
            else:
                x, mask = conv(x, mask)
                x = torch.relu(norm(x))

        if self.use_abs_pe:
            t = x.shape[-1]
            pe = self.pe
            if pe_interp is not None:
                lo, hi, w = pe_interp
                if lo.ndim == 2:      # per-row plans -> (B, C, t)
                    pe = (pe[:, lo].permute(1, 0, 2) * (1.0 - w[:, None, :])
                          + pe[:, hi].permute(1, 0, 2) * w[:, None, :])
                else:
                    pe = pe[:, lo] * (1.0 - w[None, :]) + pe[:, hi] * w[None, :]
            elif self.training and t > self.max_seq_len:
                raise ValueError(f"training video of {t} steps is longer than "
                                 f"the PE table ({self.max_seq_len})")
            elif t > self.max_seq_len:
                pe = interpolate_linear_1d(pe, t, align_corners=True)
            x = x + pe[..., :t].to(x.dtype) * mask.to(x.dtype)

        remat = self.remat and self.training and torch.is_grad_enabled()

        def encode(block, x, mask):
            if isinstance(block, MaskedConv1D):      # a pool_only branch
                return block(x, mask)
            if remat:
                return checkpointed(block, x, mask, generator,
                                    self.remat_policy)
            return block(x, mask, generator=generator)

        for block in self.stem:
            x, mask = encode(block, x, mask)
        fpn, fpn_masks = [], []
        for block in self.branch:
            x, mask = encode(block, x, mask)
            fpn.append(x)
            fpn_masks.append(mask)
        return fpn, fpn_masks
