"""EgoVLP-layout space-time ViT, the expert encoder (port of
decafnet_tpu/encode/spacetime_vit.py).

The Frozen-in-Time ``SpaceTimeTransformer`` (divided space-time attention
with a CLS token) as EgoVLP's video tower uses it, plus EgoVLP's linear
``vid_proj`` (here ``proj``). Parameters keep the public key names and
layouts, so a Frozen-in-Time / EgoVLP state dict loads with
``load_state_dict(strict=True)`` after the prefix renames of
:mod:`.import_vit`.

  * tokens are [CLS, frame 0 patches, frame 1 patches, ...]; the positional
    embedding tiles the per-patch table across frames, the temporal
    embedding repeats within a frame; CLS takes positional row 0;
  * each block: temporal attention over frames per patch location (input
    LN ``norm3``), then spatial attention over patches per frame (input LN
    ``norm1``) reading ``x + time_out``, with the Frozen-in-Time residual
    ``x + space_out`` (not ``time_residual + space_out``), then the MLP on
    ``norm2`` (exact GELU);
  * grouped attention splices CLS: the CLS query attends over all tokens,
    and every group's keys and values get the CLS key and value prepended;
    q is scaled before the splice;
  * the output is the final-LN CLS token, projected when ``out_dim`` is set.

Attention is ``softmax(q k^T) v`` through ``torch.matmul``, as the JAX
package computes it outside any Pallas kernel. Eval only: no dropout.

Compute dtype: the ViT computes in its input's dtype, as the JAX module
does (it has no dtype field): bf16 frames run it in bf16 and give a bf16
output. Its f32 parameters are cast to x's dtype at each use
(:func:`ops.params.cast`; the linears round their product before adding
the bias, :func:`.encoder.dense`), the LayerNorms take f32 statistics and
return x's dtype (:func:`.encoder.layer_norm`), the attention logits,
softmax and weighted sum are f32 and rounded to v's dtype, and the CLS
token and the embeddings are cast to x's dtype before they are added.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.params import cast
from .encoder import dense, layer_norm, seeded_init


def _attend(q, k, v):
    """softmax(q k^T) v over the last two axes; ``q`` is pre-scaled. The
    logits are f32 (bf16 q and k are upcast: their products are exact in
    f32), the softmax is f32, and its weights are rounded to v's dtype for
    the second product, which accumulates in f32 and rounds to v's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-2, -1))
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)


class VarAttention(nn.Module):
    """Frozen-in-Time ``VarAttention``: grouped attention with CLS splicing.
    ``group`` is 'space' (patches attend within their frame) or 'time'
    (patches attend across frames at their location)."""

    def __init__(self, dim, heads, group):
        super().__init__()
        self.heads = heads
        self.group = group
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, frames, n):
        B, N, D = x.shape
        assert N == 1 + frames * n, (N, frames, n)
        h = self.heads
        d = D // h
        q, k, v = (t.reshape(B, N, h, d).transpose(1, 2)
                   for t in dense(x, self.qkv).chunk(3, dim=-1))   # (B, h, N, d)
        q = q * d ** -0.5       # every query, CLS included (F-i-T order)

        cls_out = _attend(q[:, :, :1], k, v)                    # (B, h, 1, d)

        def grouped(t):         # patch tokens are frame-major (f, n)
            t = t[:, :, 1:].reshape(B, h, frames, n, d)
            return t.transpose(2, 3) if self.group == "time" else t

        qg, kg, vg = grouped(q), grouped(k), grouped(v)         # (B, h, G, L, d)
        G = qg.shape[2]
        cls_k = k[:, :, None, :1].expand(B, h, G, 1, d)
        cls_v = v[:, :, None, :1].expand(B, h, G, 1, d)
        out = _attend(qg, torch.cat([cls_k, kg], dim=3), torch.cat([cls_v, vg], dim=3))
        if self.group == "time":
            out = out.transpose(2, 3)                           # back to (f, n)
        out = torch.cat([cls_out, out.reshape(B, h, frames * n, d)], dim=2)
        return dense(out.transpose(1, 2).reshape(B, N, D), self.proj)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return dense(F.gelu(dense(x, self.fc1)), self.fc2)


class SpaceTimeBlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio=4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)          # space attention input
        self.attn = VarAttention(dim, heads, "space")
        self.norm3 = nn.LayerNorm(dim)          # time attention input
        self.timeattn = VarAttention(dim, heads, "time")
        self.norm2 = nn.LayerNorm(dim)          # MLP input
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, frames, n):
        time_residual = x + self.timeattn(layer_norm(x, self.norm3), frames, n)
        space_residual = x + self.attn(layer_norm(time_residual, self.norm1), frames, n)
        return space_residual + self.mlp(layer_norm(space_residual, self.norm2))


class Conv2dPatchProj(nn.Module):
    """Conv2d(3, dim, p, stride p) as one product over unfolded patches; the
    weight keeps the conv layout (D, C, p, p)."""

    def __init__(self, dim, patch_size, in_ch=3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, in_ch, patch_size, patch_size))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        """x: (B, N, p*p*C) unfolded patches in pixel order (ph, pw, c); the
        product in x's dtype, rounded before the bias is added."""
        w = cast(self.weight, x.dtype)
        w = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])
        return torch.matmul(x, w) + cast(self.bias, x.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, dim, patch_size, img_size):
        super().__init__()
        self.patch_size = patch_size
        self.img_size = img_size
        self.proj = Conv2dPatchProj(dim, patch_size)

    def forward(self, frames):
        B, Fr, H, W, C = frames.shape
        p = self.patch_size
        assert H == W == self.img_size, (H, W, self.img_size)
        nh = H // p
        x = frames.reshape(B, Fr, nh, p, nh, p, C).permute(0, 1, 2, 4, 3, 5, 6)
        return self.proj(x.reshape(B, Fr * nh * nh, p * p * C))


class SpaceTimeViT(nn.Module):
    """Frozen-in-Time SpaceTimeTransformer with EgoVLP's projection.

    Input (B, F, H, W, 3) channel-last normalized frames; output (B,
    out_dim) in the frames' dtype, the projected CLS feature (the raw one
    when ``out_dim`` is None)."""

    def __init__(self, img_size=224, patch_size=16, dim=768, depth=12,
                 heads=12, frames=4, mlp_ratio=4.0, out_dim=256):
        super().__init__()
        self.frames = frames
        self.n_patches = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + self.n_patches, dim))
        self.temporal_embed = nn.Parameter(torch.zeros(1, frames, dim))
        self.patch_embed = PatchEmbed(dim, patch_size, img_size)
        self.blocks = nn.ModuleList(SpaceTimeBlock(dim, heads, mlp_ratio)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(dim)
        self.proj = nn.Linear(dim, out_dim) if out_dim is not None else None

    def reset_parameters(self, generator):
        """Seeded random weights (:func:`.encoder.seeded_init`)."""
        return seeded_init(self, generator, ("pos_embed", "temporal_embed"))

    def forward(self, frames):
        B, Fr = frames.shape[:2]
        assert Fr == self.frames, (Fr, self.frames)
        n = self.n_patches
        x = self.patch_embed(frames)                              # (B, F*n, D)
        pe, te = cast(self.pos_embed, x.dtype), cast(self.temporal_embed, x.dtype)
        x = torch.cat([cast(self.cls_token, x.dtype).expand(B, -1, -1), x], dim=1)
        tile_pos = pe[:, 1:].repeat(1, Fr, 1)
        tile_time = te.repeat_interleave(n, dim=1)
        x = x + torch.cat([pe[:, :1], tile_pos + tile_time], dim=1)
        for blk in self.blocks:
            x = blk(x, Fr, n)
        x = layer_norm(x, self.norm)[:, 0]
        return dense(x, self.proj) if self.proj is not None else x
