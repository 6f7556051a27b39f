"""Plain PyTorch forward of DeCafNet's ``iter`` grounder in eval mode: the
benchmark's frozen reference, one query per row, no kernels, no caches,
no batching tricks.

Follows the reference architecture (github.com/ZijiaLewisLu/CVPR2025-DeCafNet,
``libs/modeling``): saliency delegation of the expert stream, the 1x1
projection of the delegated (and, with ``msf``, the sidekick) features, the
text transformer, the cross-attention fusion at level 0, the video FPN
(conv embedding + LN + ReLU, sinusoid PE, encoders whose depthwise q/k/v
convs and LayerNorms feed windowed attention), and the two classification
heads around the TCN refinement plus the regression head. Channel-first
(rows, channels, time) throughout; masks are (rows, 1, time) bool.

``precision`` sets how it computes: "f32" (float32 throughout; the caller
switches TF32 off), "tf32" (each operand of every convolution and matrix
product rounded to TF32's 10-bit mantissa, the rest float32: TF32 tensor
cores) or "fp8" (each such operand, and each activation the model keeps
between operations, scaled per tensor into float8 e4m3 and back; sums,
LayerNorm statistics and softmax in float32, as a bf16 model keeps them).
The last two are the controls of the correctness check.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# queries per block of the dense band in :func:`band_attention`
BAND_BLOCK = 256


def rounder(mode):
    """The operand rounding of a precision (see the module doc)."""
    if mode == "f32":
        return lambda x: x
    if mode == "tf32":
        def tf32(x):
            # round to nearest, ties away from zero, at 10 mantissa bits
            bits = x.float().contiguous().view(torch.int32)
            return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return tf32
    if mode == "fp8":
        def fp8(x):
            scale = x.detach().abs().amax().float().clamp_min(1e-30) / 448.0
            return (x / scale).to(torch.float8_e4m3fn).float() * scale
        return fp8
    raise ValueError(f"precision {mode!r}: f32, tf32 or fp8")


def layer_norm(x, w=None, b=None, eps=1e-5):
    """LayerNorm over the channel axis of (rows, c, t), biased variance."""
    x = x - x.mean(dim=1, keepdim=True)
    x = x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + eps)
    if w is not None:
        x = x * w.reshape(-1, 1) + b.reshape(-1, 1)
    return x


def max_pool(x):
    """Max over windows of 3 at stride 2, -inf beyond the ends."""
    return F.max_pool1d(x, 3, 2, 1)


def masked_max_pool(x, mask):
    """Stride-2 max pool where masked columns take the row's minimum first;
    the result is gated by the pooled mask, which is returned too."""
    mf = mask.float()
    x_min = x.amin(dim=-1, keepdim=True)
    x = max_pool(x * mf + (1.0 - mf) * x_min)
    mf = max_pool(mf)
    return x * mf, mf.bool()


def sinusoid(seq_len, n_freqs):
    """(2 * n_freqs, seq_len): all sines, then all cosines, of t / f for
    f = 10000 ** linspace(0, 1, n_freqs + 1)[:n_freqs]."""
    tics = np.arange(seq_len, dtype=np.float32)
    freqs = (10000.0 ** np.linspace(0, 1, n_freqs + 1,
                                    dtype=np.float32))[:n_freqs]
    x = tics[None, :] / freqs[:, None]
    return np.concatenate([np.sin(x), np.cos(x)], axis=0).astype(np.float32)


def band_attention(rnd, q, k, v, mask, window):
    """Windowed attention of (rows, h, t, d) heads: query i attends the keys
    i - window//2 .. i + window//2 that exist and are valid; masked queries,
    and queries with no valid key, give 0. Computed as a dense band of
    (BAND_BLOCK, BAND_BLOCK + window - 1) scores per block of queries."""
    T = q.shape[2]
    half = window // 2
    out = torch.zeros_like(q)
    for s in range(0, T, BAND_BLOCK):
        e = min(T, s + BAND_BLOCK)
        ks, ke = max(0, s - half), min(T, e + half)
        scores = torch.einsum("bhid,bhjd->bhij", rnd(q[:, :, s:e]),
                              rnd(k[:, :, ks:ke]))
        i = torch.arange(s, e, device=q.device)[:, None]
        j = torch.arange(ks, ke, device=q.device)[None, :]
        allowed = ((j - i).abs() <= half) & mask[:, None, None, ks:ke]
        out[:, :, s:e] = torch.einsum("bhij,bhjd->bhid",
                                      rnd(softmax(scores, allowed)),
                                      rnd(v[:, :, ks:ke]))
    return out * mask[:, None, :, None]


def softmax(scores, allowed):
    """Softmax over the allowed entries of the last axis; a row with none
    allowed gives zeros."""
    scores = scores.masked_fill(~allowed, -float("inf"))
    top = scores.amax(dim=-1, keepdim=True)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    p = torch.exp(scores - top) * allowed
    return p / p.sum(dim=-1, keepdim=True).clamp_min(torch.finfo(p.dtype).tiny)


# where the last kept bin's mean and the first dropped bin's lie within this
# share of the row's largest |bin mean|, rounding decides which is kept
DELEGATION_TIE = 1e-5


def delegation_weights(correl, valid, sn, ratio, alternates=False):
    """Binary per-clip weights (rows, t): the correlation is averaged over
    bins of ``sn`` clips of the valid prefix, the ``int(ratio * nbins)``
    best bins are kept (all when that is 0; ties to the earlier bin), and
    the kept bins are spread back over the valid clips by nearest index
    (computed in float32; an index past the last valid bin keeps none).

    Returns the weights and a dict {row: weights (t,)}: with
    ``alternates``, for each row whose last kept and first dropped bins
    nearly tie (``DELEGATION_TIE``), the weights with those two swapped,
    which another summation order of the same correlation keeps."""
    R, T = correl.shape
    max_bins = -(-T // sn)
    out = torch.zeros(R, T, dtype=torch.float32, device=correl.device)
    alts = {}
    for r in range(R):
        n = int(valid[r].sum())
        nbins = -(-n // sn)
        c = F.pad(correl[r, :n].float(), (0, nbins * sn - n))
        counts = torch.full((nbins,), float(sn), device=correl.device)
        counts[-1] = n - (nbins - 1) * sn
        means = (c.reshape(nbins, sn).sum(dim=1) / counts).cpu()
        order = sorted(range(nbins), key=lambda b: (-float(means[b]), b))
        n_kept = int(ratio * nbins) or nbins
        kept = np.zeros(max_bins, np.float32)
        kept[order[:n_kept]] = 1.0
        src = np.floor(np.arange(n, dtype=np.float32)
                       * (np.float32(nbins) / np.float32(n)))
        src = np.clip(src.astype(np.int64), 0, max_bins - 1)
        out[r, :n] = torch.from_numpy(kept[src]).to(correl.device)
        if alternates and n_kept < nbins:
            last, first = order[n_kept - 1], order[n_kept]
            gap = float(means[last] - means[first])
            if gap <= DELEGATION_TIE * float(means.abs().max()):
                swapped = kept.copy()
                swapped[last], swapped[first] = 0.0, 1.0
                alts[r] = out[r].clone()
                alts[r][:n] = torch.from_numpy(swapped[src]).to(correl.device)
    return out, alts


class Reference:
    """The grounder's forward over a flat dict of weights ``P`` (torch key
    names, see ``weights.param_spec``) and the ``model`` config tree ``m``,
    with its products in ``precision``."""

    def __init__(self, P, m, precision="f32"):
        self.P, self.m = P, m
        self.rnd = rounder(precision)
        self.keep = self.rnd if precision == "fp8" else rounder("f32")

    def conv(self, name, x, stride=1, padding=0, dilation=1, groups=1):
        w, b = self.P[f"{name}.weight"], self.P.get(f"{name}.bias")
        y = F.conv1d(self.rnd(x), self.rnd(w), None, stride, padding,
                     dilation, groups)
        return self.keep(y if b is None else y + b[:, None])

    def ln(self, name, x):
        return self.keep(layer_norm(x, self.P[f"{name}.weight"],
                                    self.P[f"{name}.bias"]))

    def mha(self, name, q, k, v, kv_mask, n_heads, window=0):
        """Multi-head attention: 1x1 projections, q and k each scaled by
        d ** -0.25, windowed (``window`` > 0) or global over the valid
        keys, then the output projection. ``kv_mask`` (rows, t_k)."""
        rnd = self.rnd
        qp = self.conv(f"{name}.query", q)
        kp = self.conv(f"{name}.key", k)
        vp = self.conv(f"{name}.value", v)
        R, C = qp.shape[:2]
        d = C // n_heads
        scale = 1.0 / math.sqrt(math.sqrt(d))

        def heads(x):
            return x.reshape(R, n_heads, d, x.shape[-1]).transpose(2, 3)

        qh, kh, vh = heads(qp) * scale, heads(kp) * scale, heads(vp)
        if window > 0:
            out = band_attention(rnd, qh, kh, vh, kv_mask, window)
        else:
            s = torch.einsum("bhid,bhjd->bhij", rnd(qh), rnd(kh))
            p = softmax(s, kv_mask[:, None, None, :])
            out = torch.einsum("bhij,bhjd->bhid", rnd(p), rnd(vh))
        return self.conv(f"{name}.proj", out.transpose(2, 3).reshape(R, C, -1))

    def ffn(self, name, x):
        return self.conv(f"{name}.proj",
                         self.keep(F.gelu(self.conv(f"{name}.fc", x))))

    def encoder(self, name, x, mask, stride, n_heads, window):
        """Pre-LN encoder: depthwise q/k/v convs + LN (stride 1 or 2; none
        at stride 0) -> self-attention -> FFN, residuals scaled per channel,
        a masked max-pool skip when downsampling."""
        x = x * mask
        skip = masked_max_pool(x, mask)[0] if stride > 1 else x
        h = self.ln(f"{name}.ln_attn", x)
        if stride > 0:
            hm, C = h * mask, h.shape[1]
            q, k, v = (self.ln(f"{name}.attn.{b}_norm", self.conv(
                f"{name}.attn.{b}_conv.conv", hm, stride=stride, padding=1,
                groups=C)) for b in ("q", "k", "v"))
            mask = mask[..., ::stride]
        else:
            q = k = v = h
        h = self.mha(f"{name}.attn.attn", q, k, v, mask[:, 0], n_heads, window)
        x = self.keep(skip * mask + self.P[f"{name}.drop_path_attn.scale"] * h)
        h = self.ffn(f"{name}.ffn", self.ln(f"{name}.ln_ffn", x)) * mask
        return self.keep(x + self.P[f"{name}.drop_path_ffn.scale"] * h), mask

    def decoder(self, name, q, q_mask, kv, kv_mask, n_heads):
        """Cross-attention decoder: a depthwise conv + LN on the queries,
        attention to the text emitting (scale, shift) for the parameter-free
        LN of the video (adaLN), then the FFN."""
        q = q * q_mask
        h = self.ln(f"{name}.ln_xattn_q", q) * q_mask
        h = self.ln(f"{name}.xattn.q_norm", self.conv(
            f"{name}.xattn.q_conv.conv", h, padding=1, groups=h.shape[1]))
        kv = self.ln(f"{name}.ln_xattn_kv", kv)
        h = self.mha(f"{name}.xattn.xattn", h, kv, kv, kv_mask[:, 0], n_heads)
        scale, shift = torch.chunk(h, 2, dim=1)
        q = self.keep(self.keep(layer_norm(q)) * scale + shift)
        h = self.ffn(f"{name}.ffn", self.ln(f"{name}.ln_ffn", q)) * q_mask
        return self.keep(q + self.P[f"{name}.drop_path_ffn.scale"] * h)

    def text_net(self, text, mask):
        tn = self.m["text_net"]
        x = self.conv("text_net.embd_fc.conv", text * mask)
        if tn.get("use_abs_pe", True):
            c, t = x.shape[1], x.shape[2]
            pe = torch.from_numpy(sinusoid(tn["max_seq_len"], c // 2)).to(x)
            pe = pe / math.sqrt(c)
            if t > tn["max_seq_len"]:
                raise ValueError("text longer than its PE table")
            x = self.keep(x + pe[:, :t] * mask)
        if "text_net.bkgd_token" in self.P:
            token = self.P["text_net.bkgd_token"][None].expand(x.shape[0], -1, -1)
            x = torch.cat([token, x], dim=-1)
            mask = torch.cat([mask[..., :1], mask], dim=-1)
        for i in range(tn.get("n_layers", 5)):
            x, mask = self.encoder(f"text_net.transformer.{i}", x, mask, 0,
                                   tn["n_heads"], 0)
        return x, mask

    def video_net(self, x, mask):
        vn = self.m["vid_net"]
        x = self.conv("vid_net.embd_fc.conv", x * mask)
        for i in range(vn["arch"][0]):
            x = self.conv(f"vid_net.embd_convs.{i}.conv", x * mask, padding=1)
            x = torch.relu(self.ln(f"vid_net.embd_norms.{i}", x))
        if vn.get("use_abs_pe", False):
            c, t = x.shape[1], x.shape[2]
            if t > vn["max_seq_len"]:
                raise ValueError("the reference pads no video past the PE "
                                 "table")
            pe = torch.from_numpy(sinusoid(vn["max_seq_len"], c // 2)).to(x)
            x = self.keep(x + pe[:, :t] / math.sqrt(c) * mask)
        for i in range(vn["arch"][1]):
            x, mask = self.encoder(f"vid_net.stem.{i}", x, mask, 1,
                                   vn["n_heads"], vn["mha_win_size"])
        fpn, masks = [], []
        for i in range(vn["arch"][2]):
            x, mask = self.encoder(f"vid_net.branch.{i}", x, mask,
                                   2 if i > 0 else 1, vn["n_heads"],
                                   vn["mha_win_size"])
            fpn.append(x)
            masks.append(mask)
        return fpn, masks

    def head_trunk(self, name, fpn, masks):
        n = self.m["cls_head" if name != "reg_head" else "reg_head"].get(
            "n_layers", 2)
        out = []
        for x, mask in zip(fpn, masks):
            for i in range(n):
                x = self.conv(f"{name}.convs.{i}.conv", x * mask, padding=1)
                x = torch.relu(self.ln(f"{name}.norms.{i}", x))
            out.append(x)
        return out

    def cls_head(self, name, fpn, masks):
        feats = self.head_trunk(name, fpn, masks)
        return [self.conv(f"{name}.cls_head.conv", x * mask, padding=1)[:, 0]
                for x, mask in zip(feats, masks)]

    def tcn(self, x, mask):
        out = self.conv("refine.conv_1x1", x)
        for i in range(self.m["vid_net"]["arch"][2]):
            d = 2 ** i
            h = self.conv(f"refine.layers.{i}.conv_dilated", out, padding=d,
                          dilation=d)
            h = self.conv(f"refine.layers.{i}.conv_1x1", torch.relu(h))
            out = self.ln(f"refine.layers.{i}.norm", (out + h) * mask)
        return self.conv("refine.conv_out", out) * mask

    def delegation(self, shallow, vid_mask, text_cls, alternates=False):
        """The rows' delegation weights (:func:`delegation_weights`) from
        the saliency correlation of shallow (R, Cs, T) and text_cls (R, Cs)."""
        m = self.m
        correl = torch.einsum("rct,rc->rt", self.rnd(shallow),
                              self.rnd(text_cls))
        return delegation_weights(correl, vid_mask, m.get("sn", 60),
                                  m.get("sratio", 0.0), alternates)

    def forward(self, vid, shallow, vid_mask, text, text_mask, text_cls,
                w=None):
        """One row per query: vid (R, Cv, T), shallow (R, Cs, T), vid_mask
        (R, T) bool, text (R, Ct, L), text_mask (R, L) bool, text_cls
        (R, Cs); ``w`` (R, T) the delegation weights (default: computed).
        Returns per FPN level the cls_head2 logits (R, T_l), the offsets
        (R, 2, T_l) and the masks (R, T_l)."""
        m = self.m
        mask = vid_mask[:, None, :]
        w = self.delegation(shallow, vid_mask, text_cls)[0] if w is None else w
        x = vid * w[:, None, :]
        if m.get("msf", False):
            x = torch.cat([x, shallow], dim=1)
        else:
            mask = mask & (w[:, None, :] > 0)
        x = self.conv("vid_map.conv", x * mask)

        t, t_mask = self.text_net(text, text_mask[:, None, :])
        for i in range(m["fusion"].get("n_layers", 2)):
            x = self.decoder(f"fusion.layers.{i}", x, mask, t, t_mask,
                             m["fusion"].get("n_heads", 4))
        x = self.ln("fusion.ln_out", x)

        fpn, masks = self.video_net(x, mask)
        logits = self.cls_head("cls_head", fpn, masks)
        T0 = logits[0].shape[1]
        m0 = masks[0][:, 0].float()
        stacked = torch.stack(
            [logits[0]] + [torch.repeat_interleave(l, T0 // l.shape[1], -1) * m0
                           for l in logits[1:]], dim=1)
        refined = self.tcn(stacked, masks[0])
        new_fpn = []
        for i, f in enumerate(fpn):
            if i:
                refined = masked_max_pool(refined, masks[i - 1])[0]
            new_fpn.append(torch.cat([f, refined], dim=1))
        logits2 = self.cls_head("cls_head2", new_fpn, masks)
        feats = self.head_trunk("reg_head", new_fpn, masks)
        offsets = [torch.relu(self.P[f"reg_head.scales.{i}.scale"] * self.conv(
            "reg_head.reg_head.conv", x * mask, padding=1))
            for i, (x, mask) in enumerate(zip(feats, masks))]
        return logits2, offsets, [mk[:, 0] for mk in masks]
