"""Saliency-based top-c% delegation, batched (port of
decafnet_tpu/ops/delegation.py).

Per (video, query) row: the sidekick/query-CLS correlation is averaged into
bins of ``sn`` clips over the valid prefix, the top ``int(ratio * nbins)``
bins are kept, and the binary bin weights are nearest-upsampled back to the
clip grid.
"""

from __future__ import annotations

import torch

from ..parallel import seq


def saliency_correlation(shallow_vid, text_cls, normalize=False):
    """corr[b, t] = shallow_vid[b, :, t] . text_cls[b, :], optionally with
    both sides L2-normalized with a +1e-4 denominator offset."""
    if normalize:
        shallow_vid = shallow_vid / (
            torch.linalg.norm(shallow_vid, dim=1, keepdim=True) + 1e-4)
        text_cls = text_cls / (
            torch.linalg.norm(text_cls, dim=1, keepdim=True) + 1e-4)
    return torch.einsum("bht,bh->bt", shallow_vid.float(), text_cls.float())


def delegation_weights(correl, vid_masks, sn, ratio):
    """Binary per-clip delegation weights (B, T) f32 in {0, 1}, zero beyond
    the valid prefix. ``vid_masks`` (B, T) bool is a prefix per row.

    Three rules carried from the JAX function: ``int(ratio * nbins)`` comes
    from an f64 table; ``k == 0`` keeps every bin; bins rank by a stable
    sort, so ties go to the earlier bin.

    Time-sharded (:func:`parallel.seq.active`), the bins straddle the
    ranks' blocks: every rank gathers the global correlation and mask,
    ranks the bins as one process does, and keeps its block of the weights
    (which carry no gradient)."""
    shard = seq.active()
    if shard is not None:
        correl, vid_masks = shard.gather(correl.detach(), vid_masks)
        with seq.replicated():
            return shard.shard(delegation_weights(correl, vid_masks, sn, ratio))
    B, T = correl.shape
    dev = correl.device
    max_bins = -(-T // sn)
    correl = correl.float()
    valid = vid_masks.float()
    n_valid = torch.sum(valid, dim=-1).to(torch.int32)

    onehot = torch.zeros(T, max_bins, device=dev)
    ar = torch.arange(T, device=dev)
    onehot[ar, ar // sn] = 1.0
    bin_sum = (correl * valid) @ onehot
    bin_cnt = valid @ onehot
    bin_valid = bin_cnt > 0
    bin_mean = bin_sum / torch.clamp_min(bin_cnt, 1.0)

    nbins = torch.sum(bin_valid, dim=-1)
    k_table = torch.tensor([int(ratio * n) for n in range(max_bins + 1)],
                           dtype=torch.int64, device=dev)
    k_keep = k_table[nbins]
    k_keep = torch.where(k_keep == 0, nbins, k_keep)

    scores = torch.where(bin_valid, bin_mean,
                         torch.full_like(bin_mean, -float("inf")))
    order = torch.argsort(-scores, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    selected = (ranks < k_keep[:, None]) & bin_valid

    pos = torch.arange(T, dtype=torch.float32, device=dev)[None, :]
    scale = nbins.float() / torch.clamp_min(n_valid.float(), 1.0)
    src = torch.floor(pos * scale[:, None]).long().clamp(0, max_bins - 1)
    weight = torch.gather(selected.float(), -1, src)
    return weight * valid


def delegate(vid, shallow_vid, vid_masks, text_cls, sn, ratio,
             normalize=False, msf=False, scat=False, sfonly=False):
    """Gate the expert stream by the delegation weights; without ``msf``
    gated-out positions also leave the mask; with ``msf`` the sidekick
    stream is concatenated (or substituted when ``sfonly``); ``scat``
    appends the correlation as one channel. Returns (vid, vid_masks,
    correl)."""
    correl = saliency_correlation(shallow_vid, text_cls, normalize=normalize)
    weight = delegation_weights(correl, vid_masks, sn, ratio)
    vid = vid * weight[:, None, :].to(vid.dtype)
    if not msf:
        vid_masks = (weight > 0) & vid_masks
    elif sfonly:
        vid = shallow_vid
    else:
        vid = torch.cat([vid, shallow_vid], dim=1)
    if scat:
        vid = torch.cat([vid, correl[:, None, :].to(vid.dtype)], dim=1)
    return vid, vid_masks, correl
