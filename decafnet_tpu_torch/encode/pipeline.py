"""Delegated encoding (port of decafnet_tpu/encode/pipeline.py): the
sidekick encodes every clip, the saliency of its features against the query
selects the top-``ratio`` bins, and the expert encodes only the selected
clips, scattered back into a dense stream gated by the delegation weight,
as the reference gates its precomputed expert features.

The JAX package gathers and scatters with one-hot matmuls (no index
gathers on the TPU); here they are ``index_select`` and ``index_copy_`` on
the device.
"""

from __future__ import annotations

import torch

from ..ops.delegation import delegation_weights, saliency_correlation


def expert_budget(T, sn, ratio):
    """Upper bound of the clips delegation can select: kept bins x bin size
    (``int(ratio * nbins) == 0`` keeps every bin)."""
    nbins = -(-T // sn)
    kept = int(ratio * nbins) or nbins
    return min(kept * sn, T)


def select_salient_clips(sidekick_feats, text_cls, sn, ratio, k, normalize=False):
    """Salient clip indices from sidekick features.

    Args:
      sidekick_feats: (C, T) tensor; text_cls: (C,) query CLS embedding.
      sn, ratio: delegation bin size and keep fraction.
      k: the expert clip budget (:func:`expert_budget`, at least the number
        of selected clips).

    Returns:
      idx (k,) int64 unique clip indices: every selected clip in order,
      then the lowest-index unselected clips as filler (zeroed downstream
      by the weight); weight (T,) f32 binary delegation weight.
    """
    T = sidekick_feats.shape[-1]
    correl = saliency_correlation(sidekick_feats[None], text_cls[None],
                                  normalize=normalize)
    mask = torch.ones(1, T, dtype=torch.bool, device=correl.device)
    weight = delegation_weights(correl, mask, sn, ratio)[0]
    # selected first, then by index: the JAX sort key, in f32
    ar = torch.arange(T, device=weight.device)
    order = torch.argsort(-weight * 2.0 - (T - ar) / (T + 1.0), stable=True)
    return order[:k], weight


def gather_clips(frames, idx, dtype=None):
    """frames[idx] along the clip axis, on the frames' device, in ``dtype``
    (default the frames' dtype; e.g. ``torch.bfloat16`` for a bf16
    encoder). A one-hot selection picks each value exactly, so the JAX
    one-hot product in ``dtype`` gives the same array."""
    return frames.index_select(0, idx.to(frames.device)).to(dtype or frames.dtype)


def delegated_encode(expert_runner, idx, weight, frames):
    """Expert-encode only the clips ``idx`` of ``frames`` (T, F, H, W, 3)
    and scatter them into the dense, weight-gated (out_dim, T) f32 stream on
    the runner's device. ``idx`` must be unique. A bf16 expert output enters
    the f32 stream exactly, as numpy's promotion of the JAX runner's bf16
    array by the f32 one-hot scatter gives it."""
    feats_k = expert_runner.encode(gather_clips(frames, idx))    # (C, k)
    weight = weight.to(feats_k.device)
    dense = torch.zeros(feats_k.shape[0], weight.shape[0], device=feats_k.device)
    dense.index_copy_(1, idx.to(feats_k.device), feats_k.float())
    return dense * weight[None, :]


def encode_delegate_ground(expert_runner, sidekick_runner, frames,
                           sidekick_frames, text_cls, sn, ratio, normalize=False):
    """The on-device DeCafNet front end: sidekick-encode every clip, select
    the salient bins for ``text_cls`` (C,), expert-encode only those clips.
    Returns (expert (C, T) gated dense, sidekick (C, T), weight (T,)) on the
    runners' device, ready for the grounder's ``msf`` path."""
    sidekick = sidekick_runner.encode(sidekick_frames)
    T = sidekick.shape[-1]
    k = expert_budget(T, sn, ratio)
    idx, weight = select_salient_clips(sidekick, text_cls.to(sidekick.device),
                                       sn, ratio, k, normalize=normalize)
    expert = delegated_encode(expert_runner, idx, weight, frames)
    return expert, sidekick, weight
