"""Losses (port of decafnet_tpu/train/losses.py).

f32 and mask-aware: losses are computed densely and reduced over a mask, so
padding never changes a sum. Offsets are channel-first (..., 2, N).
"""

from __future__ import annotations

import torch


def _bce_with_logits(inputs, targets):
    """Stable binary cross entropy with logits, reduction 'none'."""
    return (torch.clamp_min(inputs, 0.0) - inputs * targets
            + torch.log1p(torch.exp(-inputs.abs())))


def sigmoid_focal_loss(inputs, targets, alpha=-1.0, gamma=2.0,
                       smoothing=True):
    """Elementwise focal loss. With ``smoothing`` the modulating factor p_t
    uses the (possibly smoothed) float targets; alpha balancing uses the
    hard >= 0.5 mask."""
    inputs = inputs.float()
    targets = targets.float()
    mask = (targets >= 0.5).float()

    p = torch.sigmoid(inputs)
    if smoothing:
        p_t = p * targets + (1.0 - p) * (1.0 - targets)
    else:
        p_t = p * mask + (1.0 - p) * (1.0 - mask)
    loss = _bce_with_logits(inputs, targets) * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * mask + (1.0 - alpha) * (1.0 - mask)) * loss
    return loss


def _masked_sum(loss, valid):
    return torch.where(valid, loss, torch.zeros_like(loss)).sum(dim=-1)


def calc_focal_loss(logits, labels, valid, smoothing=0.2, alpha=0.5):
    """Label-smoothed focal loss (labels*(1-s)+s/2) summed over the valid
    positions of the last axis: one sum per row (the JAX function sums
    everything; ``.sum()`` of the rows is that sum)."""
    labels = labels.float() * (1.0 - smoothing) + smoothing / 2
    loss = sigmoid_focal_loss(logits, labels, alpha=alpha, gamma=2.0,
                              smoothing=True)
    return _masked_sum(loss, valid)


def ctr_iou_terms(input_offsets, target_offsets, eps=1e-8):
    """IoU of center-offset 1D boxes, channel-first (..., 2, N)."""
    lp, rp = input_offsets[..., 0, :], input_offsets[..., 1, :]
    lg, rg = target_offsets[..., 0, :], target_offsets[..., 1, :]
    intsctk = torch.minimum(rp, rg) + torch.minimum(lp, lg)
    unionk = (lp + rp) + (lg + rg) - intsctk
    iouk = intsctk / torch.clamp_min(unionk, eps)
    return iouk, (lp, rp, lg, rg)


def ctr_giou_loss(input_offsets, target_offsets, eps=1e-8):
    """Elementwise GIoU loss; 1 - IoU for 1D center offsets."""
    iouk, _ = ctr_iou_terms(input_offsets.float(), target_offsets.float(), eps)
    return 1.0 - iouk


def ctr_diou_loss(input_offsets, target_offsets, eps=1e-8):
    """Elementwise Distance-IoU loss."""
    iouk, (lp, rp, lg, rg) = ctr_iou_terms(
        input_offsets.float(), target_offsets.float(), eps)
    len_c = torch.maximum(lp, lg) + torch.maximum(rp, rg)
    rho = 0.5 * (rp - lp - rg + lg)
    return 1.0 - iouk + torch.square(rho / torch.clamp_min(len_c, eps))


def calc_iou_loss(pred_offsets, gt_offsets, valid, reg_loss="diou"):
    """Masked sum over the last axis of the IoU regression loss of
    (..., 2, N) offsets; ``valid`` is (..., N). Invalid positions carry a
    safe dummy so padding cannot produce NaNs."""
    valid_cf = valid[..., None, :]
    safe_pred = torch.where(valid_cf, pred_offsets, torch.ones_like(pred_offsets))
    safe_gt = torch.where(valid_cf, gt_offsets, torch.ones_like(gt_offsets))
    if reg_loss == "diou":
        loss = ctr_diou_loss(safe_pred, safe_gt)
    elif reg_loss in ("giou", "iou"):
        loss = ctr_giou_loss(safe_pred, safe_gt)
    else:
        raise ValueError(f"unknown reg loss: {reg_loss}")
    return _masked_sum(loss, valid)


def segment_iou(pred_segs, gt_segs):
    """Interval IoU over the last axis (start, end)."""
    ps, pe = pred_segs[..., 0], pred_segs[..., 1]
    gs, ge = gt_segs[..., 0], gt_segs[..., 1]
    overlap = torch.clamp_min(torch.minimum(pe, ge) - torch.maximum(ps, gs), 0.0)
    return overlap / ((pe - ps) + (ge - gs) - overlap)
