"""Recall@k x IoU@t evaluation metrics (port of
decafnet_tpu/eval/metrics.py), numpy."""

from __future__ import annotations

import numpy as np


def interval_iou(pred, gt):
    """Vectorized interval IoU over the last axis (start, end)."""
    ps, pe = pred[..., 0], pred[..., 1]
    gs, ge = gt[..., 0], gt[..., 1]
    overlap = np.clip(np.minimum(pe, ge) - np.maximum(ps, gs), 0, None)
    union = (pe - ps) + (ge - gs) - overlap
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, overlap / union, 0.0)


class RecallMeter:
    """Accumulates the R@{ranks} x IoU@{threshs} percentage table."""

    def __init__(self, ranks=(1, 5), iou_threshs=(0.3, 0.5)):
        self.ranks = tuple(ranks)
        self.iou_threshs = np.asarray(iou_threshs, np.float64)
        self.reset()

    def reset(self):
        self.counts = np.zeros((len(self.ranks), len(self.iou_threshs)))
        self.text_cnt = 0

    def update(self, segs, scores, target):
        """segs (n, 2) seconds sorted by score desc (n may be 0);
        target (2,) seconds."""
        order = np.argsort(-np.asarray(scores), kind="stable")
        topk = max(self.ranks)
        segs = np.asarray(segs)[order[:topk]]
        target = np.broadcast_to(np.asarray(target, np.float64), segs.shape) \
            if len(segs) else np.zeros((0, 2))
        iou_topk = interval_iou(segs, target) if len(segs) else np.zeros((0,))
        iou_n = np.array([
            iou_topk[:r].max() if len(iou_topk[:r]) > 0 else 0.0
            for r in self.ranks])
        self.counts += iou_n[:, None] >= self.iou_threshs[None]
        self.text_cnt += 1

    def table(self):
        metrics = self.counts / max(self.text_cnt, 1)
        lines = []
        for i, rank in enumerate(self.ranks):
            lines.append("-----")
            for j, thresh in enumerate(self.iou_threshs):
                lines.append(
                    f"Rank@{rank}, IoU@{thresh:.1f}: "
                    f"{metrics[i, j] * 100:.2f}")
        return metrics, "\n".join(lines)
