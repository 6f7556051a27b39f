"""Ground-truth assignment of FPN candidate points (port of
decafnet_tpu/train/annotate.py): the whole (B targets x P points)
assignment as one broadcast."""

from __future__ import annotations

import torch


def annotate_points(points_t, targets, center_sampling="radius",
                    center_sampling_radius=1.5):
    """Assign binary labels and regression offsets to candidate points.

    Args:
      points_t: (4, P) float32, rows (coord, reg_min, reg_max, stride).
      targets: (B, 2) float32 ground-truth segments in grid units.

    Returns:
      labels: (B, P) bool, the point lies in the target's center-sampling
        window and its regression range holds the target.
      offsets: (B, 2, P) float32, (distance to start, distance to end) /
        stride, channel-first.
    """
    coords = points_t[0][None]                        # (1, P)
    reg_min = points_t[1][None]
    reg_max = points_t[2][None]
    strides = points_t[3][None]
    t0 = targets[:, 0:1]                              # (B, 1)
    t1 = targets[:, 1:2]

    pt2start = coords - t0                            # (B, P)
    pt2end = t1 - coords
    offsets = torch.stack([pt2start, pt2end], dim=1) / strides[:, None, :]

    if center_sampling == "radius":
        ctr = 0.5 * (t0 + t1)
        radius = strides * center_sampling_radius
        t_min = torch.maximum(ctr - radius, t0)
        t_max = torch.minimum(ctr + radius, t1)
        inside_window = (coords - t_min > 0) & (t_max - coords > 0)
    else:
        inside_window = (pt2start > 0) & (pt2end > 0)

    max_reg_dist = torch.maximum(pt2start, pt2end)
    inside_range = (max_reg_dist >= reg_min) & (max_reg_dist < reg_max)
    return inside_window & inside_range, offsets
