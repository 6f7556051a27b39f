"""Per-video evaluation records (port of decafnet_tpu/utils/analysis.py,
``EvalResults``): the Evaluator dumps them with ``eval.save_results``."""

from __future__ import annotations

import pickle

import numpy as np

from ..eval.metrics import interval_iou


class EvalResults:
    """Per-video evaluation records: detections + targets in seconds."""

    def __init__(self, tag=""):
        self.tag = tag
        self.videos = []

    def add_video(self, vid_id, targets_sec, detections, losses=None):
        """detections: list per query of {'segments': (k, 2), 'scores': (k,)}."""
        self.videos.append({
            "vid_id": vid_id,
            "targets": np.asarray(targets_sec, np.float64),
            "detections": [
                {"segments": np.asarray(d["segments"], np.float32),
                 "scores": np.asarray(d["scores"], np.float32)}
                for d in detections
            ],
            "losses": losses,
        })

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump({"tag": self.tag, "videos": self.videos}, f)

    @staticmethod
    def load(path):
        """Read a dump this class wrote (pickle: trusted files only)."""
        with open(path, "rb") as f:
            blob = pickle.load(f)
        out = EvalResults(blob.get("tag", ""))
        out.videos = blob["videos"]
        return out

    def top1_ious(self):
        """(gt_length_sec, top1_iou) pairs over all queries."""
        pairs = []
        for v in self.videos:
            for target, det in zip(v["targets"], v["detections"]):
                segs, scores = det["segments"], det["scores"]
                if len(segs) == 0:
                    pairs.append((float(target[1] - target[0]), 0.0))
                    continue
                best = segs[int(np.argmax(scores))]
                pairs.append((
                    float(target[1] - target[0]),
                    float(interval_iou(best[None], target[None])[0])))
        return pairs
