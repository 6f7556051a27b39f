"""Synthetic dataset fabrication for tests and smoke runs (port of
decafnet_tpu/data/synthetic.py; the same seed writes the same bytes).

Writes an on-disk dataset in the live layout: the annotation JSON,
per-video .npy features of both streams, and pickled {sentence: ...} dicts
of CLIP token features and CLS embeddings.
"""

from __future__ import annotations

import json
import os

import numpy as np


def make_synthetic_dataset(root, num_videos=4, num_queries=3, clip_range=(80, 200),
                           vid_dim=32, shallow_dim=32, text_dim=24,
                           fps=30.0, clip_size=32, clip_stride=16,
                           splits=("train", "val"), seed=0):
    """Fabricate a dataset under ``root``; returns the paths dict."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    vid_dir = os.path.join(root, "video_features")
    shallow_dir = os.path.join(root, "shallow_features")
    os.makedirs(vid_dir, exist_ok=True)
    os.makedirs(shallow_dir, exist_ok=True)

    anno = {}
    token_dict = {}
    cls_dicts = {s: {} for s in splits}
    for split in splits:
        anno[split] = {}
        for v in range(num_videos):
            vid_id = f"{split}_vid{v:03d}"
            num_clips = int(rng.randint(*clip_range))
            num_frames = (num_clips - 1) * clip_stride + clip_size
            duration = num_frames / fps

            np.save(os.path.join(vid_dir, vid_id + ".npy"),
                    rng.randn(num_clips, vid_dim).astype(np.float32))
            np.save(os.path.join(shallow_dir, vid_id + ".npy"),
                    rng.randn(num_clips, shallow_dim).astype(np.float32))

            annotations = []
            for q in range(num_queries):
                s = float(rng.uniform(0, duration * 0.8))
                e = float(min(duration, s + rng.uniform(1.0, duration * 0.3)))
                sentence = f"query {split} {v} {q}"
                annotations.append({
                    "segment": [s, e],
                    "sentence": sentence,
                    "sentence_id": f"{vid_id}_q{q}",
                })
                ntok = int(rng.randint(4, 12))
                token_dict[sentence] = rng.randn(ntok, text_dim).astype(np.float32)
                cls_dicts[split][sentence] = rng.randn(1, shallow_dim).astype(np.float32)
            anno[split][vid_id] = {
                "fps": fps,
                "num_frames": num_frames,
                "num_clips": num_clips,
                "duration": duration,
                "annotations": annotations,
            }

    anno_file = os.path.join(root, "anno.json")
    with open(anno_file, "w") as f:
        json.dump(anno, f)
    token_fname = os.path.join(root, "clip_tokens.npy")
    np.save(token_fname, token_dict, allow_pickle=True)
    cls_fname = os.path.join(root, "text_cls_{split}.npy")
    for split in splits:
        np.save(os.path.join(root, f"text_cls_{split}.npy"),
                cls_dicts[split], allow_pickle=True)

    return {
        "anno_file": anno_file,
        "vid_feat_dir": vid_dir,
        "shallow_vid_feat_dir": shallow_dir,
        "clip_token_fname": token_fname,
        "text_cls_fname": cls_fname,
    }


def apply_synthetic_cfg(cfg, paths, clip_size=32, clip_stride=16):
    """Point a config at a synthetic dataset (both train and eval trees)."""
    for tree in (cfg.data, cfg.eval.data):
        tree.name = "video_centric_clip_twofeat"
        tree.clip_size = clip_size
        tree.clip_stride = clip_stride
        tree.anno_file = paths["anno_file"]
        tree.vid_feat_dir = paths["vid_feat_dir"]
        tree.shallow_vid_feat_dir = paths["shallow_vid_feat_dir"]
        tree.clip_token_fname = paths["clip_token_fname"]
        tree.text_cls_fname = paths["text_cls_fname"]
        tree.vid_load = "npy"
        tree.shallow_vid_load = "npy"
        tree.shallow_ds = 1
    return cfg
