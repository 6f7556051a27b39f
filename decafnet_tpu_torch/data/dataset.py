"""Host-side data pipeline: annotation parsing, feature loading,
video-centric query grouping, random-crop truncation (port of
decafnet_tpu/data/dataset.py; the same seeds give the same samples).

Samples are dicts of numpy arrays. Grouping for all epochs is precomputed
at init from an explicit seeded RNG, so every process builds the identical
sample list, and per-sample randomness is keyed by (seed, epoch, index).
"""

from __future__ import annotations

import json
import math
import os
import pickle
import random as _random
import time
from collections import OrderedDict

import numpy as np
import torch


def _load_npy(path, _):
    return np.load(path + ".npy").astype(np.float32)


def _load_pk(path, n):
    with open(path + ".pk", "rb") as f:
        return np.asarray(pickle.load(f)[n], np.float32)


def _load_pk_avg(path, _):
    with open(path + ".pk", "rb") as f:
        v_align, v_distill = pickle.load(f)[:2]
    return (np.asarray(v_align, np.float32)
            + np.asarray(v_distill, np.float32)) / 2


def _load_pt(path, _):
    return torch.load(path + ".pt", map_location="cpu").numpy().astype(np.float32)


def parse_ego4d_files(ego4d_anno, ego4d_meta):
    """Map ego4d clip_uid -> {video_uid, video_start_sec, video_end_sec,
    height, width} from the raw NLQ annotation + metadata JSONs."""
    with open(ego4d_meta, "r") as f:
        metadata = json.load(f)
    v2meta = {v["video_uid"]: v["video_metadata"] for v in metadata["videos"]}

    with open(ego4d_anno, "r") as f:
        anno = json.load(f)

    clip_info = {}
    for v in anno["videos"]:
        for clip in v["clips"]:
            d = {k: clip[k] for k in ("video_start_sec", "video_end_sec")}
            d["video_uid"] = v["video_uid"]
            if v["video_uid"].startswith("grp"):
                h, w = 1440, 1920
            else:
                meta = v2meta[v["video_uid"]]
                h = meta["display_resolution_height"]
                w = meta["display_resolution_width"]
            d["height"], d["width"] = h, w
            clip_info[clip["clip_uid"]] = d
    return clip_info


def _load_full_pt(path, dataset):
    """Ego4D features stored one .pt per parent video uid: remap the clip
    uid to its video and slice the clip's window on the 30 fps clip grid."""
    clip_uid = os.path.basename(path)
    feat_dir = os.path.dirname(path)
    info = dataset.video_info_for_mv[clip_uid]
    feature = torch.load(
        os.path.join(feat_dir, info["video_uid"] + ".pt"),
        map_location="cpu").numpy().astype(np.float32)
    clip_stride = dataset.opt["clip_stride"]
    div = lambda x: int(x * 30 // clip_stride)  # noqa: E731
    start = max(0, div(info["video_start_sec"]))
    end = min(div(info["video_end_sec"]), feature.shape[0] + 1)
    return feature[start:end]


VID_LOAD_FUNC = {
    "npy": _load_npy,
    "pk0": lambda p, d: _load_pk(p, 0),
    "pk1": lambda p, d: _load_pk(p, 1),
    "pk_avg": _load_pk_avg,
    "pt": _load_pt,
    "full_pt": _load_full_pt,
}


class BaseDataset:
    """Parses the annotation JSON and loads per-video / per-sentence feature
    files.

    Annotation schema: {split: {vid_id: {fps, num_frames, duration,
    num_clips?, annotations: [{segment: [s, e], sentence, sentence_id?}]}}}.
    """

    def __init__(self, opt, split, is_training, num_epochs=1, rng=None):
        data = opt
        if isinstance(split, str) and "," in split:
            split = split.split(",")
        if not isinstance(split, (list, tuple)):
            split = (split,)
        self.split = tuple(split)
        self.is_training = is_training
        self.num_epochs = num_epochs
        self.epoch = 0
        self.opt = data
        self.rng = rng or np.random.RandomState(2022)
        self.pyrng = _random.Random(int(self.rng.randint(0, 2 ** 31)))
        self.item_seed = int(self.rng.randint(0, 2 ** 31))

        vid_dirs = data["vid_feat_dir"]
        if not isinstance(vid_dirs, (list, tuple)):
            vid_dirs = (vid_dirs,)
        self.vid_feat_dir = vid_dirs
        self.text_feat_dir = data.get("text_feat_dir")
        self.ext_score_dir = data.get("ext_score_dir")
        from .tokenizer import make_tokenizer
        self.tokenizer = make_tokenizer(data.get("tokenizer"))

        self.clip_size = data["clip_size"]
        self.downsample_rate = int(data.get("downsample_rate", 1) or 1)
        self.clip_stride = data["clip_stride"] * self.downsample_rate
        self.to_fixed_len = bool(data.get("to_fixed_len", False))

        self.max_vid_len = data["max_vid_len"]
        self.max_text_len = data["max_text_len"]
        self.crop_ratio = data.get("crop_ratio")
        self.trunc_thresh = data.get("trunc_thresh", 0.5)
        self.max_num_text = data.get("max_num_text") or 1
        self.group_method = data.get("group_method", "greedy")

        self.normalize_vid = bool(data.get("normalize_vid", False))
        self.normalize_text = bool(data.get("normalize_text", False))
        self.normalize_scores = bool(data.get("normalize_scores", True))
        self.temperature = float(data.get("temperature", 1.0))

        self.vid_dict = self._parse_annotations(data["anno_file"])
        self.vid_feat_cache = {}
        self.text_feat_cache = {}
        self._video_info_for_mv = None

    @property
    def video_info_for_mv(self):
        """clip_uid -> parent-video window info for the ``full_pt`` loader,
        built lazily from the raw ego4d annotation + metadata files."""
        if self._video_info_for_mv is None:
            info = {}
            for split in self.split:
                if split == "train" and self.opt.get("ego4d_train_anno"):
                    info.update(parse_ego4d_files(
                        self.opt["ego4d_train_anno"],
                        self.opt["ego4d_metadata"]))
                if split == "val" and self.opt.get("ego4d_val_anno"):
                    info.update(parse_ego4d_files(
                        self.opt["ego4d_val_anno"],
                        self.opt["ego4d_metadata"]))
            self._video_info_for_mv = info
        return self._video_info_for_mv

    # -- annotations --------------------------------------------------------

    def _parse_annotations(self, anno_file):
        with open(anno_file, "r") as f:
            anno = json.load(f)
        anno_db = {}
        for s in self.split:
            if s not in anno:
                raise KeyError(f"split [{s}] does not exist in {anno_file}")
            anno_db.update(anno[s])

        vid_dict = OrderedDict()
        for key, value in anno_db.items():
            if "annotations" not in value:
                continue
            fps = float(value["fps"])
            num_frames = int(value["num_frames"])
            duration = float(value.get("duration", num_frames / fps))
            if "num_clips" in value:
                ds = self.downsample_rate
                num_clips = (value["num_clips"] + ds - 1) // ds
            else:
                num_clips = None

            text_ids, segments, sentences = [], [], []
            for s, pair in enumerate(value["annotations"]):
                start = max(float(pair["segment"][0]), 0.0)
                end = min(float(pair["segment"][1]), duration)
                if end - start <= 0:
                    continue
                text_ids.append(pair.get("sentence_id", f"{key}_{s:04d}"))
                segments.append((start, end))
                sentences.append(pair["sentence"].strip())
            if not text_ids:
                continue
            vid_dict[key] = {
                "fps": fps,
                "num_frames": num_frames,
                "num_clips": num_clips,
                "duration": duration,
                "text_ids": tuple(text_ids),
                "sentences": tuple(sentences),
                "segments": np.asarray(segments, np.float64),
            }
        return vid_dict

    # -- feature loading ----------------------------------------------------

    def _load_stream(self, vid_id, dirs, load_name, ds, cache):
        """Load (and cache) one feature stream as (c, t) float32; several
        dirs are concatenated channel-wise, the shorter ones padded by
        repeating their last frame (at most 10 frames)."""
        if vid_id in cache:
            return cache[vid_id]
        loader = VID_LOAD_FUNC[load_name]
        # networked feature stores drop reads under load: 10 tries
        for i in range(10):
            try:
                feats = [loader(os.path.join(d, vid_id), self) for d in dirs]
                break
            except Exception:  # noqa: BLE001 -- the last try re-raises
                if i == 9:
                    raise
                time.sleep(0.05 * (i + 1))
        if len(feats) > 1:
            lens = [len(x) for x in feats]
            max_len, min_len = max(lens), min(lens)
            if max_len - min_len > 10:
                raise ValueError(f"misaligned features (max {max_len}, min "
                                 f"{min_len}) for video {vid_id}")
            for i in range(len(feats)):
                if lens[i] < max_len:
                    pad = np.tile(feats[i][-1], (max_len - lens[i], 1))
                    feats[i] = np.concatenate([feats[i], pad])
            feats = np.concatenate(feats, axis=-1)
        else:
            feats = feats[0]
        if ds > 1:
            feats = feats[::ds]
        feats = np.ascontiguousarray(feats.T)  # (c, t)
        if self.normalize_vid:
            feats = feats / np.maximum(
                np.linalg.norm(feats, axis=0, keepdims=True), 1e-12)
        cache[vid_id] = feats
        return feats

    def _load_vid_feats(self, vid_id):
        return self._load_stream(vid_id, self.vid_feat_dir,
                                 self.opt.get("vid_load", "npy"),
                                 self.downsample_rate, self.vid_feat_cache)

    def _load_text_feats(self, text_id, sentence=None):
        if text_id in self.text_feat_cache:
            return self.text_feat_cache[text_id]
        if self.tokenizer is not None and self.text_feat_dir is None:
            feats = self.tokenizer(sentence)
        else:
            path = os.path.join(self.text_feat_dir, str(text_id) + ".npy")
            feats = np.load(path).astype(np.float32).T  # (c, t)
        if self.is_training:
            feats = feats[:, :self.max_text_len]
        if self.normalize_text:
            feats = feats / np.maximum(
                np.linalg.norm(feats, axis=0, keepdims=True), 1e-12)
        self.text_feat_cache[text_id] = feats
        return feats

    def _load_ext_scores(self, text_id):
        """(1, t) external scores with optional sigmoid normalization."""
        path = os.path.join(self.ext_score_dir, str(text_id) + ".npy")
        scores = np.load(path).astype(np.float32)
        if self.downsample_rate > 1:
            scores = scores[::self.downsample_rate]
        scores = scores[None]
        if self.normalize_scores:
            scores = 1.0 / (1.0 + np.exp(-scores / self.temperature))
        return scores

    # -- truncation ---------------------------------------------------------

    def _truncate_vid_feats(self, feats, segments, offset, num_trials=5000,
                            rng=None):
        """Random crop window keeping >= trunc_thresh of every segment.
        Returns (feats, segments, window); window is None if untruncated.
        ``rng`` replaces the shared sequential stream (per-sample keyed
        randomness, see ``__getitem__``)."""
        rng = rng or self.pyrng
        vid_len = feats.shape[1]
        max_vid_len = self.max_vid_len
        if vid_len <= max_vid_len:
            if self.crop_ratio is None:
                return feats, segments, None
            max_vid_len = rng.randint(
                max(int(math.ceil(self.crop_ratio[0] * vid_len)), 1),
                min(int(math.ceil(self.crop_ratio[1] * vid_len)), vid_len))
            if max_vid_len == vid_len:
                return feats, segments, None

        s0 = max(0, int(np.floor(segments[:, 0].max() - max_vid_len)))
        s1 = min(vid_len - max_vid_len, int(np.ceil(segments[:, 1].min())))
        s1 = max(s0, s1)

        seg_lens = np.clip(segments[:, 1] - segments[:, 0], 1e-5, None)
        if seg_lens.max() > (self.max_vid_len / self.trunc_thresh):
            trunc_thresh = 0.2
        else:
            trunc_thresh = self.trunc_thresh

        for _ in range(num_trials):
            ws = rng.randint(s0, s1)
            we = ws + max_vid_len
            start = np.clip(segments[:, 0], ws - offset, None)
            end = np.clip(segments[:, 1], None, we + offset)
            overlap = np.clip(end - start, 0, None)
            if np.all(overlap / seg_lens > trunc_thresh):
                feats = feats[:, ws:we]
                segments = np.clip(segments - ws, -offset,
                                   we - ws + offset)
                return feats, segments, (ws, we)
        raise ValueError("no valid truncation found")

    def _avgpool_to_fixed_len(self, feats, size):
        """Linear resize to size*r then average-pool r (fixed-length
        datasets such as MAD)."""
        from ..ops.masked import interpolate_linear_1d

        vid_len = feats.shape[1]
        r = int(math.ceil(vid_len / size))
        x = interpolate_linear_1d(torch.from_numpy(np.asarray(feats))[None],
                                  size * r, align_corners=False)
        if r > 1:
            x = x.reshape(1, feats.shape[0], size, r).mean(-1)
        return x[0].numpy()

    def set_epoch(self, epoch):
        self.epoch = epoch


class VideoCentricDataset(BaseDataset):
    """A training sample = (video, <= max_num_text of its queries); an eval
    sample = (video, all its queries). Grouping for all epochs is
    precomputed."""

    def __init__(self, opt, split, is_training, num_epochs=1, rng=None):
        super().__init__(opt, split, is_training, num_epochs, rng)
        if is_training:
            self.data_list = self._build_train_samples()
        else:
            if num_epochs != 1:
                raise ValueError("an eval dataset has one epoch")
            self.data_list = self._build_eval_samples()

        self.text_cls_dict = {}
        if opt.get("text_cls_fname"):
            for split_name in self.split:
                fname = opt["text_cls_fname"].format(split=split_name)
                self.text_cls_dict.update(
                    np.load(fname, allow_pickle=True).item())

    def _build_train_samples(self):
        samples = []
        for _ in range(self.num_epochs):
            for vid_id in self.vid_dict:
                samples.extend(self._group(vid_id))
        samples = samples[:len(samples) // self.num_epochs * self.num_epochs]
        return tuple(samples)

    def _build_eval_samples(self):
        return tuple(
            (vid_id, tuple(range(len(info["segments"]))))
            for vid_id, info in self.vid_dict.items())

    def _group(self, vid_id):
        if self.to_fixed_len:
            return self._group_with_fixed_len(vid_id)
        return self._group_with_max_len(vid_id)

    def _group_with_fixed_len(self, vid_id):
        info = self.vid_dict[vid_id]
        idx = list(range(len(info["segments"])))
        if self.group_method in ("random", "all"):
            return [(vid_id, tuple(idx))]
        self.pyrng.shuffle(idx)
        return [(vid_id, tuple(idx[i:i + self.max_num_text]))
                for i in range(0, len(idx), self.max_num_text)]

    def _group_with_max_len(self, vid_id):
        """Greedy window covering: take the earliest uncovered segment,
        cover it with the widest feasible crop window, group up to
        max_num_text covered queries; repeat."""
        info = self.vid_dict[vid_id]
        if info["num_clips"] is not None and info["num_clips"] <= self.max_vid_len:
            win_len = info["num_clips"]
            if self.crop_ratio is not None:
                win_len = max(math.ceil(self.crop_ratio[0] * win_len), 1)
        else:
            win_len = self.max_vid_len
        win_len = (self.clip_stride * (win_len - 1) + self.clip_size) / info["fps"]

        sort_idx = np.argsort(info["segments"][:, 0])
        segments = info["segments"][sort_idx]
        mask = np.ones(len(segments), bool)

        samples = []
        while mask.sum() > 0:
            ptr = np.nonzero(mask)[0].min()
            ws = segments[ptr, 0]
            we = ws + win_len
            if segments[ptr, 1] - segments[ptr, 0] > win_len:
                idx = np.array([ptr])
            else:
                inside = (segments[:, 0] >= ws) & (segments[:, 1] <= we) & mask
                idx = np.nonzero(inside)[0]
                if len(idx) > self.max_num_text:
                    idx = self.rng.choice(idx, self.max_num_text,
                                          replace=False)
            samples.append((vid_id, tuple(int(i) for i in sort_idx[idx])))
            mask[idx] = False
        return samples

    def __len__(self):
        return len(self.data_list) // self.num_epochs

    def _load_text_cls_feats(self, vid_id, seg_idx):
        info = self.vid_dict[vid_id]
        rows = [self.text_cls_dict[info["sentences"][i]] for i in seg_idx]
        return np.concatenate(rows, axis=0).astype(np.float32)  # (n, c)

    def _get_streams(self, vid_id):
        """Expert-only default; overridden by the two-feature datasets."""
        vid = self._load_vid_feats(vid_id)
        return vid, vid

    def __getitem__(self, idx):
        vid_id, seg_idx = self.data_list[self.epoch * len(self) + idx]
        info = self.vid_dict[vid_id]

        vid_feats, shallow_feats = self._get_streams(vid_id)
        vid_len = min(vid_feats.shape[1], shallow_feats.shape[1])
        vid_feats = vid_feats[:, :vid_len]
        shallow_feats = shallow_feats[:, :vid_len]

        clip_size, clip_stride = self.clip_size, self.clip_stride
        if self.to_fixed_len:
            vid_feats = self._avgpool_to_fixed_len(vid_feats, self.max_vid_len)
            shallow_feats = self._avgpool_to_fixed_len(
                shallow_feats, self.max_vid_len)
            clip_size = clip_stride = float(
                ((vid_len - 1) * clip_stride + clip_size) / self.max_vid_len)
        clip_offset = 0.5 * clip_size / clip_stride

        # timestamps -> temporal grid, centered on clip middles
        segments = np.clip(
            info["segments"][np.asarray(seg_idx)] * info["fps"],
            0, info["num_frames"]) / clip_stride - clip_offset
        segments = segments.astype(np.float32)

        if self.is_training:
            # per-sample randomness keyed by (seed, epoch, index): every
            # process derives the same crop for the same global sample
            item_rng = _random.Random(
                f"{self.item_seed}-{self.epoch}-{int(idx)}")
            if not self.to_fixed_len:
                vid_feats, segments, window = self._truncate_vid_feats(
                    vid_feats, segments, clip_offset, rng=item_rng)
                if window is not None:
                    shallow_feats = shallow_feats[:, window[0]:window[1]]
            if self.group_method == "random" and len(seg_idx) > self.max_num_text:
                seg_idx = tuple(item_rng.sample(seg_idx, self.max_num_text))
                segments = segments[list(seg_idx)]

        text_feats_list = tuple(
            self._load_text_feats(info["text_ids"][i], info["sentences"][i])
            for i in seg_idx)
        text_cls = self._load_text_cls_feats(vid_id, seg_idx)

        ext_scores = None
        if not self.is_training and self.ext_score_dir is not None:
            rows = []
            for i in seg_idx:
                s = self._load_ext_scores(info["text_ids"][i])
                if self.to_fixed_len:
                    s = self._avgpool_to_fixed_len(s, self.max_vid_len)
                rows.append(s)
            ext_scores = np.concatenate(rows)

        return {
            "fps": info["fps"],
            "num_frames": info["num_frames"],
            "duration": info["duration"],
            "segment": info["segments"],
            "clip_size": clip_size,
            "clip_stride": clip_stride,
            "target": segments,             # (n, 2) grid units
            "clip_id": vid_id,
            "text_id": seg_idx,
            "vid": vid_feats,               # (c, t)
            "shallow_vid": shallow_feats,   # (c_s, t)
            "text": text_feats_list,        # tuple of (c_t, l)
            "text_cls": text_cls,           # (n, c_s)
            "ext_scores": ext_scores,       # (n, t) or None
        }


class VideoCentricCLIPDataset(VideoCentricDataset):
    """Token features come from one pickled {sentence: tokens} dict."""

    def __init__(self, opt, split, is_training, num_epochs=1, rng=None):
        super().__init__(opt, split, is_training, num_epochs, rng)
        self.raw_text_feat_dict = np.load(
            opt["clip_token_fname"], allow_pickle=True).item()

    def _load_text_feats(self, text_id, sentence=None):
        if text_id in self.text_feat_cache:
            return self.text_feat_cache[text_id]
        feats = np.ascontiguousarray(
            self.raw_text_feat_dict[sentence].T).astype(np.float32)
        if self.is_training:
            feats = feats[:, :self.max_text_len]
        if self.normalize_text:
            feats = feats / np.maximum(
                np.linalg.norm(feats, axis=0, keepdims=True), 1e-12)
        self.text_feat_cache[text_id] = feats
        return feats


class _TwoFeatMixin:
    """Adds the sidekick feature stream with its own loader and stride."""

    def _init_shallow(self, opt):
        dirs = opt["shallow_vid_feat_dir"]
        if not isinstance(dirs, (list, tuple)):
            dirs = (dirs,)
        self.shallow_vid_feat_dir = dirs
        self.shallow_vid_feat_cache = {}

    def _get_streams(self, vid_id):
        vid = self._load_vid_feats(vid_id)
        shallow = self._load_stream(
            vid_id, self.shallow_vid_feat_dir,
            self.opt.get("shallow_vid_load", "npy"),
            int(self.opt.get("shallow_ds") or 1),
            self.shallow_vid_feat_cache)
        return vid, shallow


class VideoCentricCLIPTwoFeatDataset(_TwoFeatMixin, VideoCentricCLIPDataset):
    """The live dataset: CLIP token features + a second (sidekick) feature
    stream."""

    def __init__(self, opt, split, is_training, num_epochs=1, rng=None):
        super().__init__(opt, split, is_training, num_epochs, rng)
        self._init_shallow(opt)


class VideoCentricTwoFeatDataset(_TwoFeatMixin, VideoCentricDataset):
    """Per-sentence npy token features + two video streams."""

    def __init__(self, opt, split, is_training, num_epochs=1, rng=None):
        super().__init__(opt, split, is_training, num_epochs, rng)
        self._init_shallow(opt)


DATASETS = {
    "video_centric": VideoCentricDataset,
    "video_centric_clip": VideoCentricCLIPDataset,
    "video_centric_clip_twofeat": VideoCentricCLIPTwoFeatDataset,
    "video_centric_twofeat": VideoCentricTwoFeatDataset,
}


def make_dataset(cfg, num_epochs=1, is_training=True, rng=None):
    """Dataset factory. At eval an ``eval_name`` key, when set, overrides
    the registry name."""
    data_opt = cfg.eval.data if not is_training else cfg.data
    name = data_opt["name"]
    if not is_training and data_opt.get("eval_name"):
        name = data_opt["eval_name"]
    return DATASETS[name](data_opt, data_opt["split"], is_training,
                          num_epochs=num_epochs, rng=rng)
