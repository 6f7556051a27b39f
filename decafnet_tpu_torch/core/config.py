"""Configuration tree (port of decafnet_tpu/core/config.py).

``CfgNode`` is a nested dict with attribute access, yaml I/O, merging and
dotted-key overrides (``merge_from_list``: unknown keys raise ``KeyError``).
``get_cfg_defaults(task)`` builds the task's default tree key for key as the
JAX package does, ``tpu`` section included, so an ``opt.yaml`` written by
the JAX trainer loads and takes ``--set`` overrides. Of the ``tpu`` section
the port reads ``compute_dtype`` (``models.resolve_compute_dtype``; bf16
serves and evaluates, training refuses it), ``remat`` and ``remat_policy``
(``models.make_model``), and ``shard_time`` and ``video_major_train``
(the Trainer).

``update_opt`` derives the dependent fields, ``update_eval_data`` backfills
``eval.data`` from ``data``, ``update_from`` backfills a frozen snapshot
with defaults introduced after it. ``load_config(path)`` is defaults of the
file's task <- the file, then ``update_opt``. ``setup_cfg`` builds the train
CLI's config with the experiment name (``generate_expname``) and log dir.
"""

from __future__ import annotations

import copy
import os
import random

import yaml


class CfgNode(dict):
    """A nested dict with attribute access, clone/merge, yaml I/O."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    @staticmethod
    def from_dict(d):
        node = CfgNode()
        for k, v in d.items():
            node[k] = CfgNode.from_dict(v) if isinstance(v, dict) else v
        return node

    def to_dict(self):
        return {k: v.to_dict() if isinstance(v, CfgNode) else v
                for k, v in self.items()}

    def clone(self):
        return copy.deepcopy(self)

    def merge_from_other_cfg(self, other):
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode):
                self[k].merge_from_other_cfg(v)
            elif isinstance(v, dict):
                self[k] = CfgNode.from_dict(v)
            else:
                self[k] = _coerce(v, self.get(k))

    def merge_from_file(self, fname):
        with open(fname, "r") as f:
            self.merge_from_other_cfg(yaml.safe_load(f) or {})

    def merge_from_list(self, kv_list):
        """Dotted-key overrides ``[key, value, key, value, ...]``; values
        are parsed as yaml and coerced to the default's type."""
        assert len(kv_list) % 2 == 0, "override list must be key/value pairs"
        for key, value in zip(kv_list[0::2], kv_list[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"unknown config key: {key}")
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"unknown config key: {key}")
            node[parts[-1]] = _parse_value(value, node[parts[-1]])

    def dump(self):
        return yaml.safe_dump(self.to_dict(), default_flow_style=False)

    def dump_to_file(self, fname):
        with open(fname, "w") as f:
            f.write(self.dump())

    @staticmethod
    def load_file(fname):
        with open(fname, "r") as f:
            return CfgNode.from_dict(yaml.safe_load(f) or {})


def _coerce(value, old):
    """Coerce merged values to the default's scalar type where unambiguous."""
    if isinstance(old, float) and isinstance(value, int) and not isinstance(value, bool):
        return float(value)
    if isinstance(old, tuple) and isinstance(value, list):
        return tuple(value)
    return value


def _parse_value(text, old):
    """Parse a CLI override string as yaml, matching the target type."""
    if not isinstance(text, str):
        return _coerce(text, old)
    try:
        value = yaml.safe_load(text)
    except yaml.YAMLError:
        value = text
    return _coerce(value, old)


# ---------------------------------------------------------------------------
# Task default trees
# ---------------------------------------------------------------------------


def _base_aux():
    aux = CfgNode()
    aux.mark = ""
    aux.runid = 0
    aux.debug = False
    aux.log = "decaf"
    aux.resume = True
    aux.model_resume = None
    aux.eval_run = -1
    aux.eval_by = "epoch"
    aux.save_run = 2
    aux.log_interval = 100
    aux.dryrun = False
    aux.cfg_file = ()
    aux.set_cfgs = None
    aux.exp = ""
    aux.logdir = ""
    return aux


def _base_data():
    """``group_method`` / ``tokenizer`` exist only in the charades tree; the
    datasets fall back to 'greedy' / None when they are absent."""
    data = CfgNode()
    data.name = "video_centric"
    data.split = "train"
    data.eval_split = "val"
    data.anno_file = None
    data.vid_feat_dir = None
    data.vid_load = "npy"
    data.shallow_vid_feat_dir = None
    data.shallow_vid_load = "npy"
    data.shallow_ds = None
    data.text_feat_dir = None
    data.ext_score_dir = None
    data.text_cls_fname = None
    data.clip_token_fname = None
    data.ego4d_train_anno = None
    data.ego4d_val_anno = None
    data.ego4d_metadata = None
    data.video_dir = None
    data.clip_size = 32
    data.clip_stride = 8
    data.to_fixed_len = False
    data.downsample_rate = 1
    data.true_ds = None
    data.max_num_text = 2
    data.trunc_thresh = 0.5
    data.crop_ratio = (0.9, 1.0)
    return data


def _base_model(delegation=True):
    """``delegation=False`` gives the mad/charades trees, which carry only
    ``norm`` of the delegation knobs."""
    model = CfgNode()
    model.name = "default"

    model.text_net = CfgNode()
    model.text_net.name = "transformer"
    model.text_net.in_dim = 300
    model.text_net.embd_dim = 128
    model.text_net.max_seq_len = 24
    model.text_net.n_heads = 4
    model.text_net.use_abs_pe = False
    model.text_net.use_bkgd_token = True

    model.vid_net = CfgNode()
    model.vid_net.name = "transformer"
    model.vid_net.in_dim = 500
    model.vid_net.embd_dim = 128
    model.vid_net.n_heads = 4
    model.vid_net.max_seq_len = 256
    model.vid_net.stride = 1
    model.vid_net.arch = (2, 0, 7)
    model.vid_net.mha_win_size = 5
    model.vid_net.attn_pdrop = 0.0
    model.vid_net.proj_pdrop = 0.1
    model.vid_net.path_pdrop = 0.1
    model.vid_net.use_abs_pe = True
    model.vid_net.fuse = "cat"   # read by no model code; kept for parity
    model.vid_net.pool_only = False
    model.vid_net.cdrop = 0.0

    model.fusion = CfgNode()
    model.fusion.name = "xattn"
    model.fusion.n_layers = 2
    model.fusion.n_heads = 4
    model.fusion.attn_pdrop = 0.0
    model.fusion.proj_pdrop = 0.1
    model.fusion.path_pdrop = 0.1
    model.fusion.xattn_mode = "adaln"

    model.cls_head = CfgNode()
    model.cls_head.name = "cls"
    model.cls_head.n_layers = 2
    model.cls_head.prior_prob = 0.0

    model.reg_head = CfgNode()
    model.reg_head.name = "reg"
    model.reg_head.n_layers = 2

    model.pretrain = None
    if delegation:
        model.sratio = 0.0    # fraction of saliency bins kept by delegation
        model.sn = 60         # clips per saliency bin
        model.msf = False     # concat shallow features channel-wise
        model.scat = False    # append correlation row as a channel
        model.sfonly = False  # use shallow features only
    model.norm = False        # L2-normalize before the saliency dot product
    return model


def _base_train():
    train = CfgNode()
    train.batch_size = 16
    train.num_workers = 4
    train.epochs = 5
    train.warmup_epochs = 5
    train.ema_beta = 0.999
    train.center_sampling = "radius"
    train.center_sampling_radius = 1.5
    train.loss_norm = 160
    train.loss_norm_momentum = 0.9
    train.loss_weight = 1.0
    train.reg_loss = "diou"
    train.version = 1
    return train


def _base_eval(data):
    """``eval.data`` is ``data`` with every key None, backfilled by
    ``update_eval_data``."""
    ev = CfgNode()
    ev.ranks = (1, 5)
    ev.iou_threshs = (0.3, 0.5)
    ev.pre_nms_thresh = 0.001
    ev.pre_nms_topk = 2000
    ev.seg_len_thresh = 0.1
    ev.data = CfgNode({k: None for k in data})
    ev.max_num_queries = 32     # query batching bucket cap
    ev.reference_exact = False  # host C++ SoftNMS per query
    ev.save_results = False     # dump per-video detections for analysis
    ev.shard_videos = 0         # V > 1: decode groups of V videos per call
    ev.shard_time = 0           # > 1 raises (ROADMAP item 11)
    ev.shard_processes = True   # in a process group: per-rank video shards
    return ev


def _base_nms():
    nms = CfgNode()
    nms.mode = "soft_nms"
    nms.iou_thresh = 0.1
    nms.min_score = 0.001
    nms.max_num_segs = 5
    nms.sigma = 0.9
    nms.voting_thresh = 0.95
    return nms


def _base_tpu():
    """The JAX package's runtime knobs, kept so its snapshots parse. Of
    these the port reads ``compute_dtype`` ("auto" and "float32" run f32;
    "bfloat16" runs the eval and serve paths with bf16 activations and f32
    parameters and statistics, and the Trainer and the encoders raise on it:
    ROADMAP items 12b-c), ``remat`` / ``remat_policy``
    (activation checkpointing of the video encoders in training),
    ``shard_time`` (sequence parallelism, raises: ROADMAP item 11) and
    ``video_major_train``. Data-parallel training needs no key here: it
    runs under ``torchrun``."""
    tpu = CfgNode()
    tpu.mesh_shape = None
    tpu.compute_dtype = "auto"
    tpu.matmul_precision = "auto"
    tpu.attention_backend = "auto"
    tpu.seq_buckets = ()
    tpu.compilation_cache = "~/.cache/decafnet_tpu/xla"
    tpu.remat = False
    tpu.remat_policy = "nothing"
    tpu.shard_time = False
    tpu.video_major_train = True
    return tpu


def _defaults_common(task, delegation=True):
    cfg = CfgNode()
    cfg.seed = None
    cfg.task = task
    cfg.aux = _base_aux()
    cfg.model = _base_model(delegation=delegation)

    cfg.loss = CfgNode()
    cfg.loss.fc_a = 0.5   # focal alpha
    cfg.loss.fc_s = 0.2   # focal label smoothing

    cfg.pt_gen = CfgNode()
    cfg.pt_gen.regression_range = 4
    cfg.pt_gen.sigma = 0.5

    cfg.train = _base_train()

    cfg.optimizer = CfgNode()
    cfg.optimizer.name = "adamw"
    cfg.optimizer.lr = 1e-3
    cfg.optimizer.weight_decay = 0.05
    cfg.optimizer.clip_grad_norm = 1.0

    cfg.scheduler = CfgNode()
    cfg.scheduler.name = "multistep"
    cfg.scheduler.steps = (-1,)
    cfg.scheduler.gamma = 0.1

    cfg.data = _base_data()
    cfg.eval = _base_eval(cfg.data)
    cfg.nms = _base_nms()

    cfg.log = CfgNode()
    cfg.log.log_interval = 100
    cfg.log.checkpoint_epochs = (6, 7, 8, 9, 10)
    cfg.log.root = "log"

    cfg.tpu = _base_tpu()
    return cfg


def get_cfg_defaults(task="grounder"):
    """Default tree of a task: ``grounder`` (Ego4D-NLQ / GoalStep), ``mad``
    (movie-length) or ``charades`` (= mad + short-video extras)."""
    cfg = _defaults_common(task, delegation=(task == "grounder"))
    if task in ("mad", "charades"):
        cfg.train.microbatch_size = 1
        cfg.eval.max_vid_len = 32768
        # keys the mad tree adds after eval.data was cloned
        cfg.data.clip_d = 4.0
        cfg.data.small_img_size = 112
        cfg.data.max_feats = 16
        cfg.data.npos_feats = 8
        cfg.loss.dw = 0.0
        cfg.optimizer.fpretrain = False
        cfg.optimizer.lpretrain = None
    if task == "charades":
        cfg.data.group_method = None
        cfg.eval.data.group_method = None
        cfg.data.tokenizer = None
        cfg.eval.data.tokenizer = None
        cfg.model.rlayer = None
        cfg.model.rdim = 32
    return cfg


def update_opt(cfg):
    """Compute the fields derived from the base options (idempotent)."""
    m = cfg.model
    m.max_text_len = m.text_net.max_seq_len
    m.max_vid_len = m.vid_net.max_seq_len
    m.vid_stride = m.vid_net.stride
    m.num_fpn_levels = m.vid_net.arch[-1]
    m.mha_win_size = m.vid_net.mha_win_size
    cfg.data.max_text_len = m.max_text_len
    cfg.data.max_vid_len = m.vid_stride * m.max_vid_len
    cfg.scheduler.epochs = cfg.train.epochs
    cfg.scheduler.warmup_epochs = cfg.train.warmup_epochs

    text_dim = m.text_net.embd_dim
    vid_dim = m.vid_net.embd_dim
    m.fusion.text_dim = text_dim
    m.fusion.vid_dim = vid_dim
    m.cls_head.embd_dim = vid_dim
    m.reg_head.embd_dim = vid_dim
    m.reg_head.num_fpn_levels = m.num_fpn_levels
    cfg.pt_gen.num_fpn_levels = m.num_fpn_levels
    cfg.pt_gen.max_seq_len = m.max_vid_len * 4
    return cfg


def update_eval_data(cfg):
    """Backfill unset ``eval.data`` keys from ``data``, switch the split."""
    for k in cfg.data:
        if cfg.eval.data.get(k) is None:
            cfg.eval.data[k] = copy.deepcopy(cfg.data[k])
    if cfg.data.eval_split is not None:
        cfg.eval.data.split = cfg.data.eval_split
    return cfg


def update_from(cfg, ref):
    """A copy of ``cfg`` with every key of ``ref`` it lacks added
    (recursively): backfills a frozen ``opt.yaml`` with newer defaults."""
    cfg = cfg.clone()

    def _merge(dst, src):
        for k in src:
            if k not in dst:
                dst[k] = copy.deepcopy(src[k])
            elif isinstance(dst[k], CfgNode) and isinstance(src[k], dict):
                _merge(dst[k], src[k])

    _merge(cfg, ref)
    return cfg


def file_task(path):
    """The ``task`` a config file names, 'grounder' when it names none."""
    with open(path, "r") as f:
        return (yaml.safe_load(f) or {}).get("task", "grounder")


def load_config(path):
    """Defaults of the file's task <- the file, then derived fields."""
    cfg = get_cfg_defaults(file_task(path))
    cfg.merge_from_file(path)
    return update_opt(cfg)


# ---------------------------------------------------------------------------
# Experiment naming and the train CLI's config (decafnet_tpu/core/config.py:
# 489-586)
# ---------------------------------------------------------------------------


def _flatten(cfg, prefix=""):
    out = {}
    for k, v in cfg.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def diff_dict(default, cfg, skip_prefixes=("aux.", "log.", "tpu.")):
    """Flat {dotted.key: value} of the entries of ``cfg`` that differ from
    ``default``; keys only ``cfg`` has count as differences."""
    fd, fc = _flatten(default), _flatten(cfg)
    return {k: v for k, v in fc.items()
            if not any(k.startswith(p) for p in skip_prefixes)
            and (k not in fd or fd[k] != v)}


def _capitalize_key(key):
    # "model.vid_net.embd_dim" -> "Model.VidNet.EmbdDim"
    def cap(part):
        return "".join(s[:1].upper() + s[1:] for s in part.split("_"))
    return ".".join(cap(p) for p in key.split("."))


def generate_expname(cfg, default, cfg_files=()):
    """Experiment name: the config files' stems, then the diff against
    defaults <- files, then ``aux.mark``."""
    parts = []
    ref = default.clone()
    for f in cfg_files:
        ref.merge_from_file(f)
        parts.append(os.path.splitext(os.path.basename(f))[0])
    diff = diff_dict(ref, cfg)
    if diff:
        parts.append("-".join(f"{_capitalize_key(k)}:{v}"
                              for k, v in sorted(diff.items())))
    if cfg.aux.mark:
        parts.append(cfg.aux.mark)
    return "_".join(parts) if parts else "default"


def get_task(cfg_files=(), set_cfgs=None):
    """The task of the last file that names one, unless ``--set task``."""
    task = "grounder"
    for fname in cfg_files:
        with open(fname, "r") as f:
            task = (yaml.safe_load(f) or {}).get("task", task)
    if set_cfgs:
        for k, v in zip(set_cfgs[0::2], set_cfgs[1::2]):
            if k == "task":
                task = v
    return task


def setup_cfg(cfg_files=(), set_cfgs=None):
    """The train CLI's config: defaults <- files <- ``--set`` overrides;
    the experiment name and log dir
    (``<log.root>/<aux.log>/<aux.exp>/<aux.runid>``); the seed of an
    existing ``opt.yaml`` of the same experiment when none is set, else a
    fresh random one; then the derived fields and ``eval.data``."""
    task = get_task(cfg_files, set_cfgs)
    cfg = get_cfg_defaults(task)
    for f in cfg_files:
        cfg.merge_from_file(f)
    if set_cfgs:
        cfg.merge_from_list(list(set_cfgs))

    cfg.aux.cfg_file = tuple(cfg_files)
    cfg.aux.set_cfgs = list(set_cfgs) if set_cfgs else None
    cfg.aux.exp = generate_expname(cfg, get_cfg_defaults(task), cfg_files)

    root = "log/test" if cfg.aux.debug else (cfg.log.root or "log")
    logdir = os.path.join(root, cfg.aux.log, cfg.aux.exp, str(cfg.aux.runid))
    prev = os.path.join(logdir, "opt.yaml")
    if cfg.seed is None and os.path.exists(prev):
        cfg.seed = CfgNode.load_file(prev).get("seed")
    if cfg.seed is None:
        cfg.seed = random.SystemRandom().randrange(10 ** 9)

    update_opt(cfg)
    update_eval_data(cfg)
    cfg.aux.logdir = logdir
    return cfg
