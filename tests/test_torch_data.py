"""The port's host-side pieces against the JAX package's: config trees and
shipped configs, synthetic data (byte for byte), datasets (every sample key,
eval and train), the loader's order and rank shards, the tokenizer,
annotate_points and the losses (1e-6), RecallMeter / interval_iou and the
host NMS (exact), logging utilities and EvalResults."""

import glob
import io
import os
import zipfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from decafnet_tpu import core as jcore
from decafnet_tpu.data import DataLoader as JaxLoader
from decafnet_tpu.data import apply_synthetic_cfg as jax_apply_synthetic_cfg
from decafnet_tpu.data import make_dataset as jax_make_dataset
from decafnet_tpu.data import make_synthetic_dataset as jax_make_synthetic
from decafnet_tpu.data import tokenizer as jtok
from decafnet_tpu.data.dataset import VID_LOAD_FUNC as JAX_VID_LOAD_FUNC
from decafnet_tpu.eval import metrics as jmetrics
from decafnet_tpu.ops import nms as jnms
from decafnet_tpu.train import annotate as jannotate
from decafnet_tpu.train import losses as jlosses
from decafnet_tpu.utils import analysis as janalysis
from decafnet_tpu.utils import logging as jlogging
from decafnet_tpu_torch import core
from decafnet_tpu_torch.data import (DataLoader, apply_synthetic_cfg,
                                     make_dataset, make_synthetic_dataset)
from decafnet_tpu_torch.data import tokenizer as ttok
from decafnet_tpu_torch.data.dataset import VID_LOAD_FUNC
from decafnet_tpu_torch.eval import metrics
from decafnet_tpu_torch.ops import nms
from decafnet_tpu_torch.train import annotate_points, losses
from decafnet_tpu_torch.utils import analysis
from decafnet_tpu_torch.utils import logging as tlogging

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
TASKS = ("grounder", "mad", "charades")


def _flat(cfg, prefix=""):
    out = {}
    for k, v in cfg.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("task", TASKS)
def test_defaults_equal_jax_for_every_key(task):
    got = _flat(core.update_eval_data(core.update_opt(core.get_cfg_defaults(task))))
    want = _flat(jcore.update_eval_data(jcore.update_opt(jcore.get_cfg_defaults(task))))
    assert got == want
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in want.items()}


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_shipped_config_loads_like_jax(path):
    task = jcore.config.get_task([path])
    want = jcore.get_cfg_defaults(task)
    want.merge_from_file(path)
    jcore.update_eval_data(jcore.update_opt(want))
    got = core.update_eval_data(core.load_config(path))
    assert core.file_task(path) == task
    assert _flat(got) == _flat(want)


def test_merge_from_list_like_jax():
    sets = ["eval.reference_exact", "True", "nms.sigma", "1", "eval.ranks",
            "[1, 10]", "model.vid_net.arch", "[2, 0, 5]", "data.split", "val"]
    got, want = core.get_cfg_defaults(), jcore.get_cfg_defaults()
    got.merge_from_list(sets)
    want.merge_from_list(sets)
    assert _flat(got) == _flat(want)
    assert got.nms.sigma == 1.0 and isinstance(got.nms.sigma, float)
    assert got.model.vid_net.arch == (2, 0, 5)
    with pytest.raises(KeyError):
        got.merge_from_list(["model.no_such_key", "1"])
    with pytest.raises(KeyError):
        got.merge_from_list(["no_section.key", "1"])
    with pytest.raises(AssertionError):
        got.merge_from_list(["eval.reference_exact"])


def test_jax_snapshot_round_trips(tmp_path):
    """An opt.yaml the JAX side writes (with keys missing, as an older
    snapshot) loads and backfills to the JAX result."""
    cfg = jcore.update_eval_data(jcore.update_opt(jcore.get_cfg_defaults()))
    del cfg.eval["shard_time"]
    del cfg.tpu["remat"]
    path = str(tmp_path / "opt.yaml")
    cfg.dump_to_file(path)
    got = core.update_from(core.CfgNode.load_file(path), core.get_cfg_defaults())
    want = jcore.update_from(jcore.CfgNode.load_file(path), jcore.get_cfg_defaults())
    assert _flat(got) == _flat(want)
    assert got.dump() == want.dump()
    assert got.clone() == got and got.clone() is not got


# ---------------------------------------------------------------- datasets

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data")
    kw = dict(num_videos=4, num_queries=5, clip_range=(50, 140), seed=5)
    return (jax_make_synthetic(str(root / "jax"), **kw),
            make_synthetic_dataset(str(root / "port"), **kw), root)


def test_synthetic_files_are_byte_identical(synth):
    _, _, root = synth
    files = sorted(os.path.relpath(p, root / "jax")
                   for p in glob.glob(str(root / "jax" / "**" / "*"), recursive=True)
                   if os.path.isfile(p))
    assert len(files) == 4 * 2 * 2 + 4
    for rel in files:
        with open(root / "jax" / rel, "rb") as a, open(root / "port" / rel, "rb") as b:
            assert a.read() == b.read(), rel


def _cfgs(synth, **data):
    jpaths, tpaths, _ = synth
    out = []
    for defaults, apply, derive, paths in (
            (jcore.get_cfg_defaults, jax_apply_synthetic_cfg,
             (jcore.update_opt, jcore.update_eval_data), jpaths),
            (core.get_cfg_defaults, apply_synthetic_cfg,
             (core.update_opt, core.update_eval_data), tpaths)):
        cfg = defaults("grounder")
        cfg.model.vid_net.in_dim = 32
        cfg.model.vid_net.max_seq_len = 64
        cfg.data.max_num_text = 2
        cfg.data.update(data)
        apply(cfg, paths)
        for fn in derive:
            fn(cfg)
        out.append(cfg)
    return out


def _same_sample(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, (tuple, list)):
            assert len(g) == len(w), k
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=k)
        elif w is None:
            assert g is None, k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
            assert np.asarray(g).dtype == np.asarray(w).dtype, k


@pytest.mark.parametrize("data", [{}, {"group_method": "random", "to_fixed_len": True},
                                  {"crop_ratio": None}],
                         ids=["greedy", "random_fixed_len", "no_crop"])
def test_train_samples_equal_jax(synth, data):
    jcfg, tcfg = _cfgs(synth, **data)
    jds = jax_make_dataset(jcfg, num_epochs=2, is_training=True,
                           rng=np.random.RandomState(42))
    tds = make_dataset(tcfg, num_epochs=2, is_training=True,
                       rng=np.random.RandomState(42))
    assert tds.data_list == jds.data_list
    for epoch in range(2):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        for i in range(len(jds)):
            got, want = tds[i], jds[i]
            if data.get("to_fixed_len"):
                # linear resize: positions in f64 on both sides, lerp in f32
                for k in ("vid", "shallow_vid"):
                    np.testing.assert_allclose(got.pop(k), want.pop(k),
                                               rtol=1e-6, atol=1e-6)
                for k in ("clip_size", "clip_stride"):
                    assert got.pop(k) == pytest.approx(want.pop(k), rel=1e-12)
            _same_sample(got, want)


def test_eval_samples_equal_jax(synth):
    jcfg, tcfg = _cfgs(synth)
    jds = jax_make_dataset(jcfg, is_training=False)
    tds = make_dataset(tcfg, is_training=False)
    assert tds.data_list == jds.data_list and len(tds) == 4
    for i in range(len(jds)):
        _same_sample(tds[i], jds[i])
    jcfg.eval.data.eval_name = tcfg.eval.data.eval_name = "video_centric_clip"
    assert type(make_dataset(tcfg, is_training=False)).__name__ == \
        type(jax_make_dataset(jcfg, is_training=False)).__name__


@pytest.mark.parametrize("shuffle,world", [
    (False, 1), (True, 1), (False, 2), (True, 2), (True, 3)])
def test_loader_order_and_rank_shards_equal_jax(synth, shuffle, world):
    jcfg, tcfg = _cfgs(synth)
    jds = jax_make_dataset(jcfg, num_epochs=2, is_training=True,
                           rng=np.random.RandomState(0))
    tds = make_dataset(tcfg, num_epochs=2, is_training=True,
                       rng=np.random.RandomState(0))
    bs = 2
    for rank in range(world):
        for drop_last in (True, False):
            kw = dict(batch_size=bs, shuffle=shuffle, seed=7, drop_last=drop_last,
                      rank=rank, world_size=world)
            jl = JaxLoader(jds, num_threads=0, **kw)
            tl = DataLoader(tds, num_threads=2, **kw)
            for epoch in range(2):
                jl.set_epoch(epoch)
                tl.set_epoch(epoch)
                key = lambda b: [(s["clip_id"], s["text_id"]) for s in b]  # noqa: E731
                assert [key(b) for b in tl] == [key(b) for b in jl]
                assert len(tl) == len(jl)


def test_loader_stops_its_thread_and_raises_errors(synth):
    _, tcfg = _cfgs(synth)
    tds = make_dataset(tcfg, num_epochs=1, is_training=True,
                       rng=np.random.RandomState(0))
    import threading
    before = threading.active_count()
    loader = DataLoader(tds, batch_size=1, shuffle=False, num_threads=2)
    for _ in loader:
        assert threading.active_count() == before + 1
        break     # an early exit (dryrun) leaves no thread behind
    assert threading.active_count() == before

    class Unreadable:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            raise OSError("unreadable")
    bad = DataLoader(Unreadable(), batch_size=1, shuffle=False, num_threads=2)
    with pytest.raises(OSError, match="unreadable"):
        list(bad)
    assert threading.active_count() == before


def test_full_pt_loader_equals_jax(tmp_path):
    import json
    feat_dir = tmp_path / "feats"
    feat_dir.mkdir()
    feature = np.arange(100 * 8, dtype=np.float32).reshape(100, 8)
    torch.save(torch.from_numpy(feature), str(feat_dir / "videoA.pt"))
    anno = {"videos": [{"video_uid": "videoA", "clips": [
        {"clip_uid": "clip1", "video_start_sec": 10.3, "video_end_sec": 20.7}]}]}
    meta = {"videos": [{"video_uid": "videoA", "video_metadata": {
        "display_resolution_height": 1080, "display_resolution_width": 1920}}]}
    (tmp_path / "anno.json").write_text(json.dumps(anno))
    (tmp_path / "meta.json").write_text(json.dumps(meta))

    def fake(base):
        class Fake:
            split = ("train",)
            opt = {"clip_stride": 8, "ego4d_train_anno": str(tmp_path / "anno.json"),
                   "ego4d_metadata": str(tmp_path / "meta.json")}
            video_info_for_mv = base.video_info_for_mv
            _video_info_for_mv = None
        return Fake()

    from decafnet_tpu.data.dataset import BaseDataset as JaxBase
    from decafnet_tpu_torch.data.dataset import BaseDataset
    path = str(feat_dir / "clip1")
    got = VID_LOAD_FUNC["full_pt"](path, fake(BaseDataset))
    np.testing.assert_array_equal(got, JAX_VID_LOAD_FUNC["full_pt"](path, fake(JaxBase)))
    np.testing.assert_array_equal(got, feature[38:77])


# --------------------------------------------------------------- tokenizer

def test_tokenizer_equals_jax(tmp_path):
    vec = tmp_path / "glove.txt"
    vec.write_text("the 1.0 0.0\ncat 0.0 1.0\nsat 0.5 0.5\nCap 0.1 0.2\nodd 1\n")
    for text in ("The cat, sat!", "Don't (stop) \"now\"; ok: yes?", "", "CAP cap."):
        assert ttok.basic_english_tokenize(text) == jtok.basic_english_tokenize(text)
        np.testing.assert_array_equal(ttok.GloVeTokenizer(str(vec))(text),
                                      jtok.GloVeTokenizer(str(vec))(text))
    assert ttok.make_tokenizer(None) is None
    tok = ttok.make_tokenizer({"name": "glove", "vectors_path": str(vec)})
    assert tok("the cat unknown").shape == (2, 3)


def test_glove_fetch_with_a_fake_download(tmp_path, monkeypatch):
    import urllib.request
    calls = []

    def fake_urlretrieve(url, dst):
        calls.append(url)
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as z:
            z.writestr("glove.6B.300d.txt", "the 1.0 0.0\ncat 0.0 1.0\n")
        with open(dst, "wb") as f:
            f.write(buf.getvalue())

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_urlretrieve)
    cache = str(tmp_path / "cache")
    tok = ttok.make_tokenizer({"name": "glove", "cache_dir": cache})
    np.testing.assert_allclose(tok("the cat")[:, 1], [0.0, 1.0])
    assert len(calls) == 1 and calls[0] == jtok.GLOVE_URLS["6B"]
    ttok.fetch_glove(cache_dir=cache)
    assert len(calls) == 1           # warm cache: no second download

    def dead(url, dst):
        raise OSError("no network")
    monkeypatch.setattr(urllib.request, "urlretrieve", dead)
    with pytest.raises(RuntimeError, match="auto-fetch"):
        ttok.fetch_glove(cache_dir=str(tmp_path / "cold"))
    # the default cache lives inside the checkout
    assert ttok._CACHE_DIR == os.path.join(REPO, "build", "glove")


# ------------------------------------------------------- annotate + losses

def _points_targets(seed, B=5, P=200):
    rng = np.random.RandomState(seed)
    strides = rng.choice([1.0, 2.0, 4.0, 8.0], P).astype(np.float32)
    coords = np.sort(rng.uniform(0, 100, P)).astype(np.float32)
    reg_min = (strides * 2 * rng.randint(0, 3, P)).astype(np.float32)
    reg_max = np.where(rng.rand(P) < 0.1, np.inf, reg_min + 4 * strides).astype(np.float32)
    points = np.stack([coords, reg_min, reg_max, strides])
    s = rng.uniform(0, 90, B)
    targets = np.stack([s, s + rng.uniform(1, 30, B)], 1).astype(np.float32)
    return points, targets


@pytest.mark.parametrize("sampling", ["radius", "none"])
def test_annotate_points_equals_jax(sampling):
    points, targets = _points_targets(0)
    labels, offsets = annotate_points(torch.from_numpy(points),
                                      torch.from_numpy(targets),
                                      center_sampling=sampling,
                                      center_sampling_radius=1.5)
    jl, jo = jannotate.annotate_points(jnp.asarray(points), jnp.asarray(targets),
                                       center_sampling=sampling,
                                       center_sampling_radius=1.5)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_allclose(offsets.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    assert labels.any() and not labels.all()


def _loss_inputs(seed, B=4, N=64):
    rng = np.random.RandomState(seed)
    logits = (3 * rng.randn(B, N)).astype(np.float32)
    labels = rng.rand(B, N) < 0.3
    valid = rng.rand(B, N) < 0.8
    pred = np.abs(rng.randn(B, 2, N)).astype(np.float32) + 0.01
    gt = np.abs(rng.randn(B, 2, N)).astype(np.float32) + 0.01
    return logits, labels, valid, pred, gt


def test_losses_equal_jax():
    logits, labels, valid, pred, gt = _loss_inputs(1)
    T = torch.from_numpy
    close = dict(rtol=1e-6, atol=1e-6)
    for smoothing in (True, False):
        for alpha in (-1.0, 0.25):
            np.testing.assert_allclose(
                losses.sigmoid_focal_loss(T(logits), T(labels.astype(np.float32)),
                                          alpha=alpha, smoothing=smoothing).numpy(),
                np.asarray(jlosses.sigmoid_focal_loss(
                    logits, labels.astype(np.float32), alpha=alpha,
                    smoothing=smoothing)), **close)
    for s, a in ((0.2, 0.5), (0.0, 0.25)):
        # the port sums each row; the JAX function sums everything it gets
        want = np.asarray(jlosses.calc_focal_loss(logits, labels, valid,
                                                  smoothing=s, alpha=a))
        rows = losses.calc_focal_loss(T(logits), T(labels), T(valid), smoothing=s,
                                      alpha=a)
        np.testing.assert_allclose(rows.sum().numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(rows.numpy(), [np.asarray(jlosses.calc_focal_loss(
            logits[i], labels[i], valid[i], smoothing=s, alpha=a)) for i in range(4)],
            rtol=1e-6)
    for kind in ("diou", "giou", "iou"):
        want = np.asarray(jlosses.calc_iou_loss(pred, gt, valid, reg_loss=kind))
        rows = losses.calc_iou_loss(T(pred), T(gt), T(valid), reg_loss=kind)
        np.testing.assert_allclose(rows.sum().numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(rows.numpy(), [np.asarray(jlosses.calc_iou_loss(
            pred[i], gt[i], valid[i], reg_loss=kind)) for i in range(4)], rtol=1e-6)
    np.testing.assert_allclose(losses.ctr_diou_loss(T(pred), T(gt)).numpy(),
                               np.asarray(jlosses.ctr_diou_loss(pred, gt)), **close)
    np.testing.assert_allclose(losses.ctr_giou_loss(T(pred), T(gt)).numpy(),
                               np.asarray(jlosses.ctr_giou_loss(pred, gt)), **close)
    with pytest.raises(ValueError):
        losses.calc_iou_loss(T(pred), T(gt), T(valid), reg_loss="l1")
    segs = np.sort(np.abs(np.random.RandomState(2).randn(10, 2, 2)), -1).astype(np.float32)
    np.testing.assert_allclose(
        losses.segment_iou(T(segs[:, 0]), T(segs[:, 1])).numpy(),
        np.asarray(jlosses.segment_iou(segs[:, 0], segs[:, 1])), **close)


def test_padding_rows_give_finite_losses():
    """Padding query rows carry targets [0, 1]; masked positions never make
    a NaN."""
    logits, labels, _, pred, gt = _loss_inputs(2)
    pred[0, :, :5] = 0.0
    gt[0, :, :5] = 0.0
    valid = np.zeros_like(labels)
    T = torch.from_numpy
    assert torch.isfinite(losses.calc_iou_loss(T(pred), T(gt), T(valid))).all()
    assert not losses.calc_focal_loss(T(logits), T(labels), T(valid)).any()


# ------------------------------------------------------------------ metrics

def test_recall_meter_and_interval_iou_equal_jax():
    rng = np.random.RandomState(4)
    a = np.sort(rng.uniform(0, 50, (200, 2)), -1)
    b = np.sort(rng.uniform(0, 50, (200, 2)), -1)
    b[:10] = a[:10]                  # IoU exactly 1
    b[10:20, 1] = b[10:20, 0]        # empty targets
    np.testing.assert_array_equal(metrics.interval_iou(a, b), jmetrics.interval_iou(a, b))
    got = metrics.RecallMeter((1, 5, 10), (0.1, 0.3, 0.5, 0.7))
    want = jmetrics.RecallMeter((1, 5, 10), (0.1, 0.3, 0.5, 0.7))
    for i in range(50):
        n = rng.randint(0, 12)
        segs = np.sort(rng.uniform(0, 50, (n, 2)), -1).astype(np.float32)
        scores = rng.rand(n).astype(np.float32)
        if n > 3:
            scores[1] = scores[2]    # a tie: the stable order decides
        target = np.sort(rng.uniform(0, 50, 2))
        got.update(segs, scores, target)
        want.update(segs, scores, target)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.text_cnt == want.text_cnt == 50
    (gm, gt_), (wm, wt) = got.table(), want.table()
    np.testing.assert_array_equal(gm, wm)
    assert gt_ == wt
    got.reset()
    assert got.text_cnt == 0 and not got.counts.any()


# ----------------------------------------------------------------- host NMS

def _candidates(seed, n):
    rng = np.random.RandomState(seed)
    s = rng.uniform(0, 100, n)
    segs = np.stack([s, s + rng.uniform(0.5, 20, n)], 1).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    scores[: n // 10] = scores[n // 10: 2 * (n // 10)]    # ties
    return segs, scores


@pytest.mark.parametrize("mode", ["soft_nms", "nms"])
@pytest.mark.parametrize("n", [0, 1, 7, 300])
def test_host_nms_equals_jax(n, mode):
    segs, scores = _candidates(n, n)
    if mode == "nms":
        np.testing.assert_array_equal(nms.nms_host(segs, scores, 0.3),
                                      jnms.nms_host(segs, scores, 0.3))
    else:   # the gaussian decay, the reference's method 2
        got = nms.softnms_host(segs, scores, 0.9, 0.001)
        want = jnms.softnms_host(segs, scores, 0.1, 0.9, 0.001, 2)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for voting in (0.0, 0.95):
        kw = dict(iou_thresh=0.1, min_score=0.001, max_num_segs=5, mode=mode,
                  sigma=0.9, voting_thresh=voting)
        for g, w in zip(nms.batched_nms_host(segs, scores, **kw),
                        jnms.batched_nms_host(segs, scores, **kw)):
            np.testing.assert_array_equal(g, w)
    if n:
        keep = segs[:3]
        np.testing.assert_array_equal(
            nms.segment_voting_host(keep, segs, scores, 0.5),
            jnms.segment_voting_host(keep, segs, scores, 0.5))


def test_host_nms_library_is_built_in_the_checkout():
    path, _ = nms.build_host()
    assert path == nms.host_library_path()
    assert path.startswith(os.path.join(REPO, "build", "host") + os.sep)
    assert os.path.exists(path)
    with pytest.raises(ValueError):
        nms.nms_host(np.zeros((3, 2), np.float32), np.zeros(2, np.float32), 0.1)
    with pytest.raises(NotImplementedError):
        nms.batched_nms_host(*_candidates(0, 4), 0.1, 0.0, 5, mode="other")


# ---------------------------------------------------------- logging, dumps

def test_logging_utilities_equal_jax(tmp_path):
    scores = [{"a": 1.0, "b": np.nan}, {"a": 3.0, "b": 2.0}, {"a": 2.0, "b": 4.0}]
    for mode in ("mean", "max", "median"):
        for skip in (True, False):
            got = tlogging.easy_reduce(scores, mode, skip_nan=skip)
            want = jlogging.easy_reduce(scores, mode, skip_nan=skip)
            np.testing.assert_array_equal(list(got.values()), list(want.values()))
    assert tlogging.easy_reduce([(1, 2), (3, 4)]) == jlogging.easy_reduce([(1, 2), (3, 4)])
    for s in (3.4, 75, 4000, 90000):
        assert tlogging.time_str(s) == jlogging.time_str(s)
    m = tlogging.AverageMeter()
    m.update(2.0, 3)
    m.update(4.0)
    assert m.item() == 2.5
    log = tmp_path / "log.txt"
    tlogging.Logger(str(log), quiet=True).write("line")
    assert log.read_text() == "line\n"
    tree = {"a": {"w": np.zeros((3, 4)), "s": np.zeros(())}, "b": np.zeros(5)}
    assert tlogging.count_parameters(tree, scale=1) == 18
    assert tlogging.count_parameters(tree) == jlogging.count_parameters(tree)


def test_eval_results_equal_jax(tmp_path):
    rng = np.random.RandomState(6)
    dets = [{"segments": np.sort(rng.rand(3, 2) * 10, -1), "scores": rng.rand(3)},
            {"segments": np.zeros((0, 2)), "scores": np.zeros(0)}]
    targets = [[1.0, 4.0], [2.0, 3.0]]
    got, want = analysis.EvalResults("t"), janalysis.EvalResults("t")
    for r in (got, want):
        r.add_video("v0", targets, dets, [{"cls_loss": 1.0}] * 2)
    assert got.top1_ious() == want.top1_ious()
    path = str(tmp_path / "r.pk")
    got.save(path)
    back = janalysis.EvalResults.load(path)
    assert back.tag == "t" and back.top1_ious() == want.top1_ious()
    assert analysis.EvalResults.load(path).videos[0]["vid_id"] == "v0"
