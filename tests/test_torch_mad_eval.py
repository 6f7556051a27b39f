"""The port's Evaluator (device='cpu') against decafnet_tpu.eval.Evaluator
under the movie-length task: configs/mad.yaml (task ``mad``) at reduced
widths and depth, the same flax weights carried across.

Two synthetic movies on the MAD clip grid (clip size and stride 5): one of
36 queries in the bucket 8x the base length (``max_seq_len`` 64, so the PE
interpolation plans run), decoded as a chunk of 32 queries and one of 4,
and one of 4 queries in the base bucket. 8x is the longest bucket either
Evaluator decodes: both buffer candidate points for 10x ``max_seq_len``
(decafnet_tpu/eval/evaluator.py:111), and the next bucket, 16x, asks for
more (``select_points`` raises in both; checked below).

- f32: the R@k tables equal, per-query detections within 1e-3 s / 1e-4
  score, the eval losses at rtol 1e-4 / atol 1e-5 (tests/test_torch_eval.py).
- bf16 (``tpu.compute_dtype bfloat16``) against the JAX Evaluator in bf16
  by the rule of tests/test_torch_bf16.py: R@1 counts equal, R@5 flips at
  most 1 per 100 queries, tie-aware top-1 agreement held to the f32-vs-bf16
  floor.
- ``eval.shard_time 2``: the eval CLI's ``build_evaluator`` + ``run`` as
  two gloo ranks on an experiment directory of the same weights, each
  movie's time axis split over the ranks: every rank's R@k counts and
  query count equal the one-process port run's, the loss means at rtol
  1e-5. Helpers come from tests/test_torch_ddp.py."""

import functools
import json
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax

from decafnet_tpu.core import get_cfg_defaults as jax_defaults
from decafnet_tpu.core import update_eval_data as jax_update_eval_data
from decafnet_tpu.core import update_opt as jax_update_opt
from decafnet_tpu.data import apply_synthetic_cfg as jax_apply_synthetic_cfg
from decafnet_tpu.data import make_synthetic_dataset as jax_make_synthetic
from decafnet_tpu.eval import Evaluator as JaxEvaluator
from decafnet_tpu.models import make_model as jax_make_model
from decafnet_tpu.utils.analysis import EvalResults as JaxEvalResults
from decafnet_tpu_torch.core import get_cfg_defaults, update_eval_data, update_opt
from decafnet_tpu_torch.data import apply_synthetic_cfg
from decafnet_tpu_torch.eval import Decoder, Evaluator
from decafnet_tpu_torch.models import save_pth
from decafnet_tpu_torch.utils import EvalResults
from test_torch_bf16 import _top1_agreement
from test_torch_ddp import finish, spawn

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAD_YAML = os.path.join(REPO, "configs", "mad.yaml")
CV, CT = 32, 24
BASE = 64                       # max_seq_len: the base bucket length
LONG_CLIPS = (4 * BASE + 1, 8 * BASE + 1)   # the 8x bucket
LONG_QUERIES, SHORT_QUERIES = 36, 4
SEG_TOL_S, SCORE_TOL = 1e-3, 1e-4
# thresholds low enough that random weights put detections on both sides
IOU_THRESHS = (0.1, 0.3)

WORKER = textwrap.dedent("""
    import json, sys

    import torch

    from decafnet_tpu_torch import parallel
    from decafnet_tpu_torch.eval.__main__ import build_evaluator

    torch.set_num_threads(1)
    ev = build_evaluator(["--name", sys.argv[1], "--device", "cpu", "--set",
                          "eval.shard_time", "2"])
    assert ev.shard is not None and not ev.shard_proc
    metrics = ev.run()
    print("EVAL::" + json.dumps({
        "rank": parallel.rank(), "counts": ev.meter.counts.tolist(),
        "text_cnt": ev.meter.text_cnt, "metrics": metrics.tolist(),
        "loss_means": ev.loss_means, "videos": len(ev.loader),
        "calls": ev.decoder.decode_calls}), flush=True)
    parallel.destroy()
""")


def _mad(defaults, apply, derive, paths, logdir, dtype="float32"):
    """configs/mad.yaml over the task's defaults, cut to test widths and
    depth (two embedding convs and four FPN levels), pointed at the
    synthetic split."""
    cfg = defaults("mad")
    cfg.merge_from_file(MAD_YAML)
    m = cfg.model
    m.vid_net.in_dim = CV
    m.vid_net.embd_dim = 16
    m.vid_net.max_seq_len = BASE
    m.vid_net.arch = (2, 0, 4)
    m.text_net.in_dim = CT
    m.text_net.embd_dim = 16
    m.text_net.n_layers = 1
    m.fusion.n_layers = 1
    m.sn = 8
    cfg.train.num_workers = 0
    cfg.eval.iou_threshs = IOU_THRESHS
    cfg.eval.save_results = True
    cfg.aux.logdir = logdir
    cfg.tpu.compute_dtype = dtype
    apply(cfg, paths, clip_size=5, clip_stride=5)
    for fn in derive:
        fn(cfg)
    return cfg


def jax_cfg(paths, logdir, dtype="float32"):
    return _mad(jax_defaults, jax_apply_synthetic_cfg,
                (jax_update_opt, jax_update_eval_data), paths, logdir, dtype)


def port_cfg(paths, logdir, dtype="float32"):
    return _mad(get_cfg_defaults, apply_synthetic_cfg,
                (update_opt, update_eval_data), paths, logdir, dtype)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Two movies (one in the 8x bucket with 36 queries, one in the base
    bucket with 4) and the flax weights."""
    root = tmp_path_factory.mktemp("mad_eval")
    paths = jax_make_synthetic(
        str(root / "data"), num_videos=2, num_queries=LONG_QUERIES,
        clip_range=LONG_CLIPS, vid_dim=CV, shallow_dim=CV, text_dim=CT,
        clip_size=5, clip_stride=5, splits=("val",), seed=5)
    # the second movie: cut to the base bucket and to 4 queries
    with open(paths["anno_file"]) as f:
        anno = json.load(f)
    info = anno["val"]["val_vid001"]
    n = BASE - 9
    for key in ("vid_feat_dir", "shallow_vid_feat_dir"):
        path = os.path.join(paths[key], "val_vid001.npy")
        np.save(path, np.load(path)[:n])
    info["num_clips"] = n
    info["num_frames"] = (n - 1) * 5 + 5
    info["duration"] = info["num_frames"] / info["fps"]
    info["annotations"] = [
        dict(a, segment=[min(a["segment"][0], info["duration"] * 0.5),
                         min(a["segment"][1], info["duration"])])
        for a in info["annotations"][:SHORT_QUERIES]]
    with open(paths["anno_file"], "w") as f:
        json.dump(anno, f)

    jcfg = jax_cfg(paths, str(root / "init"))
    rng = np.random.RandomState(2)
    T, L = BASE, 8
    init = jax.jit(functools.partial(jax_make_model(jcfg).init,
                                     deterministic=True))
    params = jax.tree.map(np.asarray, init(
        jax.random.PRNGKey(3), rng.randn(1, CV, T).astype(np.float32),
        rng.randn(1, CV, T).astype(np.float32), np.ones((1, T), bool),
        rng.randn(1, CT, L).astype(np.float32),
        rng.randn(1, CV).astype(np.float32), np.ones((1, L), bool))["params"])

    # the random annotations span seconds and the detections of random
    # weights a clip or two (1/6 s), so no query would hit: each query's
    # annotation becomes its top-1 detection of a first port run moved by
    # a fraction of its length, so that the top-1 IoU is 0.6, 0.2 or 0.03
    # in turns (both tables then have hits and misses at 0.1 and 0.3)
    probe = Evaluator(port_cfg(paths, str(root / "probe")), params=params,
                      device="cpu")
    probe.run()
    results = EvalResults.load(str(root / "probe" / "results_eval.pk"))
    i = 0
    for v in results.videos:
        for a, det in zip(anno["val"][v["vid_id"]]["annotations"],
                          v["detections"], strict=True):
            s, e = (float(x) for x in det["segments"][0])
            shift = (0.25, 2 / 3, 0.94)[i % 3] * (e - s)
            a["segment"] = [s + shift, e + shift]
            i += 1
    with open(paths["anno_file"], "w") as f:
        json.dump(anno, f)
    return root, paths, params


@pytest.fixture(scope="module")
def runs(setup):
    """Both Evaluators in f32 and in bf16: counts, query count, results."""
    root, paths, params = setup
    out = {}
    for dtype in ("float32", "bfloat16"):
        jdir, tdir = root / f"jax_{dtype}", root / f"port_{dtype}"
        jdir.mkdir()
        tdir.mkdir()
        jev = JaxEvaluator(jax_cfg(paths, str(jdir), dtype), train_time=True)
        jm = jev.run(ema_params=params)
        ev = Evaluator(port_cfg(paths, str(tdir), dtype), params=params,
                       device="cpu")
        tm = ev.run()
        out["jax", dtype] = (jm, jev.meter.counts.copy(), jev.meter.text_cnt,
                             JaxEvalResults.load(str(jdir / "results_eval.pk")))
        out["port", dtype] = (tm, ev.meter.counts.copy(), ev.meter.text_cnt,
                              EvalResults.load(str(tdir / "results_eval.pk")))
        out["calls", dtype] = ev.decoder.decode_calls
        out["loss_means", dtype] = dict(ev.loss_means)
    return out


def _queries(results):
    for v in results.videos:
        for det, loss in zip(v["detections"], v["losses"]):
            yield v["vid_id"], det, loss


def test_movies_reach_the_8x_bucket_in_query_chunks(setup, runs):
    _, paths, _ = setup
    cfg = port_cfg(paths, "unused")
    assert cfg.task == "mad" and cfg.data.max_vid_len == BASE
    assert cfg.data.clip_size == cfg.data.clip_stride == 5
    # the 8x movie decodes as a chunk of 32 queries and one of 4, the base
    # movie as one of 4: three decode calls in each dtype
    assert runs["calls", "float32"] == runs["calls", "bfloat16"] == 3
    assert runs["port", "float32"][2] == LONG_QUERIES + SHORT_QUERIES
    dec = Decoder(cfg, None, "cpu")
    assert dec.points(8 * BASE).shape == (4, sum(8 * BASE // 2 ** i
                                                 for i in range(4)))
    with pytest.raises(AssertionError, match="buffered"):
        dec.points(16 * BASE)


def test_no_top5_iou_near_a_threshold(runs):
    """An inequality of the tables means a real fault only if no top-5 IoU
    lies near a threshold, where the detections' 1e-3 s tolerance (a few
    hundredths of IoU on segments of a clip or two) could flip a count."""
    from decafnet_tpu_torch.eval import interval_iou
    for v in runs["port", "float32"][3].videos:
        for target, det in zip(v["targets"], v["detections"]):
            segs = det["segments"][:5].astype(np.float64)
            ious = interval_iou(segs, np.broadcast_to(target, segs.shape))
            for t in IOU_THRESHS:
                assert np.all(np.abs(ious - t) > 2e-2), (ious, t)


def test_recall_table_matches_jax(runs):
    jm, _, jn, _ = runs["jax", "float32"]
    tm, _, tn, _ = runs["port", "float32"]
    np.testing.assert_array_equal(tm, jm)
    assert tn == jn and tm.shape == (2, 2)
    assert 0 < tm.max() and tm.min() < 1     # hits and misses


def test_detections_and_losses_match_jax(runs):
    jr, tr = runs["jax", "float32"][3], runs["port", "float32"][3]
    assert [v["vid_id"] for v in tr.videos] == [v["vid_id"] for v in jr.videos]
    n = 0
    for (vid, got, gl), (_, want, wl) in zip(_queries(tr), _queries(jr),
                                             strict=True):
        assert len(got["scores"]) == len(want["scores"]) > 0, vid
        np.testing.assert_allclose(got["segments"], want["segments"],
                                   atol=SEG_TOL_S, rtol=0)
        np.testing.assert_allclose(got["scores"], want["scores"],
                                   atol=SCORE_TOL, rtol=0)
        for k in ("cls_loss", "reg_loss"):
            assert np.isfinite(gl[k])
            np.testing.assert_allclose(gl[k], wl[k], rtol=1e-4, atol=1e-5)
        n += 1
    assert n == LONG_QUERIES + SHORT_QUERIES


def _top1_hits(results):
    """Per query: whether its top score is tied (a second detection within
    one bf16 step of it, as ``_top1_agreement`` counts ties), and whether
    its top-1 segment reaches each IoU threshold."""
    from decafnet_tpu_torch.eval import interval_iou
    out = []
    for v in results.videos:
        for target, det in zip(v["targets"], v["detections"]):
            s = np.asarray(det["scores"], np.float64)
            step = 2.0 ** (np.floor(np.log2(s[0])) - 7)
            iou = interval_iou(det["segments"][:1].astype(np.float64),
                               np.asarray(target, np.float64)[None])[0]
            out.append((len(s) > 1 and s[1] >= s[0] - step,
                        tuple(iou >= t for t in IOU_THRESHS)))
    return out


def test_bf16_matches_jax_bf16_by_the_promotion_rule(runs):
    """The promotion rule of tests/test_torch_bf16.py, with R@1 held query
    by query where neither run's top score is tied: the annotations are
    each query's f32 top-1 moved by a fraction of its length, so where two
    detections tie in bf16 SoftNMS may put either first and the hit moves
    with it (tie-aware, as the top-1 agreement is)."""
    _, jc, n_q, jr = runs["jax", "bfloat16"]
    _, tc, tn, tr = runs["port", "bfloat16"]
    assert n_q == tn == LONG_QUERIES + SHORT_QUERIES
    untied = [(a[1], b[1]) for a, b in zip(_top1_hits(tr), _top1_hits(jr),
                                           strict=True)
              if not (a[0] or b[0])]
    assert len(untied) >= n_q // 2, len(untied)
    assert all(a == b for a, b in untied), untied               # R@1 hits
    assert 100.0 * np.abs(tc[1] - jc[1]).sum() / n_q <= 1.0     # R@5 flips
    agree = _top1_agreement(tr, jr).mean()
    floor = _top1_agreement(jr, runs["port", "float32"][3]).mean()
    assert agree >= min(0.99, floor - 0.01), (agree, floor)
    for v in tr.videos:
        for loss in v["losses"]:
            assert all(np.isfinite(x) for x in loss.values())


def test_time_sharded_eval_matches_one_process(setup, runs):
    root, paths, params = setup
    logdir = root / "exp"
    (logdir / "models").mkdir(parents=True)
    port_cfg(paths, str(logdir)).dump_to_file(str(logdir / "opt.yaml"))
    save_pth(str(logdir / "models" / "last.pth"), params)
    (root / "worker.py").write_text(WORKER)
    outs = finish(spawn([sys.executable, str(root / "worker.py"), str(logdir)]))
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    got = [json.loads(next(l for l in out.splitlines()
                           if l.startswith("EVAL::"))[6:]) for _, out in outs]
    assert [g["rank"] for g in got] == [0, 1]
    metrics, counts, n_q, _ = runs["port", "float32"]
    for g in got:
        # every rank decoded every movie, one time block of each
        assert g["videos"] == 2 and g["calls"] == runs["calls", "float32"]
        np.testing.assert_array_equal(g["counts"], counts)
        np.testing.assert_array_equal(g["metrics"], metrics)
        assert g["text_cnt"] == n_q
        for k, v in runs["loss_means", "float32"].items():
            np.testing.assert_allclose(g["loss_means"][k], v, rtol=1e-5)
