"""The port's dataset-driven Evaluator (device='cpu') against
decafnet_tpu.eval.Evaluator on the same synthetic dataset and weights: device
NMS, reference_exact (host C++ SoftNMS) and device NMS with external scores.
Three videos, one longer than max_seq_len (the 2x bucket and the PE
interpolation plans). The R@k matrices must be equal, per-query detections
agree to 1e-3 s / 1e-4 score and the eval losses at rtol 1e-4 / atol 1e-5.
Also the eval CLI (in process and as ``python -m``) on an experiment
directory, the checkpoint errors, and the settings the port refuses."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

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
from decafnet_tpu_torch.eval import Evaluator, checkpoint_path
from decafnet_tpu_torch.eval.__main__ import build_evaluator
from decafnet_tpu_torch.eval.__main__ import main as eval_main
from decafnet_tpu_torch.models import save_pth
from decafnet_tpu_torch.utils import EvalResults

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CV, CS, CT = 32, 32, 24
MODES = ("device", "reference_exact", "ext_scores")
SEG_TOL_S, SCORE_TOL = 1e-3, 1e-4
# thresholds low enough that random weights put detections on both sides
IOU_THRESHS = (0.1, 0.3)


def _small(cfg, logdir):
    m = cfg.model
    m.name = "iter"
    m.vid_net.in_dim = CV
    m.vid_net.embd_dim = 16
    m.vid_net.max_seq_len = 64
    m.vid_net.arch = (1, 0, 3)
    m.text_net.in_dim = CT
    m.text_net.embd_dim = 16
    m.fusion.n_layers = 1
    m.sratio = 0.5
    m.sn = 8
    m.msf = True
    cfg.train.num_workers = 0
    cfg.eval.max_num_queries = 4
    cfg.eval.iou_threshs = IOU_THRESHS
    cfg.eval.save_results = True
    cfg.aux.logdir = logdir


def _configs(paths, logdir, mode):
    jcfg, tcfg = jax_defaults("grounder"), get_cfg_defaults("grounder")
    for cfg, apply, derive in ((jcfg, jax_apply_synthetic_cfg,
                                (jax_update_opt, jax_update_eval_data)),
                               (tcfg, apply_synthetic_cfg,
                                (update_opt, update_eval_data))):
        _small(cfg, logdir)
        cfg.model.text_net.n_layers = 1
        apply(cfg, paths)
        cfg.eval.reference_exact = mode == "reference_exact"
        if mode == "ext_scores":
            for tree in (cfg.data, cfg.eval.data):
                tree.ext_score_dir = paths["ext_score_dir"]
        for fn in derive:
            fn(cfg)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_eval")
    paths = jax_make_synthetic(str(root / "data"), num_videos=3, num_queries=3,
                               clip_range=(40, 90), vid_dim=CV, shallow_dim=CS,
                               text_dim=CT, seed=11)
    # one external score stream per query, on the clip grid
    import json
    with open(paths["anno_file"]) as f:
        anno = json.load(f)
    ext_dir = root / "data" / "ext_scores"
    ext_dir.mkdir()
    rng = np.random.RandomState(3)
    lens = []
    for split in anno.values():
        for info in split.values():
            lens.append(info["num_clips"])
            for a in info["annotations"]:
                np.save(ext_dir / f"{a['sentence_id']}.npy",
                        rng.randn(info["num_clips"]).astype(np.float32))
    paths["ext_score_dir"] = str(ext_dir)
    assert max(lens) > 64 >= min(lens), lens   # the 2x bucket is reached

    jcfg, _ = _configs(paths, str(root / "init"), "device")
    V, T, L = 1, 64, 8
    # one compiled init: eager init compiles every primitive on its own
    init = jax.jit(functools.partial(jax_make_model(jcfg).init, deterministic=True))
    params = init(
        jax.random.PRNGKey(1), rng.randn(V, CV, T).astype(np.float32),
        rng.randn(V, CS, T).astype(np.float32), np.ones((V, T), bool),
        rng.randn(V, CT, L).astype(np.float32),
        rng.randn(V, CS).astype(np.float32), np.ones((V, L), bool))["params"]
    return root, paths, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def runs(setup):
    """Each mode once through both Evaluators: metrics and result dumps."""
    root, paths, params = setup
    out = {}
    for mode in MODES:
        jdir, tdir = root / f"jax_{mode}", root / f"port_{mode}"
        jdir.mkdir()
        tdir.mkdir()
        jcfg, _ = _configs(paths, str(jdir), mode)
        _, tcfg = _configs(paths, str(tdir), mode)
        jm = JaxEvaluator(jcfg, train_time=True).run(ema_params=params)
        ev = Evaluator(tcfg, params=params, device="cpu")
        tm = ev.run()
        out[mode] = {
            "jax": (jm, JaxEvalResults.load(str(jdir / "results_eval.pk"))),
            "port": (tm, EvalResults.load(str(tdir / "results_eval.pk"))),
            "calls": ev.decoder.decode_calls, "video_ms": ev.video_ms,
            "time": dict(ev.decoder.time_dict)}
    return out


def _queries(results):
    for v in results.videos:
        for det, loss in zip(v["detections"], v["losses"]):
            yield v["vid_id"], det, loss


@pytest.mark.parametrize("mode", MODES)
def test_recall_table_matches_jax(runs, mode):
    (jm, _), (tm, _) = runs[mode]["jax"], runs[mode]["port"]
    np.testing.assert_array_equal(tm, jm)
    assert tm.shape == (2, 2)
    # the table is not degenerate: some queries hit, some miss
    assert 0 < tm.max() and tm.min() < 1


@pytest.mark.parametrize("mode", MODES)
def test_detections_match_jax(runs, mode):
    jr, tr = runs[mode]["jax"][1], runs[mode]["port"][1]
    assert [v["vid_id"] for v in tr.videos] == [v["vid_id"] for v in jr.videos]
    n = 0
    for (vid, got, _), (_, want, _) in zip(_queries(tr), _queries(jr),
                                           strict=True):
        assert len(got["scores"]) == len(want["scores"]) > 0, vid
        np.testing.assert_allclose(got["segments"], want["segments"],
                                   atol=SEG_TOL_S, rtol=0)
        np.testing.assert_allclose(got["scores"], want["scores"],
                                   atol=SCORE_TOL, rtol=0)
        n += 1
    assert n == 9


@pytest.mark.parametrize("mode", MODES)
def test_losses_match_jax(runs, mode):
    jr, tr = runs[mode]["jax"][1], runs[mode]["port"][1]
    for (_, _, got), (_, _, want) in zip(_queries(tr), _queries(jr),
                                         strict=True):
        for k in ("cls_loss", "reg_loss"):
            assert np.isfinite(got[k])
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5)


def test_no_top5_iou_near_a_threshold(runs):
    """An inequality of the tables means a real fault only if no top-5 IoU
    lies within 1e-4 of a threshold, where a last-digit difference could
    flip a count."""
    from decafnet_tpu_torch.eval import interval_iou
    for mode in MODES:
        for v in runs[mode]["port"][1].videos:
            for target, det in zip(v["targets"], v["detections"]):
                ious = interval_iou(det["segments"][:5].astype(np.float64),
                                    np.broadcast_to(target, (len(det["segments"][:5]), 2)))
                for t in IOU_THRESHS:
                    assert np.all(np.abs(ious - t) > 1e-4), (mode, ious, t)


def test_device_and_reference_exact_agree(runs):
    np.testing.assert_array_equal(runs["device"]["port"][0],
                                  runs["reference_exact"]["port"][0])
    dev, ref = runs["device"]["port"][1], runs["reference_exact"]["port"][1]
    for (_, a, la), (_, b, lb) in zip(_queries(dev), _queries(ref), strict=True):
        np.testing.assert_allclose(a["segments"], b["segments"], atol=SEG_TOL_S)
        np.testing.assert_allclose(a["scores"], b["scores"], atol=SCORE_TOL)
        assert la == lb


@pytest.mark.parametrize("mode", MODES)
def test_phase_buckets_and_decode_calls(runs, mode):
    r = runs[mode]
    # one decode call per video (3 queries fit one 4-row chunk)
    assert r["calls"] == 3 and len(r["video_ms"]) == 3
    spans = {"prepare", "forward", "post_process", "decode.stage",
             "decode.h2d", "decode.dispatch", "decode.d2h",
             "decode.h2d_bytes", "decode.rows", "decode.real_rows",
             "model.delegation", "model.text", "model.fusion", "model.fpn",
             "model.heads", "decode.select_nms"}
    # the host SoftNMS's bucket only where it runs
    assert set(r["time"]) == spans | (
        {"nms"} if mode == "reference_exact" else set())
    nms_s = sum(r["time"].get("nms", ()))
    assert (nms_s > 0) == (mode == "reference_exact")


@pytest.fixture(scope="module")
def experiment(setup):
    """An experiment directory as the JAX trainer lays it out: opt.yaml and
    models/last.pth (reference layout)."""
    root, paths, params = setup
    logdir = root / "exp"
    (logdir / "models").mkdir(parents=True)
    jcfg, _ = _configs(paths, str(logdir), "device")
    jcfg.eval.save_results = False
    jcfg.dump_to_file(str(logdir / "opt.yaml"))
    save_pth(str(logdir / "models" / "last.pth"), params)
    return str(logdir)


def test_eval_cli_matches_jax(experiment, runs, capsys):
    metrics = eval_main(["--name", experiment, "--device", "cpu"])
    np.testing.assert_array_equal(metrics, runs["device"]["jax"][0])
    out = capsys.readouterr().out
    assert "Rank@1, IoU@0.1:" in out and "cls_loss:" in out
    with open(os.path.join(experiment, "eval_last.txt")) as f:
        assert "phase wall-times" in f.read()
    ref = eval_main(["--name", experiment, "--device", "cpu", "--dryrun",
                     "--set", "eval.reference_exact", "True"])
    assert ref.shape == (2, 2)


def test_eval_cli_as_module(experiment):
    out = subprocess.run(
        [sys.executable, "-m", "decafnet_tpu_torch.eval", "--name", experiment,
         "--device", "cpu", "--dryrun"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "Rank@5, IoU@0.3:" in out.stdout and "reg_loss:" in out.stdout


def test_eval_cli_needs_cuda_by_default(experiment, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_main(["--name", experiment, "--dryrun"])


def test_missing_checkpoint_names_both_paths(experiment, tmp_path):
    with pytest.raises(FileNotFoundError) as e:
        eval_main(["--name", experiment, "--ckpt", "9-99", "--device", "cpu"])
    assert "9-99.pth" in str(e.value) and "9-99.msgpack" in str(e.value)
    # a JAX-only checkpoint: the .msgpack exists, the .pth does not
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "last.msgpack").write_bytes(b"")
    with pytest.raises(FileNotFoundError) as e:
        checkpoint_path(str(tmp_path), "last")
    assert "last.pth" in str(e.value) and "last.msgpack" in str(e.value)


@pytest.mark.parametrize("override,error,match", [
    # eval.shard_time runs under torchrun (tests/test_torch_seq_eval.py),
    # global video self-attention too; what of it the port refuses: S other
    # than the group's size (banded or global), a length that does not
    # split, and stacked videos with it
    pytest.param(("eval.shard_time", "2", "model.vid_net.mha_win_size", "-1"),
                 ValueError, "ranks of the process group",
                 id="override0-NotImplementedError"),
    pytest.param(("eval.shard_time", "4"), ValueError,
                 "ranks of the process group", id="shard_time-not-the-group"),
    pytest.param(("eval.shard_time", "3"), ValueError, "must be a multiple of",
                 id="shard_time-length-does-not-split"),
    pytest.param(("eval.shard_time", "2", "eval.shard_videos", "2"),
                 ValueError, "exclusive", id="shard_time-with-shard_videos"),
])
def test_unported_settings_raise(experiment, override, error, match):
    with pytest.raises(error, match=match):
        eval_main(["--name", experiment, "--device", "cpu", "--set", *override])


def test_bf16_compute_dtype_runs(experiment):
    # the bf16 serve/eval mode (tests/test_torch_bf16.py holds it against
    # the JAX Evaluator in bf16); here through the CLI
    ev = build_evaluator(["--name", experiment, "--device", "cpu", "--dryrun",
                          "--set", "tpu.compute_dtype", "bfloat16"])
    assert ev.model.compute_dtype == torch.bfloat16
    assert ev.run().shape == (2, 2)


def test_shard_videos_runs(experiment, runs):
    # stacked decode groups (tests/test_torch_sharded_eval.py holds them
    # against V = 1 and the JAX run); here through the CLI
    metrics = eval_main(["--name", experiment, "--device", "cpu", "--set",
                         "eval.shard_videos", "8"])
    np.testing.assert_array_equal(metrics, runs["device"]["jax"][0])


def test_float32_compute_dtype_runs(experiment):
    for dtype in ("auto", "float32"):
        m = eval_main(["--name", experiment, "--device", "cpu", "--dryrun",
                       "--set", "tpu.compute_dtype", dtype])
        assert m.shape == (2, 2)


def test_set_rejects_unknown_keys(experiment):
    with pytest.raises(KeyError):
        eval_main(["--name", experiment, "--device", "cpu",
                   "--set", "eval.no_such_key", "1"])
    with pytest.raises(AssertionError):
        eval_main(["--name", experiment, "--device", "cpu",
                   "--set", "eval.reference_exact"])


def test_opt_yaml_is_jax_snapshot(experiment):
    with open(os.path.join(experiment, "opt.yaml")) as f:
        snap = yaml.safe_load(f)
    assert "tpu" in snap and snap["model"]["name"] == "iter"
