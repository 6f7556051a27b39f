"""Stacked-video evaluation of the port (``eval.shard_videos`` V): same-
bucket work items of V videos decoded in one call, the last partial groups
padded with inert copies, each video finished once all its query chunks
have returned. On the CPU, V = 2 and 4 against V = 1 of the port and
against the JAX Evaluator's ``shard_videos`` run on a one-device mesh
(what the port's V does in one process), over the split of
tests/test_sharded_eval.py: two videos in the base bucket and two longer
than max_seq_len (the 2x bucket, per-video PE interpolation plans), 3
queries each in chunks of 2 and 1. The count matrices must be equal, the
detections within 1e-3 s / 1e-4 and the losses within rtol 1e-5 of V = 1.
Also the combinations the Evaluator refuses. Helpers come from
tests/test_torch_eval.py."""

import functools

import numpy as np
import pytest
import torch

import jax

from decafnet_tpu.data import make_synthetic_dataset as jax_make_synthetic
from decafnet_tpu.eval import Evaluator as JaxEvaluator
from decafnet_tpu.models import make_model as jax_make_model
from decafnet_tpu.parallel import make_mesh
from decafnet_tpu_torch import parallel
from decafnet_tpu_torch.eval import Evaluator
from decafnet_tpu_torch.utils import EvalResults
from test_torch_eval import CS, CT, CV, SCORE_TOL, SEG_TOL_S, _configs

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

STACKS = (1, 2, 4)


def configs(paths, logdir, V):
    jcfg, tcfg = _configs(paths, logdir, "device")
    for cfg in (jcfg, tcfg):
        cfg.eval.max_num_queries = 2
        cfg.eval.shard_videos = V
    return jcfg, tcfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port at each V and the JAX Evaluator at V = 4, same weights."""
    root = tmp_path_factory.mktemp("torch_stacked_eval")
    # seed 6: val lengths 46, 112, 62, 99 clips against max_seq_len 64
    paths = jax_make_synthetic(str(root / "data"), num_videos=4, num_queries=3,
                               clip_range=(40, 130), vid_dim=CV, shallow_dim=CS,
                               text_dim=CT, seed=6)
    jcfg, _ = configs(paths, "", 1)
    rng = np.random.RandomState(2)
    V, T, L = 1, 64, 8
    init = jax.jit(functools.partial(jax_make_model(jcfg).init, deterministic=True))
    params = jax.tree.map(np.asarray, init(
        jax.random.PRNGKey(0), rng.randn(V, CV, T).astype(np.float32),
        rng.randn(V, CS, T).astype(np.float32), np.ones((V, T), bool),
        rng.randn(V, CT, L).astype(np.float32),
        rng.randn(V, CS).astype(np.float32), np.ones((V, L), bool))["params"])
    out = {}
    probe = Evaluator(configs(paths, "", 1)[1], params=params, device="cpu")
    keys = [probe.decoder.bucket_key(item) for sample in probe.dataset
            for item in probe.decoder.video_items(sample)[1]]
    out["per_bucket"] = [keys.count(k) for k in set(keys)]
    for V in STACKS:
        logdir = root / f"port_{V}"
        logdir.mkdir()
        _, tcfg = configs(paths, str(logdir), V)
        ev = Evaluator(tcfg, params=params, device="cpu")
        out[V] = {"metrics": ev.run(), "counts": ev.meter.counts.copy(),
                  "text_cnt": ev.meter.text_cnt, "calls": ev.decoder.decode_calls,
                  "video_ms": list(ev.video_ms),
                  "results": EvalResults.load(str(logdir / "results_eval.pk"))}
    jcfg, _ = configs(paths, "", 4)
    jcfg.eval.save_results = False
    jev = JaxEvaluator(jcfg, mesh=make_mesh(devices=jax.devices()[:1]),
                       train_time=True)
    out["jax"] = {"metrics": jev.run(ema_params=params),
                  "counts": jev.meter.counts, "text_cnt": jev.meter.text_cnt}
    return out


def by_query(results):
    return {(v["vid_id"], i): (det, loss) for v in results.videos
            for i, (det, loss) in enumerate(zip(v["detections"], v["losses"]))}


@pytest.mark.parametrize("V", [2, 4])
def test_stacked_table_matches_one_video_and_jax(runs, V):
    one, jax_run = runs[1], runs["jax"]
    assert one["text_cnt"] == jax_run["text_cnt"] == runs[V]["text_cnt"] == 12
    np.testing.assert_array_equal(one["counts"], jax_run["counts"])
    np.testing.assert_array_equal(runs[V]["counts"], one["counts"])
    np.testing.assert_array_equal(runs[V]["metrics"], jax_run["metrics"])
    assert 0 < one["counts"].sum()


@pytest.mark.parametrize("V", [2, 4])
def test_stacked_detections_and_losses_match_one_video(runs, V):
    want, got = by_query(runs[1]["results"]), by_query(runs[V]["results"])
    assert set(got) == set(want) and len(want) == 12
    for key, (det, loss) in got.items():
        wdet, wloss = want[key]
        assert len(det["scores"]) == len(wdet["scores"]) > 0, key
        np.testing.assert_allclose(det["segments"], wdet["segments"],
                                   atol=SEG_TOL_S, rtol=0)
        np.testing.assert_allclose(det["scores"], wdet["scores"],
                                   atol=SCORE_TOL, rtol=0)
        for k in ("cls_loss", "reg_loss"):
            np.testing.assert_allclose(loss[k], wloss[k], rtol=1e-5)


def test_groups_decode_in_fewer_calls(runs):
    """One call per work item at V = 1; one per group of up to V
    same-bucket items at V > 1 (a partial group padded with inert
    copies). Every video's wall time is recorded once it finishes."""
    per_bucket = runs["per_bucket"]
    assert sum(per_bucket) == runs[1]["calls"] == 8    # 4 videos x 2 chunks
    assert max(per_bucket) >= 2
    for V in (2, 4):
        assert runs[V]["calls"] == sum(-(-n // V) for n in per_bucket)
    for V in STACKS:
        assert len(runs[V]["video_ms"]) == 4 and min(runs[V]["video_ms"]) > 0


@pytest.mark.parametrize("sets,match", [
    ({"shard_videos": 4, "shard_time": 2}, "exclusive"),
    ({"shard_videos": 4, "_world": 2}, "eval.shard_processes"),
])
def test_refused_combinations(tmp_path, monkeypatch, sets, match):
    paths = jax_make_synthetic(str(tmp_path / "data"), num_videos=1,
                               num_queries=1, clip_range=(40, 60), vid_dim=CV,
                               shallow_dim=CS, text_dim=CT, seed=6)
    _, tcfg = configs(paths, str(tmp_path / "exp"), 1)
    for k, v in sets.items():
        if k == "_world":
            monkeypatch.setattr(parallel, "world_size", lambda: v)
        else:
            tcfg.eval[k] = v
    with pytest.raises(ValueError, match=match):
        Evaluator(tcfg, params={}, device="cpu")
