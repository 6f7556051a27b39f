"""Process-sharded evaluation of the port (``eval.shard_processes``): two
gloo ranks of the eval CLI's ``main`` on the CPU, each evaluating its
rank-strided share of an odd number of videos (3 and 2, one longer than
max_seq_len), against the one-process port and the JAX single-process
Evaluator on the same weights. Every rank must end with the count matrix,
query count and loss means of the one-process run (equal counts; losses
at rtol 1e-9 against the port, 1e-4 against JAX as tests/test_torch_eval.py
holds them); only the lead prints the table and writes the log, and each
rank dumps its own shard of the detections (``results_last.pk.r<rank>``).
Helpers come from tests/test_torch_eval.py and tests/test_torch_ddp.py."""

import functools
import json
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax

from decafnet_tpu.data import make_synthetic_dataset as jax_make_synthetic
from decafnet_tpu.eval import Evaluator as JaxEvaluator
from decafnet_tpu.models import make_model as jax_make_model
from decafnet_tpu.utils.analysis import EvalResults as JaxEvalResults
from decafnet_tpu_torch.eval import Evaluator, config_from_logdir
from decafnet_tpu_torch.models import save_pth
from decafnet_tpu_torch.utils import EvalResults
from test_torch_ddp import finish, spawn
from test_torch_eval import CS, CT, CV, _configs

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

WORKER = textwrap.dedent("""
    import json, sys

    import torch

    import decafnet_tpu_torch.eval.__main__ as cli

    torch.set_num_threads(1)
    built = []
    build = cli.build_evaluator
    cli.build_evaluator = lambda argv=None: built.append(build(argv)) or built[0]
    metrics = cli.main(sys.argv[1:])
    ev = built[0]
    print("EVAL::" + json.dumps({
        "rank": ev.proc_rank, "world": ev.proc_world,
        "counts": ev.meter.counts.tolist(), "text_cnt": ev.meter.text_cnt,
        "metrics": metrics.tolist(), "loss_means": ev.loss_means,
        "videos": len(ev.loader)}), flush=True)
""")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """An experiment directory over 5 synthetic videos x 3 queries and the
    JAX Evaluator's run on the same weights."""
    root = tmp_path_factory.mktemp("torch_mp_eval")
    paths = jax_make_synthetic(str(root / "data"), num_videos=5, num_queries=3,
                               clip_range=(40, 130), vid_dim=CV, shallow_dim=CS,
                               text_dim=CT, seed=6)
    jcfg, tcfg = _configs(paths, str(root / "exp"), "device")
    rng = np.random.RandomState(2)
    V, T, L = 1, 64, 8
    init = jax.jit(functools.partial(jax_make_model(jcfg).init, deterministic=True))
    params = jax.tree.map(np.asarray, init(
        jax.random.PRNGKey(1), rng.randn(V, CV, T).astype(np.float32),
        rng.randn(V, CS, T).astype(np.float32), np.ones((V, T), bool),
        rng.randn(V, CT, L).astype(np.float32),
        rng.randn(V, CS).astype(np.float32), np.ones((V, L), bool))["params"])
    logdir = root / "exp"
    (logdir / "models").mkdir(parents=True)
    tcfg.dump_to_file(str(logdir / "opt.yaml"))
    save_pth(str(logdir / "models" / "last.pth"), params)
    (root / "worker.py").write_text(WORKER)

    jdir = root / "jax"
    jdir.mkdir()
    jcfg.aux.logdir = str(jdir)
    jax_ev = JaxEvaluator(jcfg, train_time=True)
    jax_metrics = jax_ev.run(ema_params=params)
    jax_losses = [l for v in JaxEvalResults.load(str(jdir / "results_eval.pk")).videos
                  for l in v["losses"]]
    jax_run = {"counts": jax_ev.meter.counts, "text_cnt": jax_ev.meter.text_cnt,
               "metrics": jax_metrics,
               "loss_means": {k: float(np.mean([l[k] for l in jax_losses]))
                              for k in ("cls_loss", "reg_loss")}}
    return root, str(logdir), jax_run


def test_two_ranks_match_one_process_and_jax(setup):
    root, logdir, jax_run = setup
    outs = finish(spawn([sys.executable, str(root / "worker.py"), "--name",
                         logdir, "--device", "cpu"]))
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    ranks = [json.loads(next(l for l in out.splitlines()
                             if l.startswith("EVAL::"))[6:]) for _, out in outs]

    one = Evaluator(config_from_logdir(logdir), device="cpu")
    metrics = one.run()
    assert one.meter.text_cnt == jax_run["text_cnt"] == 15
    np.testing.assert_array_equal(one.meter.counts, jax_run["counts"])
    assert 0 < one.meter.counts.sum() < one.meter.counts.size * 15
    np.testing.assert_array_equal(metrics, jax_run["metrics"])

    # each rank loaded its own shard, and ends with the global table
    assert [(r["rank"], r["world"]) for r in ranks] == [(0, 2), (1, 2)]
    assert [r["videos"] for r in ranks] == [3, 2]
    for r in ranks:
        np.testing.assert_array_equal(r["counts"], one.meter.counts)
        assert r["text_cnt"] == 15
        np.testing.assert_array_equal(r["metrics"], metrics)
        for k, v in one.loss_means.items():
            np.testing.assert_allclose(r["loss_means"][k], v, rtol=1e-9)
            np.testing.assert_allclose(r["loss_means"][k],
                                       jax_run["loss_means"][k], rtol=1e-4)

    # the lead alone prints the table
    table = one.meter.table()[1]
    assert table in outs[0][1] and "Rank@" not in outs[1][1]


def test_each_rank_dumps_its_shard(setup):
    root, logdir, _ = setup
    one = Evaluator(config_from_logdir(logdir, set_cfgs=[
        "eval.save_results", "True"]), device="cpu")
    one.run()
    whole = EvalResults.load(os.path.join(logdir, "results_last.pk"))
    log = os.path.join(logdir, "eval_last.txt")

    def log_runs():
        with open(log) as f:
            return f.read().count("Evaluation started.")

    before = log_runs()
    outs = finish(spawn([sys.executable, str(root / "worker.py"),
                         "--name", logdir, "--device", "cpu", "--set",
                         "eval.save_results", "True"]))
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    assert log_runs() == before + 1                # the lead's log only
    assert "Evaluation started." not in outs[1][1]
    shards = [EvalResults.load(os.path.join(logdir, f"results_last.pk.r{r}"))
              for r in (0, 1)]
    ids = [v["vid_id"] for v in whole.videos]
    assert [[v["vid_id"] for v in s.videos] for s in shards] == [ids[0::2],
                                                                   ids[1::2]]
    by_id = {v["vid_id"]: v for v in whole.videos}
    for s in shards:
        for v in s.videos:
            for a, b in zip(v["detections"], by_id[v["vid_id"]]["detections"]):
                np.testing.assert_array_equal(a["segments"], b["segments"])
                np.testing.assert_array_equal(a["scores"], b["scores"])
