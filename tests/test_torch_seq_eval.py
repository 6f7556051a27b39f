"""Sequence-parallel eval of the port (``eval.shard_time`` 2): the eval
CLI's ``build_evaluator`` + ``run`` as two gloo ranks on the CPU, each
video's time axis split over the ranks, in the three cases of
tests/test_time_sharded_eval.py: plain, per-query external scores and
``eval.reference_exact``; and with global video self-attention
(``model.vid_net.mha_win_size -1``: the ranks gather each attention's
keys). Four synthetic videos, shorter and longer than
``max_seq_len`` (so the PE interpolation plans run sharded too). On every
rank the R@k counts and the query count must equal both the JAX
Evaluator's ``eval.shard_time`` run on a 2-device CPU mesh and the port's
one-process run, and the loss means the one-process run's (rtol 1e-5).
Only the lead prints the table. Helpers come from tests/test_torch_ddp.py."""

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
from decafnet_tpu.data import make_synthetic_dataset
from decafnet_tpu.eval import Evaluator as JaxEvaluator
from decafnet_tpu.models import make_model as jax_make_model
from decafnet_tpu.parallel import make_mesh
from decafnet_tpu_torch.core import get_cfg_defaults, update_eval_data, update_opt
from decafnet_tpu_torch.data import apply_synthetic_cfg
from decafnet_tpu_torch.eval import Evaluator, config_from_logdir
from decafnet_tpu_torch.models import save_pth
from test_torch_ddp import finish, spawn

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

MODES = ("plain", "ext_scores", "reference_exact", "global")
GLOBAL = ["model.vid_net.mha_win_size", "-1"]

WORKER = textwrap.dedent("""
    import json, sys

    import torch

    from decafnet_tpu_torch import parallel
    from decafnet_tpu_torch.eval.__main__ import build_evaluator

    torch.set_num_threads(1)
    logdir, ext_dir = sys.argv[1:3]
    sets = {"plain": [], "ext_scores": ["eval.data.ext_score_dir", ext_dir],
            "reference_exact": ["eval.reference_exact", "True"],
            "global": ["model.vid_net.mha_win_size", "-1"]}
    out = {}
    for mode, extra in sets.items():
        ev = build_evaluator(["--name", logdir, "--device", "cpu", "--set",
                              "eval.shard_time", "2", *extra])
        assert ev.shard is not None and not ev.shard_proc
        metrics = ev.run()
        out[mode] = {"counts": ev.meter.counts.tolist(),
                     "text_cnt": ev.meter.text_cnt,
                     "metrics": metrics.tolist(),
                     "loss_means": ev.loss_means, "videos": len(ev.loader),
                     "calls": ev.decoder.decode_calls}
    print("EVAL::" + json.dumps({"rank": parallel.rank(), "runs": out}),
          flush=True)
    parallel.destroy()
""")


def _small(cfg, synth, seed=3):
    """tests/test_time_sharded_eval.py's ``_cfg`` in either package."""
    cfg.model.name = "iter"
    cfg.model.vid_net.in_dim = 32
    cfg.model.vid_net.embd_dim = 16
    cfg.model.vid_net.max_seq_len = 64
    cfg.model.vid_net.arch = (1, 0, 3)
    cfg.model.text_net.in_dim = 24
    cfg.model.text_net.embd_dim = 16
    cfg.model.text_net.n_layers = 1
    cfg.model.fusion.n_layers = 1
    cfg.model.sratio = 0.5
    cfg.model.sn = 8
    cfg.train.num_workers = 0
    cfg.seed = seed
    # thresholds low enough that random weights put detections on both sides
    cfg.eval.iou_threshs = (0.1, 0.3)
    return cfg


def jax_cfg(synth, shard_time=0, win=5, **ev):
    cfg = _small(jax_defaults("grounder"), synth)
    cfg.eval.shard_time = shard_time
    cfg.model.vid_net.mha_win_size = win
    jax_apply_synthetic_cfg(cfg, synth)
    for k, v in ev.items():
        cfg.eval[k] = v
    jax_update_opt(cfg)
    jax_update_eval_data(cfg)
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The synthetic split, per-query external scores, the weights, an
    experiment directory of the port, and the JAX runs of each mode."""
    root = tmp_path_factory.mktemp("seq_eval")
    synth = make_synthetic_dataset(str(root / "data"), num_videos=4,
                                   num_queries=3, clip_range=(40, 130), seed=6)
    with open(synth["anno_file"]) as f:
        anno = json.load(f)
    ext_dir = root / "ext"
    ext_dir.mkdir()
    rng = np.random.RandomState(1)
    lens = []
    for split in anno.values():
        for info in split.values():
            lens.append(info["num_clips"])
            for a in info["annotations"]:
                np.save(ext_dir / f"{a['sentence_id']}.npy",
                        rng.randn(info["num_clips"]).astype(np.float32))
    assert max(lens) > 64 >= min(lens), lens

    cfg0 = jax_cfg(synth)
    T, L = 64, 8
    init = jax.jit(functools.partial(jax_make_model(cfg0).init,
                                     deterministic=True))
    params = jax.tree.map(np.asarray, init(
        jax.random.PRNGKey(0), rng.randn(1, 32, T).astype(np.float32),
        rng.randn(1, 32, T).astype(np.float32), np.ones((1, T), bool),
        rng.randn(1, 24, L).astype(np.float32),
        rng.randn(1, 32).astype(np.float32), np.ones((1, L), bool))["params"])

    logdir = root / "exp"
    (logdir / "models").mkdir(parents=True)
    tcfg = _small(get_cfg_defaults("grounder"), synth)
    apply_synthetic_cfg(tcfg, synth)
    update_eval_data(update_opt(tcfg))
    tcfg.dump_to_file(str(logdir / "opt.yaml"))
    save_pth(str(logdir / "models" / "last.pth"), params)

    mesh = make_mesh(devices=jax.devices()[:2])
    jax_runs = {}
    for mode in MODES:
        ev = ({"reference_exact": True} if mode == "reference_exact" else {})
        cfg = jax_cfg(synth, shard_time=2, win=-1 if mode == "global" else 5,
                      **ev)
        if mode == "ext_scores":
            cfg.eval.data.ext_score_dir = str(ext_dir)
        jev = JaxEvaluator(cfg, mesh=mesh, train_time=True)
        jev.run(ema_params=params)
        jax_runs[mode] = (jev.meter.counts.copy(), jev.meter.text_cnt)
    return root, str(logdir), str(ext_dir), jax_runs


@pytest.fixture(scope="module")
def ranks(setup):
    root, logdir, ext_dir, _ = setup
    (root / "worker.py").write_text(WORKER)
    outs = finish(spawn([sys.executable, str(root / "worker.py"), logdir,
                         ext_dir]))
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    got = [json.loads(next(l for l in out.splitlines()
                           if l.startswith("EVAL::"))[6:]) for _, out in outs]
    assert [g["rank"] for g in got] == [0, 1]
    # the lead alone prints the tables
    assert outs[0][1].count("Final:") == len(MODES)
    assert "Final:" not in outs[1][1]
    return got


@pytest.mark.parametrize("mode", MODES)
def test_sharded_counts_match_jax_and_one_process(setup, ranks, mode):
    _, logdir, ext_dir, jax_runs = setup
    extra = {"plain": [], "ext_scores": ["eval.data.ext_score_dir", ext_dir],
             "reference_exact": ["eval.reference_exact", "True"],
             "global": GLOBAL}[mode]
    one = Evaluator(config_from_logdir(logdir, set_cfgs=extra or None),
                    device="cpu")
    metrics = one.run()
    jax_counts, jax_cnt = jax_runs[mode]
    np.testing.assert_array_equal(one.meter.counts, jax_counts)
    assert one.meter.text_cnt == jax_cnt == 12
    assert 0 < one.meter.counts.sum()
    for r in ranks:
        got = r["runs"][mode]
        # every rank decoded every video, one time block of each
        assert got["videos"] == 4 and got["calls"] == one.decoder.decode_calls
        np.testing.assert_array_equal(got["counts"], jax_counts)
        assert got["text_cnt"] == jax_cnt
        np.testing.assert_array_equal(got["metrics"], metrics)
        for k, v in one.loss_means.items():
            np.testing.assert_allclose(got["loss_means"][k], v, rtol=1e-5)
