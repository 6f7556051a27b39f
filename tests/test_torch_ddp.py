"""Data-parallel training of the port (DDP over gloo) on the CPU, dropout
off, held against the single-process port and the JAX step:

* ``python -m decafnet_tpu_torch.train`` run as two ranks (the environment
  ``torchrun`` gives its workers), one or two microbatches, one epoch: the
  logged losses within 1e-6 and the weights and EMA within 1e-5 of the
  one-process Trainer; one ``opt.yaml``, log and metrics record per step,
  checkpoints without ``module.`` keys that load strictly;
* every parameter of ``iter``, ``iter2`` and a remat config gets a
  gradient (so DDP needs no unused-parameter search), and the batch
  splits the port refuses.

Ranks are spawned on a free local port with ``communicate(timeout=...)``
so a hung collective fails the test. tests/test_torch_ddp_step.py holds
the ranks' gradients, the JAX step, the lead's checkpoint and conv3's
operand cache; tests/test_torch_ddp_resume.py SIGTERM and resume; both
take their helpers from here."""

import datetime
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from decafnet_tpu_torch import parallel
from decafnet_tpu_torch.core import setup_cfg
from decafnet_tpu_torch.data import make_synthetic_dataset
from decafnet_tpu_torch.models import load_pth, make_model
from decafnet_tpu_torch.train import Trainer
from test_torch_train import CT, CV, MODEL, cfg_pair

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ddp_data")
    return make_synthetic_dataset(str(root), num_videos=8, num_queries=3,
                                  clip_range=(40, 90), vid_dim=CV,
                                  shallow_dim=CV, text_dim=CT, seed=11)


def write_cfg(path, synth, **train):
    """A small, dropout-free experiment config file for the train CLI:
    the model of tests/test_torch_train.py, global batch 4, one epoch, SGD
    with momentum. Under AdamW the attention key biases, whose exact
    gradient is 0 (softmax ignores a bias shared by every key), take
    lr-sized steps out of rounding noise, in one process as in two, so
    their weights cannot be held at 1e-5; under SGD every weight moves with
    its gradient. The JAX step test holds AdamW's moments."""
    _, tc = cfg_pair(synth)
    model = json.loads(json.dumps(MODEL))
    model["msf"] = True
    cfg = {"task": "grounder", "model": model,
           "train": {"version": 2, "batch_size": 4, "epochs": 1,
                     "warmup_epochs": 0, "num_workers": 0, **train},
           "optimizer": {"name": "sgd", "lr": 1e-2, "momentum": 0.9},
           "data": {k: tc.data[k] for k in (
               "name", "anno_file", "vid_feat_dir", "shallow_vid_feat_dir",
               "clip_token_fname", "text_cls_fname", "clip_size",
               "clip_stride", "shallow_ds")},
           "eval": {"max_num_queries": 4}}
    model["vid_net"]["arch"] = list(model["vid_net"]["arch"])
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_env(rank, world, port):
    """The environment ``torchrun`` gives rank ``rank`` of ``world``."""
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def spawn(cmd, world=2, **popen):
    """Start ``cmd`` (a list) as ranks 0..world-1 of one gloo group."""
    port = free_port()
    return [subprocess.Popen(cmd, env=rank_env(r, world, port), cwd=REPO,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, **popen) for r in range(world)]


def finish(procs, timeout=TIMEOUT):
    """Wait for every rank; returns their (returncode, output). A rank
    still running at the timeout is killed and fails the test."""
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out))
    return outs


def train_cli(argv):
    return [sys.executable, "-m", "decafnet_tpu_torch.train", *argv,
            "--device", "cpu"]


def logged(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def assert_close_states(got, want, rtol, atol, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {k}")


def one_process_run(cfg_file, sets):
    """The same CLI config trained by a one-process Trainer."""
    cfg = setup_cfg([cfg_file], sets)
    trainer = Trainer(cfg, device="cpu")
    trainer.run()
    return trainer


@pytest.mark.parametrize("micro", [4, 2])
def test_two_ranks_match_one_rank(synth, tmp_path, micro):
    """Two ranks of the train CLI against one process: ``micro`` 4 is one
    microbatch per step (2 rows per rank), 2 is two (1 row each)."""
    cfg_file = write_cfg(tmp_path / "small.yaml", synth, microbatch_size=micro)
    sets = ["aux.log_interval", "1", "seed", "5"]
    outs = finish(spawn(train_cli(
        ["--cfg", cfg_file, "--set", "log.root", str(tmp_path / "w2"), *sets])))
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    ref = one_process_run(cfg_file, ["log.root", str(tmp_path / "w1"), *sets])
    logdir = ref.cfg.aux.logdir.replace(str(tmp_path / "w1"), str(tmp_path / "w2"))

    got, want = logged(logdir), logged(ref.cfg.aux.logdir)
    assert len(got) == len(want) == ref.step >= 2
    for g, w in zip(got, want):
        assert g["itr"] == w["itr"]
        for k in ("train/cls", "train/reg", "train/total"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)

    ckpt = torch.load(os.path.join(logdir, "models", "last.pth"),
                      weights_only=True)
    assert not [k for k in ckpt["model"] if k.startswith("module.")]
    want_model = {k: v.detach() for k, v in ref.model.state_dict().items()}
    want_ema = {k: v.detach() for k, v in ref.ema.state_dict().items()}
    assert_close_states(ckpt["model"], want_model, 1e-5, 1e-7, "model")
    assert_close_states(ckpt["model_ema"], want_ema, 1e-5, 1e-7, "ema")
    model = make_model(ref.cfg)
    load_pth(model, os.path.join(logdir, "models", "last.pth"), "model")

    # the lead alone logs: one start line, one record per step; rank 1 runs
    # in the group as a rank that is not the lead
    with open(os.path.join(logdir, "log.txt")) as f:
        assert f.read().count("Training started.") == 1
    assert sorted(os.listdir(os.path.join(logdir, "models"))) == [
        f"1-{ref.step}.pth", "last.pth"]
    for _, out in outs:
        assert "device: cpu" in out
    assert "Training completed." in outs[0][1]
    assert "Training completed." not in outs[1][1]


# ------------------------------------------- one process: the DDP rules

@pytest.mark.parametrize("setting", ["iter", "iter2", "remat"])
def test_every_parameter_gets_a_gradient(synth, tmp_path, setting):
    _, tc = cfg_pair(synth, str(tmp_path / "exp"), msf=True)
    if setting == "iter2":
        tc.model.name = "iter2"
    if setting == "remat":
        tc.tpu.remat = True
    trainer = Trainer(tc, device="cpu")
    trainer.loader.set_epoch(0)
    batch = next(iter(trainer.loader))
    trainer.accumulate({k: torch.from_numpy(v) for k, v in batch.items()})
    missing = [n for n, p in trainer.model.named_parameters() if p.grad is None]
    assert not missing, missing


def test_refuses_a_batch_that_does_not_divide_over_the_ranks(synth, tmp_path,
                                                             monkeypatch):
    _, tc = cfg_pair(synth, str(tmp_path / "exp"), msf=True)
    tc.train.batch_size = 3
    monkeypatch.setattr(parallel, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="does not divide over 2 processes"):
        Trainer(tc, device="cpu")


def test_accumulate_refuses_an_uneven_rank_block(synth, tmp_path):
    _, tc = cfg_pair(synth, str(tmp_path / "exp"), msf=True)
    tc.train.microbatch_size = 1
    trainer = Trainer(tc, device="cpu")
    trainer.loader.set_epoch(0)
    batch = {k: torch.from_numpy(v) for k, v in next(iter(trainer.loader)).items()}
    # as a rank of 2: 2 rows in 4 global microbatches
    trainer.world = trainer.data_world = 2
    with pytest.raises(ValueError, match="do not split into 4 microbatches"):
        trainer.accumulate(batch)


# ------------------------------------------------ parallel/dist.py alone

def test_off_a_group_every_helper_is_the_identity(monkeypatch):
    for k in parallel.dist.ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert parallel.init_distributed() is False and not parallel.initialized()
    assert (parallel.rank(), parallel.world_size(), parallel.is_lead()) == (
        0, 1, True)
    t = torch.tensor(3.0)
    assert parallel.all_reduce_sum(t) is t and float(t) == 3.0
    v = torch.tensor([1.0, 2.5], dtype=torch.float64)
    assert parallel.all_reduce_sum(v) is v and v.tolist() == [1.0, 2.5]
    assert parallel.any_rank(True, "cpu") and not parallel.any_rank(False, "cpu")
    assert parallel.broadcast_object(7) == 7
    parallel.barrier()
    parallel.destroy()
    assert [parallel.host_batch_slice(8, r, 2) for r in (0, 1)] == [(0, 4), (4, 8)]


@pytest.mark.parametrize("asked,cuda,want", [
    (None, False, "gloo"), (None, True, "nccl"), ("gloo", True, "gloo"),
    ("nccl", False, "nccl")])
def test_backend_choice(monkeypatch, asked, cuda, want):
    """None picks NCCL with CUDA and gloo without; an explicit backend is
    used as given (the group itself is stubbed)."""
    for k, v in zip(parallel.dist.ENV_KEYS, ("0", "1", "0", "127.0.0.1", "1")):
        monkeypatch.setenv(k, v)
    got = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: got.setdefault("device", str(d)))
    monkeypatch.setattr(parallel.dist.dist, "init_process_group",
                        lambda backend, init_method, timeout: got.update(
                            backend=backend, timeout=timeout))
    assert parallel.init_distributed(asked)
    assert got["backend"] == want
    assert got.get("device") == ("cuda:0" if want == "nccl" else None)
    assert got["timeout"] == datetime.timedelta(minutes=parallel.TIMEOUT_MIN)

