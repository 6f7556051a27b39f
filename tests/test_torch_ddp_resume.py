"""Preemption and resume of the port's data-parallel training (two gloo
ranks of ``python -m decafnet_tpu_torch.train`` on the CPU):

* SIGTERM to rank 1 alone: the ranks agree on the flag at the next step
  boundary, the lead writes one checkpoint, and both ranks exit 143;
* a world-2 run that stops after one step (``aux.dryrun``, checkpointing at
  the epoch's end) and is run again resumes on every rank and logs the
  same losses, weights and EMA as the one-process run stopped and resumed
  the same way (1e-6 / 1e-5).

Helpers come from tests/test_torch_ddp.py."""

import os
import signal
import time

import numpy as np
import torch

from decafnet_tpu_torch.core import setup_cfg
from decafnet_tpu_torch.train import Trainer
from test_torch_ddp import (assert_close_states, finish, logged, spawn,
                            synth, train_cli, write_cfg)  # noqa: F401

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)


def test_sigterm_to_one_rank_stops_every_rank(synth, tmp_path):
    # many epochs, and no checkpoint but the preemption's (eval_by itr
    # with eval_run -1 never checkpoints)
    cfg_file = write_cfg(tmp_path / "small.yaml", synth, batch_size=2,
                         epochs=500)
    procs = spawn(train_cli(["--cfg", cfg_file, "--set", "log.root",
                             str(tmp_path / "log"), "aux.log_interval", "1",
                             "aux.eval_by", "itr", "seed", "5"]))
    lead = procs[0]
    steps, lines = 0, []
    deadline = time.time() + 240
    try:
        while steps < 3 and time.time() < deadline:
            line = lead.stdout.readline()
            if not line:
                break
            lines.append(line)
            steps += line.startswith("[") and "total" in line
        assert steps >= 3, "".join(lines)[-3000:]
        procs[1].send_signal(signal.SIGTERM)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    outs = finish(procs)
    assert [rc for rc, _ in outs] == [143, 143], [o[-3000:] for _, o in outs]
    out0 = "".join(lines) + outs[0][1]
    assert out0.count("Preemption checkpoint for resume.") == 1, out0[-3000:]
    assert "Training completed." not in out0
    logdir = setup_cfg([cfg_file], ["log.root", str(tmp_path / "log"),
                                    "aux.log_interval", "1", "aux.eval_by",
                                    "itr", "seed", "5"]).aux.logdir
    models = sorted(os.listdir(os.path.join(logdir, "models")))
    assert len(models) == 2 and models[1] == "last.pth", models
    epoch, itr = (int(x) for x in models[0][:-len(".pth")].split("-"))
    assert epoch == 0 and itr >= 3
    state = torch.load(os.path.join(logdir, "states", "last.pt"),
                       weights_only=True)
    assert (state["epoch"], state["itr"], state["step"]) == (0, itr, itr)
    # the step that saw the flag is checkpointed before it is logged
    assert [r["itr"] for r in logged(logdir)] == list(range(1, itr))


def test_resumed_two_rank_run_continues_the_same_losses(synth, tmp_path):
    cfg_file = write_cfg(tmp_path / "small.yaml", synth, epochs=2)
    sets = ["aux.log_interval", "1", "aux.dryrun", "True", "seed", "5"]
    argv = ["--cfg", cfg_file, "--set", "log.root", str(tmp_path / "w2"), *sets]
    for run in range(2):
        for rc, out in finish(spawn(train_cli(argv))):
            assert rc == 0, out[-4000:]
    cfg = setup_cfg([cfg_file], ["log.root", str(tmp_path / "w1"), *sets])
    for run in range(2):
        one = Trainer(cfg, device="cpu")
        assert (one.epoch, one.step) == (run, run)
        one.run()
    assert one.step == 2
    logdir = cfg.aux.logdir.replace(str(tmp_path / "w1"), str(tmp_path / "w2"))

    got, want = logged(logdir), logged(cfg.aux.logdir)
    assert [g["itr"] for g in got] == [w["itr"] for w in want] == [1, 2]
    for g, w in zip(got, want):
        for k in ("train/cls", "train/reg", "train/total"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
    ckpt = torch.load(os.path.join(logdir, "models", "last.pth"),
                      weights_only=True)
    assert_close_states(ckpt["model"], one.model.state_dict(), 1e-5, 1e-7,
                        "model")
    assert_close_states(ckpt["model_ema"], one.ema.state_dict(), 1e-5, 1e-7,
                        "ema")
    with open(os.path.join(logdir, "log.txt")) as f:
        assert f.read().count("Loaded checkpoint [epoch 1 / itr 1]") == 1


def test_a_sigterm_during_the_agreement_stops_at_the_next_step(
        synth, tmp_path, monkeypatch):
    """A SIGTERM whose handler runs while the ranks agree (after this
    rank's flag was read) must still stop the run at the next boundary,
    on every rank: the stand-in all-reduce sets the flag mid-call and
    answers with the value read before it."""
    from decafnet_tpu_torch import parallel
    from test_torch_train import cfg_pair

    _, tc = cfg_pair(synth, str(tmp_path / "exp"), msf=True)
    tc.train.epochs, tc.train.warmup_epochs = 5, 0   # ends if not stopped
    tc.aux.eval_by = "itr"
    trainer = Trainer(tc, device="cpu")
    calls = []

    def agree(flag, device):
        calls.append(flag)
        if len(calls) == 2:              # the signal lands mid-collective
            trainer._preempted = True
        return bool(flag)

    monkeypatch.setattr(parallel, "any_rank", agree)
    try:
        trainer.run()
    except SystemExit as e:
        assert e.code == 143
    else:
        raise AssertionError("the run did not stop")
    assert calls == [False, False, True] and trainer.itr == 3
    assert os.path.exists(os.path.join(tc.aux.logdir, "models", "0-3.pth"))
