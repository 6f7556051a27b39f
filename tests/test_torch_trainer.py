"""The port's Trainer and train CLI on the CPU, against the JAX Trainer
where they meet:

* warm-started from the JAX Trainer's ``last.pth`` (``aux.model_resume``)
  with dropout off, the first step's logged losses equal the JAX Trainer's
  (rtol 1e-4), and the JAX ``load_torch_checkpoint`` reads the port's
  checkpoint back;
* a dryrun writes ``models/last.pth`` and ``states/last.pt``; a fresh
  Trainer resumes epoch, itr, step, loss norm and optimizer state;
* checkpoint pruning (the cases of tests/test_checkpoint_prune.py);
* SIGTERM in a subprocess checkpoints at the next step and exits 143, and
  the run resumes;
* train-time eval of the EMA weights; the settings the port refuses;
* ``python -m decafnet_tpu_torch.train`` in process: ``opt.yaml``,
  ``finished``, the eval CLI on the experiment, bad ``--set`` lists, and
  the experiment name, log dir and seed of the JAX ``setup_cfg``."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
import yaml

import jax

from decafnet_tpu.core import setup_cfg as jax_setup_cfg
from decafnet_tpu.models.import_torch import load_torch_checkpoint
from decafnet_tpu.train import Trainer as JaxTrainer
from decafnet_tpu_torch.core import setup_cfg
from decafnet_tpu_torch.eval import Evaluator
from decafnet_tpu_torch.eval.__main__ import build_evaluator
from decafnet_tpu_torch.models import params_from_state_dict
from decafnet_tpu_torch.train import Trainer, prune_checkpoints
from decafnet_tpu_torch.train.__main__ import build_trainer
from decafnet_tpu_torch.train.__main__ import main as train_main
from decafnet_tpu_torch.utils import MetricsSink
from test_torch_train import CT, CV, cfg_pair, flat_jax

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from decafnet_tpu_torch.data import make_synthetic_dataset

    root = tmp_path_factory.mktemp("torch_trainer_data")
    return make_synthetic_dataset(str(root), num_videos=4, num_queries=3,
                                  clip_range=(40, 90), vid_dim=CV,
                                  shallow_dim=CV, text_dim=CT, seed=11)


def small_cfgs(synth, logdir, **train):
    jc, tc = cfg_pair(synth, logdir, msf=True)
    for c in (jc, tc):
        c.train.microbatch_size = 1
        c.train.epochs, c.train.warmup_epochs = 1, 0
        c.aux.dryrun = True
        c.eval.max_num_queries = 4
        for k, v in train.items():
            c.train[k] = v
    return jc, tc


def metrics_records(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def jax_and_port_runs(synth, tmp_path_factory):
    """One dryrun step of the JAX Trainer and of the port's Trainer, the
    port warm-started from the JAX Trainer's initial weights."""
    root = tmp_path_factory.mktemp("trainers")
    jc, _ = small_cfgs(synth, str(root / "jax"))
    jt = JaxTrainer(jc)
    jt.checkpoint()                       # models/last.pth: initial weights
    init_pth = str(root / "jax_init.pth")
    os.replace(os.path.join(jc.aux.logdir, "models", "last.pth"), init_pth)
    jt.run()

    _, tc = small_cfgs(synth, str(root / "port"))
    tc.aux.model_resume = init_pth
    trainer = Trainer(tc, device="cpu")
    trainer.run()
    return jt, trainer, init_pth


def test_first_step_losses_match_the_jax_trainer(jax_and_port_runs):
    jt, trainer, _ = jax_and_port_runs
    got = metrics_records(trainer.cfg.aux.logdir)
    want = metrics_records(jt.cfg.aux.logdir)
    assert len(got) == len(want) == 1 and got[0]["itr"] == want[0]["itr"] == 1
    for k in ("train/cls", "train/reg", "train/total"):
        assert np.isfinite(got[0][k])
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-4, err_msg=k)
    assert trainer.step == int(jt.state.step) == 1
    np.testing.assert_allclose(float(trainer.loss_norm),
                               float(jt.state.loss_norm), rtol=1e-6)


def test_warm_start_loads_model_and_ema(jax_and_port_runs):
    _, _, init_pth = jax_and_port_runs
    ckpt = torch.load(init_pth, weights_only=True)
    _, tc = small_cfgs(None, "")
    from decafnet_tpu_torch.models import make_model, load_pth
    for which in ("model", "model_ema"):
        model = load_pth(make_model(tc), init_pth, which)
        for k, v in model.state_dict().items():
            torch.testing.assert_close(v, ckpt[which][k], rtol=0, atol=0)


def test_dryrun_checkpoint_layout_and_jax_readback(jax_and_port_runs):
    _, trainer, _ = jax_and_port_runs
    root = trainer.cfg.aux.logdir
    for rel in ("models/last.pth", "states/last.pt", "models/1-1.pth",
                "metrics.jsonl", "log.txt"):
        assert os.path.exists(os.path.join(root, rel)), rel
    assert not [f for f in os.listdir(os.path.join(root, "models"))
                if f.endswith(".tmp")]
    ckpt = torch.load(os.path.join(root, "models", "last.pth"),
                      weights_only=True)
    assert set(ckpt) == {"model", "model_ema"}
    # the JAX package reads the port's checkpoint into its own params tree
    template = params_from_state_dict(trainer.ema.state_dict())
    for which, module in (("model", trainer.model), ("model_ema", trainer.ema)):
        params = load_torch_checkpoint(os.path.join(root, "models", "last.pth"),
                                       which, template=template)
        want = flat_jax(params_from_state_dict(module.state_dict()))
        for path, v in flat_jax(params).items():
            np.testing.assert_array_equal(v, want[path], err_msg=str(path))
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())


def test_fresh_trainer_resumes(jax_and_port_runs):
    _, trainer, _ = jax_and_port_runs
    again = Trainer(trainer.cfg, device="cpu")
    assert (again.epoch, again.itr, again.step) == (trainer.epoch, trainer.itr,
                                                    trainer.step) == (1, 1, 1)
    assert float(again.loss_norm) == float(trainer.loss_norm)
    for k, tensors in trainer.optimizer.state.items():
        for a, b in zip(again.optimizer.state[k], tensors, strict=True):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert any(float(t.abs().max()) > 0 for t in again.optimizer.state["nu"])
    for a, b in zip(again.model.parameters(), trainer.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(again.ema.parameters(), trainer.ema.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_time_eval_reads_the_ema(synth, tmp_path):
    _, tc = small_cfgs(synth, str(tmp_path / "exp"))
    tc.aux.eval_run = 1
    trainer = Trainer(tc, device="cpu")
    assert trainer.evaluator is not None
    trainer.run()
    assert os.path.exists(os.path.join(tc.aux.logdir, "eval_1_1.txt"))
    for a, b in zip(trainer.evaluator.model.parameters(),
                    trainer.ema.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the same numbers as an Evaluator that reads the checkpoint's EMA
    tc.aux.ckpt = "last"
    got = trainer.evaluator.run(ema=trainer.ema.state_dict())
    np.testing.assert_array_equal(got, Evaluator(tc, device="cpu").run())


@pytest.mark.parametrize("settings,world,match", [
    # tpu.shard_time trains (tests/test_torch_seq_train.py), on a 2-D
    # data+time mesh (tests/test_torch_seq_mesh.py) and with global video
    # self-attention (tests/test_torch_seq_global.py); what of it the port
    # refuses: a 2-D mesh whose ranks are not the group's, a 1-D mesh of
    # another size than the group, a global batch that does not split over
    # the mesh's data indices, a train length that does not split over the
    # ranks, and a halo longer than a block
    pytest.param({"tpu.shard_time": True, "tpu.mesh_shape": (2, 2)}, 2,
                 "names another count", id="tpu.shard_time-True-ROADMAP item 11"),
    pytest.param({"tpu.shard_time": True, "tpu.mesh_shape": (4,)}, 2,
                 "names another count", id="shard_time-mesh-not-the-group"),
    pytest.param({"tpu.shard_time": True}, 3, "must be a multiple of",
                 id="shard_time-length-does-not-split"),
    pytest.param({"tpu.shard_time": True}, 16, "longer than a rank's block",
                 id="shard_time-halo-past-the-block"),
    pytest.param({"tpu.shard_time": True, "model.vid_net.mha_win_size": -1,
                  "tpu.mesh_shape": (3, 2)}, 6,
                 "does not divide over the 3 data indices",
                 id="shard_time-global-attention"),
    pytest.param({"model.name": "default"}, 1, "forward-only",
                 id="model.name-default-forward-only"),
    pytest.param({"train.version": 1}, 1, "train.version=2",
                 id="train.version-1-train.version=2"),
    pytest.param({"task": "other"}, 1, "training knows",
                 id="task-other-training knows"),
])
def test_refused_settings(synth, tmp_path, monkeypatch, settings, world, match):
    """Each refused setting raises naming its rule; ``world`` is the size
    the process group reports (the rules of shard_time depend on it)."""
    from decafnet_tpu_torch import parallel

    _, tc = small_cfgs(synth, str(tmp_path / "exp"))
    for setting, value in settings.items():
        *path, key = setting.split(".")
        node = tc
        for p in path:
            node = node[p]
        node[key] = value
    monkeypatch.setattr(parallel, "world_size", lambda: world)
    with pytest.raises((NotImplementedError, ValueError), match=match):
        Trainer(tc, device="cpu")


# ------------------------------------------------------------- pruning

PRUNE_CASES = {
    "keeps most recent pairs": (
        2, (), ["1-100.msgpack", "1-100.pth", "2-200.msgpack", "2-200.pth",
                "3-300.msgpack", "3-300.pth", "4-400.msgpack", "4-400.pth",
                "last.msgpack", "last.pth"],
        ["3-300.msgpack", "3-300.pth", "4-400.msgpack", "4-400.pth",
         "last.msgpack", "last.pth"]),
    "exempts checkpoint epochs": (
        1, [2], ["1-100.msgpack", "2-200.msgpack", "2-200.pth",
                 "3-300.msgpack", "last.msgpack"],
        ["2-200.msgpack", "2-200.pth", "3-300.msgpack", "last.msgpack"]),
    "disabled keeps everything": (
        0, (), ["1-100.msgpack", "2-200.msgpack", "last.msgpack"],
        ["1-100.msgpack", "2-200.msgpack", "last.msgpack"]),
    "ignores non-checkpoint files": (
        1, (), ["1-100.msgpack", "2-200.msgpack", "notes-draft.txt",
                "opt.yaml", "last.pth"],
        ["2-200.msgpack", "last.pth", "notes-draft.txt", "opt.yaml"]),
    "orders by epoch then itr": (
        1, (), ["9-90000.pth", "10-5000.pth", "last.pth"],
        ["10-5000.pth", "last.pth"]),
}


@pytest.mark.parametrize("case", list(PRUNE_CASES))
def test_prune_checkpoints(tmp_path, case):
    keep, exempt, names, left = PRUNE_CASES[case]
    for n in names:
        (tmp_path / n).write_text("x")
    prune_checkpoints(str(tmp_path), keep, exempt)
    assert sorted(os.listdir(tmp_path)) == sorted(left)


# ------------------------------------------------------------- SIGTERM

WORKER = textwrap.dedent("""
    import json, sys

    def cfg_for(paths, logdir):
        from decafnet_tpu_torch.core import (get_cfg_defaults,
                                             update_eval_data, update_opt)
        from decafnet_tpu_torch.data import apply_synthetic_cfg

        cfg = get_cfg_defaults("grounder")
        m = cfg.model
        m.name, m.sratio, m.sn = "iter", 0.5, 8
        m.vid_net.in_dim, m.vid_net.embd_dim = 24, 16
        m.vid_net.max_seq_len, m.vid_net.arch = 64, (1, 0, 3)
        m.text_net.in_dim, m.text_net.embd_dim, m.text_net.n_layers = 20, 16, 1
        m.fusion.n_layers = 1
        cfg.train.batch_size, cfg.train.num_workers = 2, 0
        cfg.train.epochs, cfg.train.warmup_epochs = 500, 1
        cfg.train.version = 2
        cfg.aux.logdir, cfg.seed = logdir, 7
        apply_synthetic_cfg(cfg, paths)
        update_opt(cfg)
        return update_eval_data(cfg)

    if __name__ == "__main__":
        sys.path.insert(0, sys.argv[3])
        import torch
        from decafnet_tpu_torch.train import Trainer

        torch.set_num_threads(1)    # as the test modules: the suite shares the CPU

        paths, logdir = json.loads(sys.argv[1]), sys.argv[2]
        trainer = Trainer(cfg_for(paths, logdir), device="cpu")
        step = trainer.train_step

        def counted(batch):
            out = step(batch)
            print(f"STEP::{trainer.itr + 1}", flush=True)
            return out

        trainer.train_step = counted
        trainer.run()
""")


def test_sigterm_checkpoints_and_resumes(synth, tmp_path):
    script = tmp_path / "sigterm_worker.py"
    script.write_text(WORKER)
    logdir = str(tmp_path / "exp")
    proc = subprocess.Popen(
        [sys.executable, str(script), json.dumps(synth), logdir, REPO],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    steps, lines = 0, []
    deadline = time.time() + 300
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        steps += line.startswith("STEP::")
        if steps >= 3:
            break
    assert steps >= 3, "".join(lines)[-3000:]
    proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 143, (proc.returncode, out[-3000:])
    assert "SIGTERM received" in out and "Preemption checkpoint" in out
    for rel in ("models/last.pth", "states/last.pt"):
        assert os.path.exists(os.path.join(logdir, rel)), rel

    sys.path.insert(0, str(tmp_path))
    try:
        import sigterm_worker as worker
    finally:
        sys.path.remove(str(tmp_path))
    resumed = Trainer(worker.cfg_for(synth, logdir), device="cpu")
    assert resumed.itr >= 3 and resumed.step == resumed.itr


# ----------------------------------------------------------------- CLI

def write_cfg(path, synth):
    """A small experiment config file for the CLI."""
    _, tc = cfg_pair(synth)
    cfg = {"task": "grounder",
           "model": {k: tc.model[k] for k in ("name", "sratio", "sn", "msf")},
           "train": {"version": 2, "batch_size": 2, "epochs": 1,
                     "warmup_epochs": 0, "num_workers": 0},
           "data": {k: tc.data[k] for k in (
               "name", "anno_file", "vid_feat_dir", "shallow_vid_feat_dir",
               "clip_token_fname", "text_cls_fname", "clip_size",
               "clip_stride", "shallow_ds")},
           "eval": {"max_num_queries": 4}}
    for net, keys in (("vid_net", ("in_dim", "embd_dim", "max_seq_len", "arch")),
                      ("text_net", ("in_dim", "embd_dim", "n_layers")),
                      ("fusion", ("n_layers",))):
        cfg["model"][net] = {k: (list(tc.model[net][k])
                                 if isinstance(tc.model[net][k], tuple)
                                 else tc.model[net][k]) for k in keys}
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def test_train_cli_then_eval_cli(synth, tmp_path):
    cfg_file = write_cfg(tmp_path / "small.yaml", synth)
    trainer = train_main(["--cfg", cfg_file, "--set", "log.root",
                          str(tmp_path / "log"), "aux.dryrun", "True",
                          "seed", "5", "--device", "cpu"])
    logdir = trainer.cfg.aux.logdir
    assert logdir == os.path.join(str(tmp_path / "log"), "decaf",
                                  trainer.cfg.aux.exp, "0")
    for rel in ("opt.yaml", "finished", "models/last.pth", "states/last.pt"):
        assert os.path.exists(os.path.join(logdir, rel)), rel
    ev = build_evaluator(["--name", logdir, "--dryrun", "--device", "cpu"])
    metrics = ev.run()
    assert metrics.shape == (2, 2)
    for a, b in zip(ev.model.parameters(), trainer.ema.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_cli_argument_errors(synth, tmp_path):
    cfg_file = write_cfg(tmp_path / "small.yaml", synth)
    base = ["--cfg", cfg_file, "--device", "cpu", "--set", "log.root",
            str(tmp_path / "log")]
    with pytest.raises(KeyError):
        build_trainer(base + ["model.nonexistent", "5"])
    with pytest.raises(AssertionError):
        build_trainer(base + ["aux.dryrun"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device by default"):
            build_trainer(base[:2] + base[4:])


def test_setup_cfg_matches_jax(synth, tmp_path):
    cfg_file = write_cfg(tmp_path / "small.yaml", synth)
    sets = ["log.root", str(tmp_path / "log"), "model.sn", "6",
            "train.epochs", "3", "aux.mark", "try"]
    got, want = setup_cfg([cfg_file], sets), jax_setup_cfg([cfg_file], sets)
    assert got.aux.exp == want.aux.exp and "Model.Sn:6" in got.aux.exp
    assert got.aux.logdir == want.aux.logdir
    assert got.seed is not None
    # an existing run's seed comes back when none is set
    os.makedirs(got.aux.logdir)
    got.dump_to_file(os.path.join(got.aux.logdir, "opt.yaml"))
    assert setup_cfg([cfg_file], sets).seed == got.seed
    assert jax_setup_cfg([cfg_file], sets).seed == got.seed
    assert setup_cfg([cfg_file], sets + ["seed", "3"]).seed == 3


def test_metrics_sink_writes_jsonl(tmp_path, monkeypatch):
    monkeypatch.delenv("WANDB_API_KEY", raising=False)
    sink = MetricsSink(str(tmp_path))
    sink.log({"itr": 1, "train/total": 0.5}, step=1)
    sink.log({"itr": 2, "train/total": 0.25}, step=2)
    assert sink._wandb is None
    assert metrics_records(str(tmp_path)) == [
        {"itr": 1, "train/total": 0.5}, {"itr": 2, "train/total": 0.25}]
